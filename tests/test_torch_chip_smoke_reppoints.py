"""Rehearsal of ``chip_smoke.py``'s phases 39-42 (the point-set families)
on the CPU at a tiny size: the published configs with a ResNet-18 backbone
and 64-wide heads at 128 px, where every wrapper takes its plain version
(so no launch is counted)."""

import torch
import pytest

import chip_smoke
from test_torch_chip_smoke import NO_LAUNCHES, TINY_FAMILY, derived_config

torch.set_num_threads(1)

TINY_REPPOINTS = '''
model = dict(
    backbone=dict(depth=18),
    neck=dict(in_channels=[64, 128, 256, 512], out_channels=64),
    bbox_head=dict(in_channels=64, feat_channels=64, point_feat_channels=64,
                   stacked_convs=1),
    test_cfg=dict(nms_pre=300, max_candidates=300, max_per_img=100))
'''


@pytest.fixture
def tiny_reppoints(tmp_path, monkeypatch):
    """The phases' configs replaced by ResNet-18 copies."""
    configs = {k: derived_config(tmp_path, v, TINY_REPPOINTS)
               for k, v in chip_smoke.REPPOINTS_CONFIGS.items()}
    monkeypatch.setattr(chip_smoke, 'REPPOINTS_CONFIGS', configs)
    return configs


def test_phase_reppoints_slice_rehearsal(tiny_reppoints):
    captured = chip_smoke.phase_reppoints_slice('cpu', bsz=1, size=128, g=8,
                                                valid=3, max_candidates=300)
    assert sorted(captured) == sorted(f'{k}_slice_nms'
                                      for k in chip_smoke.REPPOINTS_SERVED)
    for calls in captured.values():
        (boxes, cls), = calls
        assert boxes.shape == (1, 300, 5) and cls.shape == (1, 300)


def test_phase_reppoints_serving_rehearsal(tiny_reppoints):
    runs, captured = chip_smoke.phase_reppoints_serving(
        'cpu', bsz=1, size=128, warm=1, timed=1, dtype=torch.float32,
        max_candidates=300)
    assert runs == [NO_LAUNCHES] * 3
    for label in chip_smoke.REPPOINTS_SERVED:
        boxes, cls = captured[label]
        assert boxes.shape == (1, 300, 5) and cls.shape == (1, 300)


def test_phase_reppoints_training_rehearsal(tiny_reppoints):
    runs, captured = chip_smoke.phase_reppoints_training(
        'cpu', bsz=1, size=128, g=8, valid=3, warm=1, timed=3,
        dtype=torch.float32, padded_g=16, padded_valid=5, reps=1)
    assert runs == [NO_LAUNCHES] * 5
    for label in chip_smoke.REPPOINTS_CONFIGS:
        sampling = captured[f'{label}_sampling']
        assert sampling['forward_ms'] > 0 and sampling['backward_ms'] > 0
    assert captured['convex_iou_g32']['pairs'] == 341 * 8
    assert captured['convex_iou_g512']['pairs'] == 341 * 16


def test_reppoints_spread_gives_real_boxes(tiny_reppoints):
    """Seeded weights with the spread points decode to boxes of a few
    strides, where the raw seeded points give zero boxes."""
    bundle = chip_smoke.build_reppoints_bundle(
        tiny_reppoints['rotated'], 'cpu', torch.float32, 300)
    dets, _, valid = bundle(chip_smoke.raw_images(1, 128, 3))
    sides = dets[valid][:, 2:4]
    assert valid.sum() > 20 and float(sides.amin()) > 4.0


def test_reppoints_ranges_are_the_heads():
    """The ranges phases 40-41 split by are the ones the heads open, in a
    profiled CPU loss and request of each tiny-synth family."""
    from torch.profiler import profile
    from orientedobjectdetection_torch.models import build_detector
    from orientedobjectdetection_torch.utils import Config
    seen = set()
    for config in chip_smoke.REPPOINTS_TINY_CONFIGS.values():
        detector = build_detector(dict(Config.fromfile(config).model))
        detector.init_weights(0)
        images = torch.randn(1, 3, 64, 64)
        batch = dict(gt_bboxes=torch.tensor([[[30.0, 30, 20, 10, 0.3]]]),
                     gt_labels=torch.zeros(1, 1, dtype=torch.long),
                     gt_mask=torch.ones(1, 1, dtype=torch.bool))
        with profile() as prof:
            detector.loss_from_outputs(detector(images), batch)
            with torch.no_grad():
                detector.bboxes_from_outputs(detector(images))
        seen |= {e.key for e in prof.key_averages()
                 if e.key.startswith('reppoints.')}
    assert seen == set(chip_smoke.REPPOINTS_RANGES +
                       chip_smoke.REPPOINTS_TRAIN_RANGES)


def test_phase_reppoints_loops_rehearsal(tmp_path):
    from orientedobjectdetection_torch.tools.generate_synth import \
        generate_synth
    root = str(tmp_path / 'tiny')
    generate_synth(root, 4, 128, seed=0)
    configs = {k: derived_config(tmp_path, v, TINY_FAMILY)
               for k, v in chip_smoke.REPPOINTS_TINY_CONFIGS.items()}
    runs, inputs = chip_smoke.phase_reppoints_loops(
        root, str(tmp_path / 'work'), configs=configs, steps=2,
        dtype=torch.float32, device='cpu', log_interval=1)
    assert runs == [NO_LAUNCHES] * 4
    for label in chip_smoke.REPPOINTS_TINY_CONFIGS:
        assert inputs[f'{label}_loop_assign'] == []   # the convex IoU
        assert inputs[f'{label}_loop_eval_iou'] and \
            inputs[f'{label}_loop_nms']
