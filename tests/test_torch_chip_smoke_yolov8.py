"""Rehearsal of ``chip_smoke.py``'s phases 43-46 (the RotatedYOLOv8 models
and live BatchNorm) on the CPU at a tiny size: the published configs with
the backbone and neck at deepen 0.33 / widen 0.125 at 128 px, where every
wrapper takes its plain version (so no launch is counted)."""

import pytest
import torch

import chip_smoke
from test_torch_chip_smoke import NO_LAUNCHES, TINY_FAMILY, derived_config

torch.set_num_threads(1)

TINY_YOLO = '''
model = dict(
    backbone=dict(deepen_factor=0.33, widen_factor=0.125),
    neck=dict(deepen_factor=0.33, widen_factor=0.125),
    bbox_head=dict(widen_factor=0.125),
    test_cfg=dict(nms_pre=300, max_candidates=300, max_per_img=100))
'''


@pytest.fixture
def tiny_yolo(tmp_path, monkeypatch):
    """The phases' configs replaced by narrow copies."""
    configs = {k: derived_config(tmp_path, v, TINY_YOLO)
               for k, v in chip_smoke.YOLO_CONFIGS.items()}
    monkeypatch.setattr(chip_smoke, 'YOLO_CONFIGS', configs)
    return configs


def test_phase_yolo_slice_rehearsal(tiny_yolo):
    captured = chip_smoke.phase_yolo_slice('cpu', bsz=1, size=128, g=8,
                                           valid=3, max_candidates=300)
    assert sorted(captured) == sorted(
        f'{k}_{kind}' for k in chip_smoke.YOLO_SLICE
        for kind in ('slice_nms', 'slice_assign'))
    for label in chip_smoke.YOLO_SLICE:
        (boxes, cls), = captured[f'{label}_slice_nms']
        assert boxes.shape == (1, 300, 5) and cls.shape == (1, 300)
        (preds, gts, mode), = captured[f'{label}_slice_assign']
        assert preds.shape == (1, 336, 5) and gts.shape == (1, 8, 5)
        assert mode == 'iou'


def test_phase_yolo_serving_rehearsal(tiny_yolo):
    runs, captured = chip_smoke.phase_yolo_serving(
        'cpu', bsz=1, size=128, warm=1, timed={k: 1 for k in
                                               chip_smoke.YOLO_SERVED},
        dtype=torch.float32, max_candidates=300)
    assert runs == [NO_LAUNCHES] * len(chip_smoke.YOLO_SERVED)
    for label in chip_smoke.YOLO_SERVED:
        boxes, cls = captured[label]
        assert boxes.shape == (1, 300, 5) and cls.shape == (1, 300)


def test_phase_yolo_training_rehearsal(tiny_yolo):
    runs, captured = chip_smoke.phase_yolo_training(
        'cpu', bsz=1, size=128, g=8, valid=3, warm=2, timed=4,
        dtype=torch.float32, padded_g=16, padded_valid=5)
    assert runs == [NO_LAUNCHES] * 2
    (preds, gts, _), = captured['yolov8_train']
    assert preds.shape == (1, 336, 5) and gts.shape == (1, 8, 5)
    (_, padded, _), = captured['yolov8_train_padded']
    assert padded.shape == (1, 16, 5)


def test_yolo_ranges_are_the_modules(tiny_yolo):
    """The ``yolov8.*`` ranges phases 44-45 split by are the ones the
    modules open, in a profiled CPU loss and request of prototype3 (MSARC)
    and of the MSDCN model."""
    from torch.profiler import profile
    from orientedobjectdetection_torch.models import build_detector
    from orientedobjectdetection_torch.utils import Config
    seen = set()
    for label in ('prototype3', 'msdcn'):
        detector = build_detector(dict(Config.fromfile(
            tiny_yolo[label]).model))
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
                 if e.key.startswith('yolov8.')}
    assert seen == {k for k in chip_smoke.YOLO_RANGES +
                    chip_smoke.YOLO_TRAIN_RANGES if k.startswith('yolov8.')}


def test_phase_yolo_loop_rehearsal(tmp_path):
    from orientedobjectdetection_torch.tools.generate_synth import \
        generate_synth
    root = str(tmp_path / 'tiny')
    generate_synth(root, 4, 128, seed=0)
    configs = {k: derived_config(tmp_path, v, TINY_FAMILY)
               for k, v in chip_smoke.YOLO_TINY_CONFIGS.items()}
    runs, inputs = chip_smoke.phase_yolo_loop(
        root, str(tmp_path / 'work'), configs=configs, steps=2,
        dtype=torch.float32, device='cpu', log_interval=1)
    assert runs == [NO_LAUNCHES]
    for label in chip_smoke.YOLO_TINY_CONFIGS:
        assert len(inputs[f'{label}_loop_assign']) == 2
        assert inputs[f'{label}_loop_eval_iou'] and \
            inputs[f'{label}_loop_nms']
