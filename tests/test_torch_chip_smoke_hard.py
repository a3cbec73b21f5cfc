"""Rehearsal of ``chip_smoke.py``'s phase 56 (the synth-hard protocol
through the port's runner) on the CPU at a small size: the four hard
configs cut to 128^2 scenes, batches of 2, ``max_gt`` 32 (the crowded
scenes overflow it), 4 trainval and 2 val scenes, one epoch; every wrapper
takes its plain version here, so no launch is counted, while the recorded
inputs are the ones phase 12 holds on the card."""

import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_chip_smoke import NO_LAUNCHES, derived_config

torch.set_num_threads(2)

# the hard configs at 128 px: the loader's canvas, the pipelines' scale,
# the proposals and candidates cut to the size
SMALL = '''
angle_version = {version!r}
img_norm_cfg = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12,
                    57.375], to_rgb=True)
train_pipeline = [
    dict(type='LoadImageFromFile', cache='ram'),
    dict(type='LoadAnnotations', with_bbox=True),
    dict(type='RResize', img_scale=(128, 128)),
    dict(type='RRandomFlip', flip_ratio=0.5, version=angle_version),
    dict(type='Normalize', **img_norm_cfg),
    dict(type='Pad', size_divisor=32),
    dict(type='Collect', keys=['img', 'gt_bboxes', 'gt_labels'])]
test_pipeline = [
    dict(type='LoadImageFromFile', cache='ram'),
    dict(type='RResize', img_scale=(128, 128)),
    dict(type='Normalize', **img_norm_cfg),
    dict(type='Pad', size_divisor=32),
    dict(type='Collect', keys=['img'])]
data = dict(samples_per_gpu=2, workers_per_gpu=1, max_gt=32,
            pad_size=(128, 128), train=dict(pipeline=train_pipeline),
            val=dict(pipeline=test_pipeline),
            test=dict(pipeline=test_pipeline))
pad_size = (128, 128)
'''
CUTS = {
    'retinanet': 'model = dict(test_cfg=dict(nms_pre=64, max_candidates=128))',
    'orcnn': '''model = dict(
    train_cfg=dict(rpn_proposal=dict(nms_pre=256, max_per_img=128),
                   rcnn=dict(sampler=dict(num=64))),
    test_cfg=dict(rpn=dict(nms_pre=256, max_per_img=128),
                  rcnn=dict(nms_pre=128, max_candidates=128)))''',
    'reppoints': 'model = dict(test_cfg=dict(nms_pre=64, max_candidates=128))',
    'yolov8': '''model = dict(bbox_head=dict(test_cfg=dict(nms_pre=64,
                                               max_candidates=128)))''',
}


def small_configs(tmp_path):
    return {label: derived_config(
        tmp_path, path,
        SMALL.format(version='oc' if label == 'reppoints' else 'le90') +
        CUTS[label] + '\n')
        for label, path in chip_smoke.HARD_CONFIGS.items()}


def test_phase_hard_rehearsal(tmp_path):
    configs = small_configs(tmp_path)
    work = str(tmp_path / 'work')
    runs, inputs = chip_smoke.phase_hard(
        str(tmp_path / 'data'), work, configs=configs, n_train=4, n_val=2,
        size=128, dtype=torch.float32, device='cpu', log_interval=1)
    assert runs == [NO_LAUNCHES]
    with open(os.path.join(work, 'summary.json')) as f:
        summary = json.load(f)
    assert [r['status'] for r in summary['families']] == ['done'] * 4
    for label, per_step in chip_smoke.HARD_ASSIGNS.items():
        # 2 steps of 2 images; the assigner's gts at the config's max_gt
        assign = inputs[f'hard_{label}_assign']
        assert len(assign) == 2 * per_step
        for boxes1, boxes2, mode in assign:
            assert 32 in (boxes1.shape[-2], boxes2.shape[-2])
        assert inputs[f'hard_{label}_nms']
        for boxes, cls, thr in inputs[f'hard_{label}_nms']:
            # the evaluation pads its batches to 8 images
            assert boxes.shape[:2] == cls.shape and boxes.shape[0] == 8
            assert thr == (0.4 if label == 'reppoints' else 0.1)
        for _, boxes2, mode in inputs[f'hard_{label}_eval_iou']:
            assert mode == 'iou' and boxes2.shape[0] == 2
    levels, rois, ratio = inputs['hard_orcnn_roi_align'][0]
    assert levels[0].shape[-1] == 64 and rois.shape == (8, 128, 5)
    assert len(inputs['hard_orcnn_roi_align']) == 1
    # the two-stage profiles on the phase's scenes (no device time here)
    profiles = chip_smoke.profile_hard_two_stage(
        str(tmp_path / 'data'), configs=(configs['orcnn'],),
        dtype=torch.float32, device='cpu', warm=1, eval_images=2)
    assert list(profiles) == ['tiny_oriented_rcnn_hard_synth']
    rec = profiles['tiny_oriented_rcnn_hard_synth']
    assert rec['step_wall_ms'] > 0 and rec['request_wall_ms'] > 0
    assert rec['step_busy_ms'] == rec['request_b3_ms'] == 0


def test_held_hard_holds_each_family(monkeypatch):
    """Phase 12's part for phase 56 holds every recorded kind and times the
    largest of each (one seeded input a kind here)."""
    rng = np.random.default_rng(0)
    boxes, cls = chip_smoke.dota_candidates(2, 40, 1)
    boxes, cls = torch.from_numpy(boxes), torch.from_numpy(cls)
    gts = torch.from_numpy(np.concatenate(
        [rng.uniform(0, 128, (2, 6, 2)), rng.uniform(4, 30, (2, 6, 2)),
         rng.uniform(-1, 1, (2, 6, 1))], -1).astype(np.float32))
    captured = {}
    for label in chip_smoke.HARD_CONFIGS:
        captured[f'hard_{label}_nms'] = [(boxes, cls, 0.4)]
        captured[f'hard_{label}_assign'] = [] if label == 'reppoints' else \
            [(boxes, gts, 'iou')]
        captured[f'hard_{label}_eval_iou'] = [(boxes, gts, 'iou')]
    feats = chip_smoke.seeded_pyramid(1, 128, 8, torch.float32, 'cpu', 6)
    rois = torch.from_numpy(chip_smoke.seeded_rois(1, 24, 128, 7))
    captured['hard_orcnn_roi_align'] = [(feats, rois, 2)]
    by_name = {name: dict(name=name, max_abs_err=0, main_path_inputs={})
               for name in chip_smoke.KERNELS}
    chip_smoke.HELD_MATRICES.clear()
    chip_smoke.held_hard('cpu', captured, by_name, '', 1, 1, 1)
    pair = by_name['nms_pair_mask']['main_path_inputs']
    iou = by_name['box_iou_rotated']['main_path_inputs']
    assert sorted(pair) == sorted(f'hard_{k}_eval'
                                  for k in chip_smoke.HARD_CONFIGS)
    assert 'hard_reppoints_assign' not in iou and len(iou) == 7
    assert by_name['roi_align_rotated']['main_path_inputs'][
        'hard_orcnn_eval']['inputs_held'] == 1


def needle_case():
    """Three gts and four needle proposals (1e-3 wide, the width
    ``rbbox_overlaps`` clamps to) across them, batched as the RoI
    assigner's inputs."""
    gts = torch.tensor([[[270., 226., 20., 6.5, 0.9], [390., 250., 16., 9.,
                                                        0.8],
                         [226., 352., 14.5, 13.6, 1.5]]])
    needles = torch.tensor([[[268., 228., 380., 1e-3, -0.44],
                             [392., 249., 555., 1e-3, -0.31],
                             [227., 351., 362., 1e-3, -0.47],
                             [100., 100., 30., 1e-3, 0.2]]])
    return gts, needles


@pytest.mark.parametrize('kernel_off,fails', [(0.0, False), (3e-5, True)])
def test_check_iou_matrix_holds_disputed_pairs_in_float64(monkeypatch,
                                                          kernel_off, fails):
    """Where kernel and float32 plain version differ by more than
    ``IOU_ATOL``, the kernel is held to the plain formulation in float64
    within the same tolerance: a float32 reference 3e-5 off does not fail
    an exact kernel, and a kernel 3e-5 off fails."""
    from orientedobjectdetection_torch.ops import iou_kernels
    from orientedobjectdetection_torch.ops.iou import box_iou_rotated
    gts, needles = needle_case()
    exact = box_iou_rotated(gts.double(), needles.double()).float()
    live = iou_kernels.pairs_in_reach(gts, needles)
    assert (exact[live] > 0).sum() >= 3           # the needles cross gts
    plain_off = 0.0 if fails else 3e-5
    monkeypatch.setattr(iou_kernels, 'box_iou_rotated_matrix',
                        lambda b1, b2, mode: exact + kernel_off * live)
    monkeypatch.setattr(iou_kernels, 'box_iou_rotated_matrix_plain',
                        lambda b1, b2, mode: exact + plain_off * live)
    if fails:
        with pytest.raises(AssertionError, match='float64'):
            chip_smoke.check_iou_matrix(gts, needles, 'iou')
    else:
        err, in_reach = chip_smoke.check_iou_matrix(gts, needles, 'iou')
        assert err <= chip_smoke.IOU_ATOL and in_reach == int(live.sum())
