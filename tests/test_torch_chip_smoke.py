"""Rehearsal of ``chip_smoke.py`` on the CPU: its phases at a tiny size,
where every wrapper takes its plain version (so the launch count must stay
0). ``main()`` is not called: it requires a CUDA device."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke

torch.set_num_threads(1)

NO_LAUNCHES = {'nms_pair_mask': 0, 'box_iou_rotated': 0,
               'roi_align_rotated': 0}


def test_phase_kernel_rehearsal():
    rec = chip_smoke.phase_kernel('cpu', bsz=2, n=130, small_n=70, reps=1,
                                  plain_reps=1)
    assert rec['max_abs_err'] == 0
    assert rec['bound_by'] in ('bytes', 'operations')
    assert rec['bound_ms'] > 0 and rec['ms'] > 0 and rec['plain_ms'] > 0
    assert rec['library_ms'] is None and rec['route'] == 'cuda'


def test_phase_slice_rehearsal():
    chip_smoke.phase_slice('cpu', bsz=1, size=128, max_candidates=300)


def test_phase_serving_rehearsal():
    launches, captured = chip_smoke.phase_serving(
        'cpu', bsz=2, size=128, warm=1, timed=1, dtype=torch.float32,
        max_candidates=300)
    assert launches == NO_LAUNCHES
    # the recorded request's NMS inputs, as ops/nms.py passes them
    boxes, cls = captured['retinanet']
    assert boxes.shape == (2, 300, 5) and boxes.dtype == torch.float32
    assert cls.shape == (2, 300) and cls.dtype == torch.int32
    assert boxes.is_contiguous() and cls.is_contiguous()
    # the recording wrapper is gone again
    from orientedobjectdetection_torch.ops import iou_kernels, nms
    assert nms.nms_pair_mask is iou_kernels.nms_pair_mask


def test_phase_iou_kernel_rehearsal():
    rec = chip_smoke.phase_iou_kernel('cpu', bsz=2, g=8, valid=3, size=128,
                                      dense_g=16, big_g=40, big_valid=6,
                                      reps=1, big_reps=1, plain_reps=1)
    assert rec['name'] == 'box_iou_rotated' and rec['route'] == 'cuda'
    assert rec['max_abs_err'] == 0          # the wrapper took the plain one
    assert rec['bound_by'] in ('bytes', 'operations')
    assert rec['bound_ms'] > 0 and rec['ms'] > 0 and rec['plain_ms'] > 0
    assert rec['library_ms'] is None
    assert rec['replaces'].endswith('iou_pallas.py:347')
    big = rec['padded_gts']                 # timed without the plain one
    assert big['ms'] > 0 and big['bound_ms'] > rec['bound_ms']
    assert big['pairs_in_reach'] > rec['pairs_in_reach'] > 0


def test_iou_matrix_cases_loader_padding():
    """Phase 6's G = 512 case: 64 valid gts per image, then 448 zero rows
    that reach nothing."""
    from orientedobjectdetection_torch.ops.iou_kernels import pairs_in_reach
    anchors = chip_smoke.config_anchors(128, 'cpu')
    cases = chip_smoke.iou_matrix_cases(anchors, 'cpu', bsz=2)
    big, cols, mode = cases['padded-512']
    assert big.shape == (2, 512, 5) and cols is anchors and mode == 'iou'
    assert (big[:, 64:] == 0).all()
    assert (big[:, :64, 2:4] > 0).all()
    live = pairs_in_reach(big, anchors)
    assert not live[:, 64:].any() and live[:, :64].any(-1).all()
    assert sorted(cases) == sorted(['assignment', 'ignore-iof', 'dense',
                                    'duplicates', 'one-image', 'padded-512'])


def test_iou_matrix_bound_at_the_loader_padding():
    """B=8, G=512, N=196,416 in float32: 3.22 GB, 0.962 ms at 3.35 TB/s
    (bytes bound it below 107 M pairs in reach)."""
    gts, anchors = torch.zeros((8, 512, 5)), torch.zeros((196416, 5))
    bound, by = chip_smoke.iou_matrix_bound_ms(gts, anchors, 10 ** 7)
    nbytes = 8 * 512 * 5 * 4 + 196416 * 5 * 4 + 8 * 512 * 196416 * 4
    assert nbytes == 3222089984 and by == 'bytes'
    assert bound == nbytes / chip_smoke.PEAK_BYTES * 1e3
    assert round(bound, 3) == 0.962
    assert chip_smoke.iou_matrix_bound_ms(gts, anchors, 2 * 10 ** 8)[1] == \
        'operations'


def test_phase_train_slice_rehearsal():
    chip_smoke.phase_train_slice('cpu', bsz=1, size=128, g=8, valid=3)


def test_phase_training_rehearsal():
    launches, captured = chip_smoke.phase_training(
        'cpu', bsz=1, size=128, g=8, valid=3, warm=1, timed=2,
        dtype=torch.float32)
    assert launches == NO_LAUNCHES
    # the recorded step's assigner inputs: gts clamped by rbbox_overlaps
    boxes1, boxes2, mode = captured['train_step']
    assert boxes1.shape == (1, 8, 5) and mode == 'iou'
    assert boxes2.shape == chip_smoke.config_anchors(128, 'cpu').shape
    assert (boxes1[0, 3:, 2:4] == 1e-3).all()
    from orientedobjectdetection_torch.ops import iou_kernels
    assert iou_kernels.box_iou_rotated_matrix.__name__ == \
        'box_iou_rotated_matrix'


def test_phase_roi_kernel_rehearsal():
    rec = chip_smoke.phase_roi_kernel('cpu', bsz=2, r=40, size=256,
                                      channels=16, odd=(1, 13, 72, 8),
                                      reps=1, plain_reps=1)
    assert rec['name'] == 'roi_align_rotated' and rec['route'] == 'cuda'
    assert rec['max_abs_err'] == 0          # the wrapper took the plain one
    assert rec['bound_by'] in ('bytes', 'operations')
    assert rec['bound_ms'] > 0 and rec['ms'] > 0 and rec['plain_ms'] > 0
    assert rec['bound_ms_float32'] > rec['bound_ms']    # twice the bytes
    assert rec['library_ms'] is None
    assert rec['replaces'].endswith('roi_align_pallas.py:226')


def test_roi_align_work_counts_cells_once():
    """Two identical RoIs touch the cells of one; a padding RoI none."""
    feats = chip_smoke.seeded_pyramid(1, 256, 4, torch.float32, 'cpu', 0)
    one = torch.tensor([[[100.0, 90.0, 28.0, 14.0, 0.0]]])
    cells, live, per_level = chip_smoke.roi_align_work(feats, one)
    # 14 x 14 samples half a cell apart on the stride-4 level: 8 x 5 cells
    assert (cells, live, per_level) == (40, 1, [1, 0, 0, 0])
    twice = torch.cat([one, one, torch.zeros(1, 1, 5)], 1)
    assert chip_smoke.roi_align_work(feats, twice) == (40, 2, [2, 0, 0, 0])
    bound, by = chip_smoke.roi_align_bound_ms(feats, twice, 40, 2)
    nbytes = 3 * 5 * 4 + (40 * 4 + 3 * 49 * 4) * 4
    assert by == 'bytes' and bound == nbytes / chip_smoke.PEAK_BYTES * 1e3


def test_phase_orcnn_slice_rehearsal():
    chip_smoke.phase_orcnn_slice('cpu', bsz=1, size=128, max_num=200,
                                 max_candidates=300)


def test_phase_orcnn_serving_rehearsal():
    launches, captured = chip_smoke.phase_orcnn_serving(
        'cpu', bsz=1, size=128, warm=1, timed=1, split=1,
        dtype=torch.float32, max_num=200, max_candidates=300)
    assert launches == NO_LAUNCHES
    boxes, cls = captured['orcnn']
    assert boxes.shape == (1, 300, 5) and cls.shape == (1, 300)
    levels, rois = captured['orcnn_roi']
    assert rois.shape == (1, 200, 5) and len(levels) == 4
    assert [f.shape[1] for f in levels] == [32, 16, 8, 4]
    assert all(f.shape[-1] == 256 for f in levels)
    from orientedobjectdetection_torch.models.roi_heads import (
        oriented_roi_head)
    from orientedobjectdetection_torch.ops import roi_align_kernels
    assert oriented_roi_head.roi_align_rotated_pyramid is \
        roi_align_kernels.roi_align_rotated_pyramid


def test_phase_orcnn_train_slice_rehearsal():
    chip_smoke.phase_orcnn_train_slice('cpu', bsz=1, size=128, g=8, valid=3)


def test_phase_orcnn_training_rehearsal():
    """Phase 14 at a tiny size: no kernel launches on the CPU, the two
    assigners' recorded inputs (the RPN's gts against the shared anchors,
    the RoI head's against each image's gts and proposals), the gather
    pooling timed alone and the profiled step's sync check."""
    launches, captured = chip_smoke.phase_orcnn_training(
        'cpu', bsz=1, size=128, g=8, valid=3, warm=1, timed=1,
        dtype=torch.float32, reps=1)
    assert launches == NO_LAUNCHES
    rpn_gts, anchors, mode = captured['orcnn_train_rpn']
    assert rpn_gts.shape == (1, 8, 5) and mode == 'iou'
    assert anchors.shape == ((32 * 32 + 16 * 16 + 8 * 8 + 4 * 4 + 2 * 2) * 3,
                             5)
    assert (rpn_gts[0, 3:, 2:4] == 1e-3).all()     # clamped padding
    gts, props, mode = captured['orcnn_train_roi']
    assert gts.shape == (1, 8, 5) and props.shape[0] == 1
    assert props.shape[1] == 8 + 2000 and mode == 'iou'
    assert torch.equal(props[:, :8], gts)           # gts added first


def test_syncs_inside_finds_host_reads_in_a_range():
    from torch.profiler import ProfilerActivity, profile, record_function
    x = torch.arange(10.0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function('two_stage.sample_rois'):
            x.sum().item()
        with record_function('two_stage.rpn_targets'):
            x.sum()
        x.max().item()
    found = chip_smoke.syncs_inside(prof, ('two_stage.sample_rois',
                                           'two_stage.rpn_targets'))
    assert found['two_stage.rpn_targets'] == []
    assert found['two_stage.sample_rois'] == [
        'aten::item in two_stage.sample_rois',
        'aten::_local_scalar_dense in aten::item']
    x = torch.arange(6.0).reshape(2, 3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function('two_stage.rpn_targets'):
            x.sum(1).max().item()
    found = chip_smoke.syncs_inside(prof, ('two_stage.rpn_targets',),
                                    ('aten::_local_scalar_dense',))
    assert found == {'two_stage.rpn_targets': [
        'aten::_local_scalar_dense in aten::item']}


def test_phase_main_path_kernels_rehearsal():
    """Phase 12 on small recorded-like inputs: the records gain the
    main-path numbers, and the error stays 0 (plain against plain)."""
    boxes, cls = chip_smoke.dota_candidates(2, 90, 5, num_classes=3)
    feats = chip_smoke.seeded_pyramid(1, 128, 8, torch.float32, 'cpu', 6)
    rois = torch.from_numpy(chip_smoke.seeded_rois(1, 24, 128, 7))
    live = rois[..., 2] > 1e-3
    captured = {'retinanet': (torch.from_numpy(boxes), torch.from_numpy(cls)),
                'orcnn': (torch.from_numpy(boxes[:1]).contiguous(),
                          torch.from_numpy(cls[:1]).contiguous()),
                'orcnn_roi': (feats, rois[:, :int(live.sum())].contiguous())}
    anchors = chip_smoke.config_anchors(128, 'cpu')
    gts = chip_smoke.seeded_gts(anchors, 2, 8, 3, 8)[0]
    captured['train_step'] = (gts.clamp(min=1e-3), anchors, 'iou')
    props = torch.cat([gts, chip_smoke.seeded_gts(anchors, 2, 40, 40, 9)[0]],
                      1)
    captured['orcnn_train_rpn'] = (gts.clamp(min=1e-3), anchors, 'iou')
    captured['orcnn_train_roi'] = (gts.clamp(min=1e-3),
                                   props.clamp(min=1e-3), 'iou')
    # phases 17 and 18: lists of every input a run gave the kernel
    captured['eval_iou'] = [captured['orcnn_train_roi'],
                            (gts[:1].clamp(min=1e-3),
                             props[:1].clamp(min=1e-3), 'iou')]
    captured['orcnn_loop_rpn'] = [captured['orcnn_train_rpn']] * 2
    captured['orcnn_loop_roi'] = [captured['orcnn_train_roi']]
    captured['orcnn_loop_eval_iou'] = captured['eval_iou'][1:]
    captured['orcnn_loop_nms'] = [captured['orcnn'], captured['retinanet']]
    captured['orcnn_loop_roi_align'] = [captured['orcnn_roi']]
    # phases 19-22: the merges' B=1 inputs, the HRSC run's matrices (its
    # own evaluation may give none)
    one = [(b[i:i + 1].contiguous(), c[i:i + 1].contiguous())
           for b, c in (captured['retinanet'],) for i in range(2)]
    captured['patch_merge'] = one
    captured['submission_merge'] = one[:1]
    captured['hrsc_assign'] = [captured['train_step']] * 3
    captured['hrsc_train_eval_iou'] = []
    captured['hrsc_eval_iou'] = captured['eval_iou'][1:]
    # phases 23-26: one FCOS and one CSL request's candidates, one ATSS
    # (priors as rows) and one KFIoU step's assigner inputs, the tiny loops'
    captured['fcos'] = captured['retinanet']
    captured['csl'] = captured['orcnn']
    captured['atss_train'] = (anchors, gts.clamp(min=1e-3), 'iou')
    captured['kfiou_train'] = captured['train_step']
    captured['csl_loop_assign'] = [captured['train_step']] * 2
    captured['fcos_loop_eval_iou'] = captured['eval_iou'][1:]
    captured['csl_loop_eval_iou'] = captured['eval_iou']
    captured['fcos_loop_nms'] = [captured['orcnn']]
    captured['csl_loop_nms'] = one
    # phases 27-30: each refine detector's slice and served candidates, its
    # train steps' first-stage (shared anchors) and refine (each image's
    # rois) inputs at G=32 and G=512, the float32 steps', the tiny loops'
    per_image = (gts.clamp(min=1e-3), props.clamp(min=1e-3), 'iou')
    for label in ('s2anet', 'r3det'):
        captured[label] = captured['retinanet']
        captured[f'{label}_slice_nms'] = [captured['orcnn']]
        captured[f'{label}_train'] = [captured['train_step'], per_image]
        captured[f'{label}_train_padded'] = [captured['train_step'],
                                             per_image]
        captured[f'{label}_slice_assign'] = [captured['train_step'],
                                             per_image]
        captured[f'{label}_loop_assign'] = [captured['train_step'],
                                            per_image] * 2
        captured[f'{label}_loop_eval_iou'] = captured['eval_iou'][1:]
        captured[f'{label}_loop_nms'] = [captured['orcnn']]
    captured['r3det_refine_slice_assign'] = [captured['train_step'],
                                             per_image, per_image]
    # phases 31-34: each family's served and float32 RoIAlign inputs (one a
    # stage; Faster R-CNN's at one sample a bin side), candidates, train
    # steps' RPN and RoI-stage inputs at G=32 and G=512, the tiny loops'
    theta0 = rois.clone()
    theta0[..., 4] = 0.0
    pooled = (feats, rois[:, :int(live.sum())].contiguous(), 2)
    light_rpn = (gts.clamp(min=1e-3), anchors[::9].contiguous(), 'iou')
    for label, stages in chip_smoke.HBB_POOLS.items():
        ratio = 1 if label == 'faster' else 2
        captured[label] = captured['retinanet']
        captured[f'{label}_roi'] = [(feats, theta0, ratio)] + \
            [pooled] * (stages - 1)
        captured[f'{label}_slice_roi'] = [(feats, theta0, ratio)]
        captured[f'{label}_slice_nms'] = [captured['orcnn']]
        steps = [light_rpn] + [per_image] * stages
        captured[f'{label}_train'] = steps
        captured[f'{label}_train_padded'] = steps
        captured[f'{label}_slice_assign'] = steps
        captured[f'{label}_loop_assign'] = steps * 2
        captured[f'{label}_loop_eval_iou'] = captured['eval_iou'][1:]
        captured[f'{label}_loop_nms'] = [captured['orcnn']]
        captured[f'{label}_loop_roi_align'] = [(feats, theta0, ratio)] * 2
    # phases 35-38: Swin Oriented R-CNN's and ReDet's inputs as the
    # families' above (one RoI stage), the ConvNeXt RetinaNet's candidates
    # and assigner inputs, ReDet's tiny loop
    for label in ('swin', 'redet'):
        captured[label] = captured['retinanet']
        captured[f'{label}_roi'] = [pooled]
        captured[f'{label}_slice_roi'] = [pooled]
        captured[f'{label}_slice_nms'] = [captured['orcnn']]
        for key in ('train', 'train_padded', 'slice_assign'):
            captured[f'{label}_{key}'] = [light_rpn, per_image]
    captured['redet_loop_assign'] = [light_rpn, per_image] * 2
    captured['redet_loop_eval_iou'] = captured['eval_iou'][1:]
    captured['redet_loop_nms'] = [captured['orcnn']]
    captured['redet_loop_roi_align'] = [pooled] * 2
    captured['convnext'] = captured['retinanet']
    captured['convnext_train'] = [captured['train_step']]
    captured['convnext_train_padded'] = [captured['train_step']] * 2
    # phases 39-42: the served point-set families' slice and request
    # candidates, the tiny loops' evaluation inputs (training runs no
    # kernel)
    for label in chip_smoke.REPPOINTS_SERVED:
        captured[label] = captured['retinanet']
        captured[f'{label}_slice_nms'] = [captured['orcnn']]
    for label in chip_smoke.REPPOINTS_TINY_CONFIGS:
        captured[f'{label}_loop_eval_iou'] = captured['eval_iou'][1:]
        captured[f'{label}_loop_nms'] = [captured['orcnn']] * 2
    # phases 43-46: the YOLOv8 models' slice and request candidates, the
    # assigner's decoded predictions x gts (both batched) of the slice's
    # and prototype4's steps and the tiny loop's, its evaluation's
    yolo_assign = (props.clamp(min=1e-3), gts.clamp(min=1e-3), 'iou')
    for label in chip_smoke.YOLO_SLICE:
        captured[f'{label}_slice_nms'] = [captured['orcnn']]
        captured[f'{label}_slice_assign'] = [yolo_assign]
    for label in chip_smoke.YOLO_SERVED:
        captured[label] = captured['retinanet']
    captured['yolov8_train'] = [yolo_assign]
    captured['yolov8_train_padded'] = [yolo_assign]
    for label in chip_smoke.YOLO_TINY_CONFIGS:
        captured[f'{label}_loop_assign'] = [yolo_assign] * 2
        captured[f'{label}_loop_eval_iou'] = captured['eval_iou'][1:]
        captured[f'{label}_loop_nms'] = [captured['orcnn']]
    # phases 50-52: the YOLOv6-neck model's slice and request candidates
    # and assigner inputs, the converted models' candidates (a seeded and a
    # converted request each) and the converted ReDet's RoIAlign inputs
    captured['yolov6_slice_nms'] = [captured['orcnn']]
    captured['yolov6'] = captured['retinanet']
    captured['yolov6_slice_assign'] = [yolo_assign]
    captured['yolov6_train'] = [yolo_assign]
    captured['prototype4_converted_nms'] = [captured['orcnn']] * 2
    captured['redet_converted_nms'] = [captured['orcnn']] * 2
    captured['redet_converted_roi'] = [pooled] * 2
    records = [dict(name='nms_pair_mask', max_abs_err=0),
               dict(name='roi_align_rotated', max_abs_err=0.0),
               dict(name='box_iou_rotated', max_abs_err=0.0)]
    chip_smoke.phase_main_path_kernels('cpu', captured, records, reps=1,
                                       roi_reps=1)
    pair, roi, iou = records
    assert pair['max_abs_err'] == 0 and roi['max_abs_err'] == 0.0
    assert iou['max_abs_err'] == 0.0
    refine = [f'{label}_{key}' for label in ('r3det', 's2anet')
              for key in ('loop_assign', 'loop_eval_iou', 'slice',
                          'train_first', 'train_padded_first',
                          'train_padded_refine', 'train_refine')]
    hbb = [f'{label}_{key}' for label, stages in chip_smoke.HBB_POOLS.items()
           for key in ['loop_assign', 'loop_eval_iou', 'slice',
                       'train_rpn', 'train_padded_rpn'] +
           [f'train{pad}_roi{i}' for pad in ('', '_padded')
            for i in range(stages)]]
    backbones = [f'{label}_{key}' for label in ('swin', 'redet')
                 for key in ('slice', 'train_rpn', 'train_padded_rpn',
                             'train_roi0', 'train_padded_roi0')] + [
        'redet_loop_assign', 'redet_loop_eval_iou', 'convnext_train',
        'convnext_train_padded']
    reppoints = [f'reppoints_{label}_loop_eval_iou'
                 for label in chip_smoke.REPPOINTS_TINY_CONFIGS]
    yolo = ['yolov8_slice_assign', 'yolov8_train', 'yolov8_train_padded'] + [
        f'{label}_{key}' for label in chip_smoke.YOLO_TINY_CONFIGS
        for key in ('loop_assign', 'loop_eval_iou')]
    assert sorted(iou['main_path_inputs']) == sorted([
        'atss_train', 'csl_loop_assign', 'csl_loop_eval_iou', 'eval_iou',
        'fcos_loop_eval_iou', 'hrsc_assign', 'hrsc_eval_iou', 'kfiou_train',
        'orcnn_loop_eval_iou', 'orcnn_loop_roi', 'orcnn_loop_rpn',
        'orcnn_train_roi', 'orcnn_train_rpn', 'train_step',
        'r3det_refine_slice'] + refine + hbb + backbones + reppoints +
        yolo + ['yolov6_slice_assign', 'yolov6_train'])
    assert sorted(roi['main_path_inputs']) == sorted(
        ['orcnn', 'orcnn_loop_eval'] +
        [f'{label}_{key}' for label in chip_smoke.HBB_POOLS
         for key in ('s0', 'slice', 'loop_eval')] + ['roitrans_s1'] +
        ['swin_s0', 'swin_slice', 'redet_s0', 'redet_slice',
         'redet_loop_eval', 'redet_converted'])
    assert iou['main_path_inputs']['convnext_train_padded'][
        'inputs_held'] == 2
    assert roi['main_path_inputs']['redet_loop_eval']['inputs_held'] == 2
    assert roi['main_path_inputs']['faster_s0']['sampling_ratio'] == 1
    assert roi['main_path_inputs']['gv_loop_eval']['inputs_held'] == 2
    assert roi['main_path_inputs']['gv_s0']['theta0_rois'] == \
        roi['main_path_inputs']['gv_s0']['live_rois'] > 0
    assert iou['main_path_inputs']['roitrans_loop_assign'][
        'inputs_held'] == 6
    assert iou['main_path_inputs']['s2anet_loop_assign']['inputs_held'] == 4
    assert iou['main_path_inputs']['r3det_refine_slice']['inputs_held'] == 3
    assert iou['main_path_inputs']['s2anet_train_refine']['pairs_in_reach'] \
        == iou['main_path_inputs']['orcnn_train_roi']['pairs_in_reach']
    assert iou['main_path_inputs']['csl_loop_assign']['inputs_held'] == 2
    assert iou['main_path_inputs']['hrsc_assign']['inputs_held'] == 3
    assert iou['main_path_inputs']['yolov8_slice_assign'][
        'inputs_held'] == len(chip_smoke.YOLO_SLICE)
    assert iou['main_path_inputs']['yolov8_loop_assign']['inputs_held'] == 2
    for label in chip_smoke.YOLO_SERVED:
        assert pair['main_path_inputs'][f'yolov8_{label}']['ms'] > 0
    for key in ('yolov6_slice', 'yolov6'):
        assert pair['main_path_inputs'][key]['ms'] > 0
    assert pair['main_path_inputs']['converted']['inputs_held'] == 4
    assert roi['main_path_inputs']['redet_converted']['inputs_held'] == 2
    for got in iou['main_path_inputs'].values():
        assert got['ms'] > 0 and got['plain_ms'] > 0 and got['bound_ms'] > 0
        assert got['pairs_in_reach'] > 0
    # the largest of a list is timed; every one is held
    assert iou['main_path_inputs']['eval_iou']['pairs_in_reach'] == \
        iou['main_path_inputs']['orcnn_train_roi']['pairs_in_reach']
    assert iou['main_path_inputs']['orcnn_loop_rpn']['inputs_held'] == 2
    assert pair['main_path_inputs']['patch_merge']['inputs_held'] == 2
    assert pair['main_path_inputs']['submission_merge']['largest_n'] == 90
    for key in ('retinanet', 'orcnn', 'orcnn_loop_eval', 'patch_merge',
                'submission_merge', 'fcos', 'csl', 'fcos_loop_nms',
                'csl_loop_nms', 's2anet', 'r3det', 's2anet_loop_nms',
                'r3det_loop_nms'):
        got = pair['main_path_inputs'][key]
        assert got['ms'] > 0 and got['plain_ms'] > 0 and got['bound_ms'] > 0
        assert 0 <= got['pairs_in_reach'] <= got['same_class_pairs']
    loop = pair['main_path_inputs']['orcnn_loop_eval']
    assert loop['inputs_held'] == 2 and loop['same_class_pairs'] == \
        pair['main_path_inputs']['retinanet']['same_class_pairs']
    for got in roi['main_path_inputs'].values():
        assert got['bound_by'] in ('bytes', 'operations') and got['cells'] > 0
        assert got['live_rois'] == sum(got['rois_per_level'])
        assert got['ms'] > 0 and got['plain_ms'] > 0 and got['bound_ms'] > 0
    for label in chip_smoke.HBB_POOLS:
        for key in (label, f'{label}_loop_nms'):
            assert pair['main_path_inputs'][key]['ms'] > 0
    for key in ('swin', 'redet', 'convnext', 'redet_loop_nms'):
        assert pair['main_path_inputs'][key]['ms'] > 0
    for label in chip_smoke.REPPOINTS_SERVED:
        assert pair['main_path_inputs'][f'reppoints_{label}'][
            'inputs_held'] == 2
    for label in chip_smoke.REPPOINTS_TINY_CONFIGS:
        assert pair['main_path_inputs'][f'reppoints_{label}_loop_nms'][
            'inputs_held'] == 2


def test_held_iou_matrices_check_an_equal_input_once(monkeypatch):
    """Phase 12 checks and times an input equal to one held before (the
    two-stage families' RPN inputs) once, and every other input anew."""
    anchors = chip_smoke.config_anchors(128, 'cpu')
    gts = chip_smoke.seeded_gts(anchors, 2, 8, 3, 8)[0].clamp(min=1e-3)
    other = chip_smoke.seeded_gts(anchors, 2, 8, 3, 9)[0].clamp(min=1e-3)
    checked = []
    check = chip_smoke.check_iou_matrix
    monkeypatch.setattr(chip_smoke, 'check_iou_matrix',
                        lambda *args: checked.append(args) or check(*args))
    chip_smoke.HELD_MATRICES.clear()
    iou = dict(max_abs_err=0.0, main_path_inputs={})
    for key, boxes in (('a', gts), ('b', gts.clone()), ('c', other)):
        chip_smoke.held_iou_matrices([(boxes, anchors, 'iou')], key, key, iou,
                                     'cpu', '', 1, 1)
    assert len(checked) == 2
    got = iou['main_path_inputs']
    assert got['a']['ms'] == got['b']['ms'] and got['c']['ms'] > 0
    assert got['b']['inputs_held'] == 1


def test_pair_mask_rows_hold_a_large_input_in_blocks(monkeypatch):
    """From BIG_N on, phase 12 holds a merge's mask in row blocks: the same
    in-band count and pair counts as the whole check, and a moved bit out
    of the band is caught."""
    boxes, cls = chip_smoke.dota_candidates(1, 300, 3, num_classes=2)
    boxes, cls = torch.from_numpy(boxes), torch.from_numpy(cls)
    in_band, same, reach, plain_ms = chip_smoke.pair_mask_rows(
        boxes, cls, 'cpu', rows=64)
    assert in_band == chip_smoke.check_pair_mask(boxes, cls)[1]
    assert (same, reach) == chip_smoke.pair_mask_bound_ms(boxes, cls)[2:]
    assert plain_ms > 0 and 0 < reach < same
    pair = dict(name='nms_pair_mask', max_abs_err=0, main_path_inputs={})
    monkeypatch.setattr(chip_smoke, 'BIG_N', 200)
    chip_smoke.held_pair_masks([(boxes[:, :100].contiguous(),
                                 cls[:, :100].contiguous()), (boxes, cls)],
                               'test', 'merge', pair, 'cpu', '', 1, 1)
    got = pair['main_path_inputs']['merge']
    assert got['largest_n'] == 300 and got['pairs_in_reach'] == reach
    from orientedobjectdetection_torch.ops import iou_kernels
    wrong = iou_kernels.nms_pair_mask_plain(boxes, 0.1, cls)
    far = torch.nonzero(torch.triu(
        ~iou_kernels.pairs_in_reach(boxes, boxes)[0], 1))[0]
    wrong[0, far[0], far[1]] = 1
    monkeypatch.setattr(iou_kernels, 'nms_pair_mask',
                        lambda *args: wrong)
    with pytest.raises(AssertionError, match='outside the band'):
        chip_smoke.pair_mask_rows(boxes, cls, 'cpu', rows=64)


def test_greedy_rounds_counts_the_fixpoint():
    """A chain 0 - 1 - 2 - 3 of overlapping neighbours: the fixpoint
    iteration drops 1, 2 and 3 (round 1), brings back 2 and 3 (round 2),
    drops 3 again (round 3) and sees no change (round 4); boxes that do not
    overlap take one round."""
    boxes = torch.tensor([[[10. + 6 * i, 10., 10., 10., 0.]
                           for i in range(4)]])
    cls = torch.zeros((1, 4), dtype=torch.int32)
    assert chip_smoke.greedy_rounds(boxes, cls) == 4
    far = boxes.clone()
    far[0, :, 0] = torch.arange(4) * 100.0
    assert chip_smoke.greedy_rounds(far, cls) == 1


def test_recording_carries_the_launch_count():
    """A wrapper recorded in its own module counts on the recorder: the
    count goes on from the wrapper's and comes back to it after."""
    from orientedobjectdetection_torch.ops import iou_kernels
    wrapper = iou_kernels.box_iou_rotated_matrix
    chip_smoke.reset_launches()
    wrapper.launches = 3
    with chip_smoke.recording(iou_kernels, 'box_iou_rotated_matrix'):
        assert chip_smoke.read_launches()['box_iou_rotated'] == 3
        iou_kernels.box_iou_rotated_matrix.launches += 2    # two launches
    assert iou_kernels.box_iou_rotated_matrix is wrapper
    assert wrapper.launches == 5
    chip_smoke.reset_launches()


def test_pair_mask_bound_counts_pairs_in_reach():
    """Three boxes of one class: (0, 1) overlap, 2 is far away; a box of
    another class on top of 0 is not a same-class pair."""
    boxes = torch.tensor([[[10., 10., 8., 8., 0.], [12., 10., 8., 8., 0.],
                           [500., 10., 8., 8., 0.], [10., 10., 8., 8., 0.]]])
    cls = torch.tensor([[0, 0, 0, 1]], dtype=torch.int32)
    bound, by, same, in_reach = chip_smoke.pair_mask_bound_ms(boxes, cls)
    assert (same, in_reach, by) == (3, 1, 'bytes')
    nbytes = 20 * 4 + 4 * 4 + 16
    assert bound == nbytes / chip_smoke.PEAK_BYTES * 1e3


def dets_of(rows):
    """rows: (score, label) per detection, in output order, one image."""
    scores = torch.tensor([[r[0] for r in rows]])
    boxes = 100.0 * scores[..., None] + torch.arange(5.0)
    labels = torch.tensor([[r[1] for r in rows]])
    return (torch.cat([boxes, scores[..., None]], -1), labels,
            torch.ones_like(labels, dtype=torch.bool))


@pytest.mark.parametrize('got,ref,result', [
    # a near-tie in another order, and another candidate at the NMS cut
    ([(.9, 1), (.50002, 2), (.50001, 3), (.20004, 1)],
     [(.9, 1), (.50001, 3), (.50002, 2), (.20003, 4), (.20001, 1)],
     (0.0, 2, 3)),
    ([(.9, 1), (.5, 2)], [(.9, 1), (.5, 2)], (0.0, 0, 0)),
    ([(.9, 1), (.5, 2)], [(.9, 1), (.5, 3)], 'detections differ'),
    ([(.9, 1), (.5, 2)], [(.9, 1), (.52, 2)], 'detections differ'),
    ([(.9, 1), (.5, 2)], [(.9, 1)], 'clear of the cut'),
    ([(.9, 1), (.9005, 2)], [(.9005, 2), (.9, 1)], 'changed places'),
])
def test_same_detections(got, ref, result):
    cut = torch.tensor([0.2])
    if isinstance(result, str):
        with pytest.raises(AssertionError, match=result):
            chip_smoke.same_detections(dets_of(got), dets_of(ref), cut)
    else:
        assert chip_smoke.same_detections(dets_of(got), dets_of(ref),
                                          cut) == result


def test_kernels_table_names_both_sources():
    root = pathlib.Path(chip_smoke.__file__).parent
    assert sorted(chip_smoke.KERNELS) == ['box_iou_rotated', 'nms_pair_mask',
                                          'roi_align_rotated']
    assert sorted(chip_smoke.kernel_wrappers()) == sorted(chip_smoke.KERNELS)
    for name, entry in chip_smoke.KERNELS.items():
        assert (root / entry['source']).name == f'{name}.cu'
        assert (root / entry['source']).exists()
        path, line = entry['replaces'].split(':')
        text = (root / path).read_text().splitlines()[int(line) - 1]
        assert text.startswith(f'def {name}_pallas(')


def test_main_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    proc = subprocess.run([sys.executable, chip_smoke.__file__],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ''
    assert 'no CUDA device' in proc.stderr


@pytest.mark.parametrize('kernel', ['nms_pair_mask', 'roi_align_rotated',
                                    'box_iou_rotated'])
def test_kernel_variants_still_edit_the_sources(kernel):
    """Every edit of ``utils/kernel_variants.py`` matches its kernel's
    source once, and every variant but ``shipped`` changes it."""
    from orientedobjectdetection_torch.utils import kernel_variants as kv
    table = {'nms_pair_mask': kv.PAIR_MASK,
             'roi_align_rotated': kv.ROI_ALIGN,
             'box_iou_rotated': kv.IOU_MATRIX}[kernel]
    sources = kv.edited_sources(kernel, table)
    shipped = sources.pop('shipped')
    assert shipped == (kv.cuda_build.CSRC / f'{kernel}.cu').read_text()
    assert sources and all(src != shipped for src in sources.values())


# ---- phases 15-18 at a tiny size: configs derived from the ones the chip
# run uses, cut to 128 px, narrow heads, batches of 2
TINY_PIPELINES = '''
img_norm_cfg = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12,
                    57.375], to_rgb=True)
train_pipeline = [
    dict(type='LoadImageFromFile'),
    dict(type='LoadAnnotations', with_bbox=True),
    dict(type='RResize', img_scale=(128, 128)),
    dict(type='RRandomFlip', flip_ratio=0.5, version='le90'),
    dict(type='Normalize', **img_norm_cfg),
    dict(type='Pad', size_divisor=32),
    dict(type='Collect', keys=['img', 'gt_bboxes', 'gt_labels'])]
test_pipeline = [
    dict(type='LoadImageFromFile'),
    dict(type='RResize', img_scale=(128, 128)),
    dict(type='Normalize', **img_norm_cfg),
    dict(type='Pad', size_divisor=32),
    dict(type='Collect', keys=['img'])]
data = dict(samples_per_gpu=2, workers_per_gpu=1, max_gt=8,
            pad_size=(128, 128), train=dict(pipeline=train_pipeline),
            val=dict(pipeline=test_pipeline),
            test=dict(pipeline=test_pipeline))
pad_size = (128, 128)
'''
TINY_RETINANET = '''
model = dict(
    backbone=dict(depth=18, frozen_stages=-1),
    neck=dict(in_channels=[64, 128, 256, 512], out_channels=32),
    bbox_head=dict(in_channels=32, feat_channels=32, stacked_convs=1),
    test_cfg=dict(nms_pre=64, max_candidates=64, max_per_img=50))
''' + TINY_PIPELINES
TINY_ORCNN = '''
model = dict(
    train_cfg=dict(rpn_proposal=dict(nms_pre=128, max_per_img=64),
                   rcnn=dict(sampler=dict(num=32))),
    test_cfg=dict(rpn=dict(nms_pre=128, max_per_img=64),
                  rcnn=dict(nms_pre=64, max_candidates=64, max_per_img=50)))
''' + TINY_PIPELINES


def derived_config(tmp_path, base, body):
    path = tmp_path / f'tiny_{pathlib.Path(base).name}'
    path.write_text(f'_base_ = [{base!r}]\n' + body)
    return str(path)


@pytest.fixture(scope='module')
def tiny_loop(tmp_path_factory):
    """Phases 15 and 16 once at a tiny size; phase 17 reads their result."""
    tmp = tmp_path_factory.mktemp('loop')
    config = derived_config(tmp, chip_smoke.SYNTH1024_CONFIG, TINY_RETINANET)
    root = str(tmp / 'hard')
    rate = chip_smoke.phase_data(root, config=config, size=128, n_train=4,
                                 n_val=2, n_range=(10, 30), epochs=1)
    counts, trained = chip_smoke.phase_trainer(
        root, str(tmp / 'work'), config=config, steps=2, extra=1,
        dtype=torch.float32, device='cpu', log_interval=1, bare_steps=1,
        synthetic_rate=12.5)
    return dict(config=config, root=root, rate=rate, counts=counts,
                trained=trained, work=str(tmp / 'work'))


def test_phase_data_rehearsal(tiny_loop):
    assert tiny_loop['rate'] > 0
    # the generated set, the round trip of its polygons
    polys = chip_smoke.annotation_polys(tiny_loop['root'] +
                                        '/val/annfiles')
    assert len(polys) == 2 and all(10 <= len(p) <= 30
                                   for p in polys.values())
    assert chip_smoke.check_round_trip(np.concatenate(list(polys.values())),
                                       'le90') <= chip_smoke.ROUND_TRIP_ATOL


def test_check_round_trip_refuses_a_moved_corner():
    poly = np.array([[10, 10, 40, 10, 40, 20, 10, 20]], np.float32)
    assert chip_smoke.check_round_trip(poly, 'le90') < 1e-4
    poly[0, 0] += 1.0
    with pytest.raises(AssertionError, match='round-trip'):
        chip_smoke.check_round_trip(poly, 'le90')


def test_phase_trainer_rehearsal(tiny_loop):
    assert tiny_loop['counts'] == NO_LAUNCHES
    files = sorted(os.listdir(tiny_loop['work']))
    # the first run's checkpoint and best; the resumed run's end
    assert files == ['best_00000002.pth', 'ckpt_00000002.pth',
                     'ckpt_00000003.pth', 'train_log.jsonl']
    log = chip_smoke.read_train_log(tiny_loop['work'])
    assert [r['step'] for r in log if 'loss' in r] == [1, 2, 3]
    assert 'bbox_head.retina_cls.bias' in tiny_loop['trained']


def test_phase_evaluator_rehearsal(tiny_loop):
    counts, inputs = chip_smoke.phase_evaluator(tiny_loop['root'],
                                                tiny_loop['trained'],
                                                config=tiny_loop['config'],
                                                device='cpu')
    assert counts == NO_LAUNCHES
    # eval_rbbox_map's padded dets x gts of each class with both
    assert inputs['eval_iou']
    for boxes1, boxes2, mode in inputs['eval_iou']:
        assert mode == 'iou' and boxes1.dim() == boxes2.dim() == 3
        assert boxes1.shape[0] == boxes2.shape[0] == 2


def test_phase_orcnn_loop_rehearsal(tmp_path):
    config = derived_config(tmp_path, chip_smoke.ORCNN_TINY_CONFIG,
                            TINY_ORCNN)
    counts, inputs = chip_smoke.phase_orcnn_loop(
        str(tmp_path / 'tiny'), str(tmp_path / 'work'), config=config,
        n_images=4, size=128, steps=2, dtype=torch.float32, device='cpu',
        log_interval=1)
    assert counts == NO_LAUNCHES
    assert [len(inputs[k]) for k in ('orcnn_loop_rpn', 'orcnn_loop_roi')] \
        == [2, 2]
    assert inputs['orcnn_loop_eval_iou'] and inputs['orcnn_loop_nms']
    levels, rois = inputs['orcnn_loop_roi_align'][0]
    assert levels[0].shape[-1] == 64 and rois.shape[-1] == 5


def test_run_trainer_wants_whole_epochs(tiny_loop):
    cfg = chip_smoke.synth_config(tiny_loop['config'], tiny_loop['root'])
    with pytest.raises(ValueError, match='whole epochs'):
        chip_smoke.run_trainer(cfg, tiny_loop['work'] + '_x', 3, 'cpu',
                               torch.float32, 1, 1)


def test_stack_results_pads_per_image():
    results = [[np.ones((2, 6), np.float32), np.zeros((0, 6), np.float32)],
               [np.zeros((0, 6), np.float32), np.full((1, 6), 2.0,
                                                      np.float32)]]
    dets, labels, valid = chip_smoke.stack_results(results, 2)
    assert dets.shape == (2, 2, 6)
    assert labels.tolist() == [[0, 0], [1, -1]]
    assert valid.tolist() == [[True, True], [True, False]]


# ---- phases 19-22 at a tiny size
def test_phase_patches_rehearsal():
    counts, inputs = chip_smoke.phase_patches(
        'cpu', size=300, window=128, step=100, bsz=4, dtype=torch.float32,
        max_candidates=300)
    assert counts == NO_LAUNCHES
    merges = inputs['patch_merge']
    assert merges and all(b.shape[0] == 1 and c.shape == b.shape[:2]
                          and c.dtype == torch.int32 for b, c in merges)
    # one merge NMS a class with detections, each over all 9 windows'
    assert 1 < len(merges) <= 15


def test_phase_tta_rehearsal():
    counts = chip_smoke.phase_tta('cpu', n_images=1, size=128,
                                  dtype=torch.float32, max_candidates=300)
    assert counts == NO_LAUNCHES


def test_phase_submission_rehearsal(tiny_loop, tmp_path, monkeypatch):
    """On the CPU the merge's per-class NMS is the native host NMS
    (``nms_rotated_np(device='cpu')``), so no pair-mask input is recorded
    here; on the card each merge class is one pair-mask launch, recorded
    for phase 12 (``test_phase_patches_rehearsal`` covers the recording)."""
    from orientedobjectdetection_torch import native
    calls = []
    inner = native.nms_rotated
    monkeypatch.setattr(native, 'nms_rotated',
                        lambda *a: calls.append(len(a[0])) or inner(*a))
    counts, inputs = chip_smoke.phase_submission(
        str(tmp_path / 'sub'), tiny_loop['trained'],
        config=tiny_loop['config'], n_images=2, size=256, tile=128, gap=32,
        device='cpu', batch_size=4, max_objs=8)
    assert counts == NO_LAUNCHES
    assert inputs['submission_merge'] == [] and calls
    names = sorted(os.listdir(tmp_path / 'sub' / 'submission_multi-scale'))
    assert len(names) == 16 and 'submission.zip' in names


TINY_HRSC = '''
model = dict(
    backbone=dict(depth=18, frozen_stages=-1),
    neck=dict(in_channels=[64, 128, 256, 512], out_channels=32),
    bbox_head=dict(in_channels=32, feat_channels=32, stacked_convs=1),
    test_cfg=dict(nms_pre=64, max_candidates=64, max_per_img=50))
img_norm_cfg = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12,
                    57.375], to_rgb=True)
train_pipeline = [
    dict(type='LoadImageFromFile'),
    dict(type='LoadAnnotations', with_bbox=True),
    dict(type='RResize', img_scale=(200, 64)),
    dict(type='RRandomFlip', flip_ratio=0.5, version='le90'),
    dict(type='PolyRandomRotate', rotate_ratio=0.5, angles_range=180,
         auto_bound=False, version='le90'),
    dict(type='Normalize', **img_norm_cfg),
    dict(type='Pad', size_divisor=32),
    dict(type='Collect', keys=['img', 'gt_bboxes', 'gt_labels'])]
test_pipeline = [dict(type='LoadImageFromFile')]
data = dict(samples_per_gpu=2, workers_per_gpu=1,
            train=dict(pipeline=train_pipeline),
            val=dict(pipeline=test_pipeline),
            test=dict(pipeline=test_pipeline))
pad_size = (128, 128)
'''


def test_phase_augment_rehearsal(tmp_path):
    config = derived_config(tmp_path, chip_smoke.HRSC_CONFIG, TINY_HRSC)
    counts, inputs = chip_smoke.phase_augment(
        str(tmp_path / 'hrsc'), str(tmp_path / 'work'), config=config,
        n_train=4, n_val=2, size=128, steps=2, dtype=torch.float32,
        device='cpu', log_interval=1, bare_steps=1, mosaic_batches=1)
    assert counts == NO_LAUNCHES
    assert len(inputs['hrsc_assign']) == 2
    gts, anchors, mode = inputs['hrsc_assign'][0]
    assert gts.shape[:2] == (2, 512) and anchors.dim() == 2
    assert inputs['hrsc_eval_iou']
    sets = tmp_path / 'hrsc' / 'ImageSets'
    assert len((sets / 'trainval.txt').read_text().split()) == 4
    assert (sets / 'test.txt').read_text().split() == ['H0004', 'H0005']


# ---- phases 23-26 at a tiny size: the published configs at 128 px --------
def test_phase_fcos_rehearsal():
    runs, captured = chip_smoke.phase_fcos(
        'cpu', bsz=1, size=128, slice_bsz=1, warm=1, timed=1, train_warm=1,
        train_timed=1, g=8, valid=3, max_candidates=300, dtype=torch.float32,
        padded_g=16, padded_valid=5)
    assert runs == [NO_LAUNCHES, NO_LAUNCHES]
    boxes, cls = captured['fcos']
    assert boxes.shape == (1, 300, 5) and cls.shape == (1, 300)


@pytest.mark.parametrize('family', list(chip_smoke.FAMILY_CONFIGS))
def test_phase_anchor_families_rehearsal(family):
    runs, captured = chip_smoke.phase_anchor_families(
        'cpu', bsz=1, size=128, slice_bsz=1, warm=1, timed=1, serve_warm=1,
        serve_timed=1, g=8, valid=3, max_candidates=300, dtype=torch.float32,
        families=(family,), padded_g=16, padded_valid=5)
    assert runs == [NO_LAUNCHES, NO_LAUNCHES]      # training, serving
    boxes1, boxes2, mode = captured[f'{family}_train']
    assert mode == 'iou'
    if family == 'atss':          # priors as rows, the batch's gts columns
        assert boxes1.dim() == 2 and boxes2.shape == (1, 8, 5)
    else:
        assert boxes1.shape == (1, 8, 5) and boxes2.dim() == 2
    assert captured[family][0].shape == (1, 300, 5)


def test_check_atss_assigner_refuses_a_moved_assignment(monkeypatch):
    from orientedobjectdetection_torch.core import (ATSSObbAssigner,
                                                    AssignResult)
    assigner = ATSSObbAssigner()
    anchors = chip_smoke.config_anchors(128, 'cpu')[::9].contiguous()
    gts, labels, mask = chip_smoke.seeded_gts(anchors, 1, 8, 3, 4)
    num_level = [len(anchors)]
    positives, differ = chip_smoke.check_atss_assigner(
        assigner, anchors, num_level, gts, labels, mask)
    assert positives > 0 and differ == 0
    call = ATSSObbAssigner.__call__

    def moved(self, *args):
        result = call(self, *args)
        if self.plain_iou:
            return result
        inds = result.assigned_gt_inds.clone()
        inds[0, int((inds[0] >= 0).nonzero()[0])] = -1
        return AssignResult(inds, result.max_overlaps, result.labels)

    monkeypatch.setattr(ATSSObbAssigner, '__call__', moved)
    with pytest.raises(AssertionError, match='outside the band'):
        chip_smoke.check_atss_assigner(assigner, anchors, num_level, gts,
                                       labels, mask)


TINY_FAMILY = '''
model = dict(test_cfg=dict(nms_pre=64, max_candidates=64, max_per_img=50))
''' + TINY_PIPELINES


def test_phase_family_loops_rehearsal(tmp_path):
    from orientedobjectdetection_torch.tools.generate_synth import \
        generate_synth
    root = str(tmp_path / 'tiny')
    generate_synth(root, 4, 128, seed=0)
    configs = {k: derived_config(tmp_path, v, TINY_FAMILY)
               for k, v in chip_smoke.FAMILY_TINY_CONFIGS.items()}
    runs, inputs = chip_smoke.phase_family_loops(
        root, str(tmp_path / 'work'), configs=configs, steps=2,
        dtype=torch.float32, device='cpu', log_interval=1)
    assert runs == [NO_LAUNCHES, NO_LAUNCHES]
    assert inputs['fcos_loop_assign'] == []          # FCOS has no assigner
    assert len(inputs['csl_loop_assign']) == 2       # one matrix a step
    for key in ('fcos_loop_eval_iou', 'csl_loop_eval_iou', 'fcos_loop_nms',
                'csl_loop_nms'):
        assert inputs[key], key


def test_same_params_allows_a_float32_step_and_nothing_more():
    w = torch.full((4,), 0.01)
    step = float(torch.nextafter(w[0], torch.tensor(1.0)) - w[0])
    moved = w + 30 * step              # a change of a few float32 steps
    ref = dict(metrics={'loss': 1.0}, before={'w': w},
               after={'w': moved.clone()},
               detector=torch.nn.ParameterDict(
                   {'w': torch.nn.Parameter(w.clone())}))

    def got(after):
        return dict(metrics={'loss': 1.0}, after={'w': after})

    rounded = moved.clone()
    rounded[0] += step                 # one update rounded the other way
    chip_smoke.same_params(got(rounded), ref, 'one step')
    apart = moved.clone()
    apart[0] += 3 * step               # 10% of the change: a real difference
    with pytest.raises(AssertionError, match='float32 step'):
        chip_smoke.same_params(got(apart), ref, 'three steps')


def test_same_params_after_adamw_loosens_only_rounding_gradients():
    """After an AdamW step an element whose gradient is at rounding size
    may move by up to its tensor's change the other way; an element with
    a real gradient is held as after SGD."""
    w = torch.zeros(4)
    lr = 1e-4
    after = w - lr * torch.tensor([1.0, 1.0, 1.0, 0.3])
    ref = dict(metrics={'loss': 1.0}, before={'w': w},
               after={'w': after.clone()}, adam=True,
               grads={'w': torch.tensor([2.0, 1.0, 0.5, 1e-9])},
               detector=torch.nn.ParameterDict(
                   {'w': torch.nn.Parameter(w.clone())}))
    noise = after.clone()
    noise[3] = w[3] + lr * 0.3        # a rounding gradient's other sign
    chip_smoke.same_params(dict(metrics={'loss': 1.0}, after={'w': noise}),
                           ref, 'noise')
    for i, shift in ((0, 0.05 * lr), (3, 3 * lr)):
        apart = after.clone()
        apart[i] += shift
        with pytest.raises(AssertionError):
            chip_smoke.same_params(dict(metrics={'loss': 1.0},
                                        after={'w': apart}), ref, 'apart')


# ---- phases 27-30 at a tiny size: the published refine configs with a
# ResNet-18 backbone at 128 px
TINY_REFINE = '''
model = dict(
    backbone=dict(depth=18),
    neck=dict(in_channels=[64, 128, 256, 512]),
    test_cfg=dict(nms_pre=300, max_candidates=300, max_per_img=100))
'''


@pytest.fixture
def tiny_refine(tmp_path, monkeypatch):
    """The phases' refine configs replaced by ResNet-18 copies (the three
    float32 recipes by the cascade alone)."""
    configs = {k: derived_config(tmp_path, v, TINY_REFINE)
               for k, v in chip_smoke.REFINE_CONFIGS.items()}
    recipes = {'r3det_refine': derived_config(
        tmp_path, chip_smoke.REFINE_RECIPES['r3det_refine'], TINY_REFINE)}
    monkeypatch.setattr(chip_smoke, 'REFINE_CONFIGS', configs)
    monkeypatch.setattr(chip_smoke, 'REFINE_RECIPES', recipes)
    return configs


def test_phase_refine_slice_rehearsal(tiny_refine):
    captured = chip_smoke.phase_refine_slice('cpu', bsz=1, size=128, g=8,
                                             valid=3, max_candidates=300)
    for label in ('s2anet', 'r3det'):
        (boxes, cls), = captured[f'{label}_slice_nms']
        assert boxes.shape == (1, 300, 5) and cls.shape == (1, 300)
        first, refine = captured[f'{label}_slice_assign']
        assert first[0].shape == (1, 8, 5) and first[1].dim() == 2
        # the refine stage: each image's own rois, one a location
        assert refine[0].shape == (1, 8, 5)
        assert refine[1].shape == (1, 341, 5) and refine[2] == 'iou'
    assert len(captured['r3det_refine_slice_assign']) == 3   # s0, sr0, sr1


def test_phase_refine_serving_rehearsal(tiny_refine):
    runs, captured = chip_smoke.phase_refine_serving(
        'cpu', bsz=1, size=128, warm=1, timed=1, dtype=torch.float32,
        max_candidates=300)
    assert runs == [NO_LAUNCHES, NO_LAUNCHES]
    for label in ('s2anet', 'r3det'):
        boxes, cls = captured[label]
        assert boxes.shape == (1, 300, 5) and cls.shape == (1, 300)


def test_phase_refine_training_rehearsal(tiny_refine):
    runs, captured = chip_smoke.phase_refine_training(
        'cpu', bsz=1, size=128, g=8, valid=3, warm=1, timed=1,
        dtype=torch.float32, padded_g=16, padded_valid=5, reps=1)
    assert runs == [NO_LAUNCHES, NO_LAUNCHES]
    for label in ('s2anet', 'r3det'):
        first, refine = captured[f'{label}_train']
        assert first[0].shape == (1, 8, 5) and first[1].dim() == 2
        assert refine[1].shape == (1, 341, 5)
        padded = captured[f'{label}_train_padded']
        assert len(padded) == 2 and padded[1][0].shape == (1, 16, 5)
        sampling = captured[f'{label}_sampling']
        assert sampling['forward_ms'] > 0 and sampling['backward_ms'] > 0


def test_refine_ranges_are_the_detectors():
    """The ranges phases 28-29 split by are the ones the detectors open,
    in a profiled CPU train step and request of a tiny S2ANet and R3Det."""
    from torch.profiler import profile
    from orientedobjectdetection_torch.models import build_detector
    from orientedobjectdetection_torch.utils import Config
    seen = set()
    for config in chip_smoke.REFINE_TINY_CONFIGS.values():
        detector = build_detector(dict(Config.fromfile(config).model))
        detector.init_weights(0)
        images = torch.randn(1, 3, 64, 64)
        batch = dict(gt_bboxes=torch.tensor([[[30.0, 30, 20, 10, 0.3]]]),
                     gt_labels=torch.zeros(1, 1, dtype=torch.long),
                     gt_mask=torch.ones(1, 1, dtype=torch.bool))
        with profile() as prof:
            out = detector(images)
            detector.loss_from_outputs(out, batch)
            with torch.no_grad():
                detector.bboxes_from_outputs(detector(images))
        seen |= {e.key for e in prof.key_averages()
                 if e.key.startswith('refine.')}
    assert seen == set(chip_smoke.REFINE_TRAIN_RANGES +
                       chip_smoke.REFINE_RANGES)


def test_pairs_in_reach_for_per_image_columns():
    """The refine assigner's layout, each image's gts against its own rois:
    phase 12 counts the pairs in reach image by image and bounds the
    (B, G, N) output."""
    from orientedobjectdetection_torch.ops.iou_kernels import pairs_in_reach
    anchors = chip_smoke.config_anchors(128, 'cpu')[::9].contiguous()
    gts = chip_smoke.seeded_gts(anchors, 2, 8, 3, 11)[0].clamp(min=1e-3)
    rois = torch.stack([anchors, anchors.flip(0)])
    rois[1, :, :2] += 7.0
    err, live = chip_smoke.check_iou_matrix(gts, rois, 'iou')
    assert err == 0.0
    assert live == sum(int(pairs_in_reach(gts[b], rois[b]).sum())
                       for b in range(2))
    assert 0 < live < chip_smoke.matrix_pairs(gts, rois) == 2 * 8 * 341
    bound, by = chip_smoke.iou_matrix_bound_ms(gts, rois, live)
    t_bytes = (gts.numel() + rois.numel() + 2 * 8 * 341) * 4 / \
        chip_smoke.PEAK_BYTES * 1e3
    t_ops = live * chip_smoke.FLOP_PER_IOU_PAIR / chip_smoke.PEAK_FP32 * 1e3
    assert bound == pytest.approx(max(t_bytes, t_ops))
    assert by == ('bytes' if t_bytes >= t_ops else 'operations')


def test_phase_refine_loops_rehearsal(tmp_path):
    from orientedobjectdetection_torch.tools.generate_synth import \
        generate_synth
    root = str(tmp_path / 'tiny')
    generate_synth(root, 4, 128, seed=0)
    configs = {k: derived_config(tmp_path, v, TINY_FAMILY)
               for k, v in chip_smoke.REFINE_TINY_CONFIGS.items()}
    runs, inputs = chip_smoke.phase_refine_loops(
        root, str(tmp_path / 'work'), configs=configs, steps=2,
        dtype=torch.float32, device='cpu', log_interval=1)
    assert runs == [NO_LAUNCHES, NO_LAUNCHES]
    for label in ('s2anet', 'r3det'):
        assign = inputs[f'{label}_loop_assign']
        assert len(assign) == 4                      # two matrices a step
        assert assign[0][1].dim() == 2 and assign[1][1].dim() == 3
        assert inputs[f'{label}_loop_eval_iou'] and \
            inputs[f'{label}_loop_nms']


# ---- phases 31-34 at a tiny size: the published two-stage configs with a
# ResNet-18 backbone at 128 px
TINY_HBB = '''
model = dict(
    backbone=dict(depth=18),
    neck=dict(in_channels=[64, 128, 256, 512]),
    train_cfg=dict(rpn_proposal=dict(nms_pre=128, max_per_img=64)),
    test_cfg=dict(rpn=dict(nms_pre=128, max_per_img=64)))
'''


@pytest.fixture
def tiny_hbb(tmp_path, monkeypatch):
    """The phases' configs replaced by ResNet-18 copies."""
    configs = {k: derived_config(tmp_path, v, TINY_HBB)
               for k, v in chip_smoke.HBB_CONFIGS.items()}
    monkeypatch.setattr(chip_smoke, 'HBB_CONFIGS', configs)
    return configs


def test_phase_hbb_slice_rehearsal(tiny_hbb):
    captured = chip_smoke.phase_hbb_slice('cpu', bsz=1, size=128, g=8,
                                          valid=3, max_num=64,
                                          max_candidates=64)
    for label, stages in chip_smoke.HBB_POOLS.items():
        pools = captured[f'{label}_slice_roi']
        assert len(pools) == stages
        levels, rois, ratio = pools[0]
        assert rois.shape == (1, 64, 5) and levels[0].shape[1:3] == (32, 32)
        assert ratio == (1 if label == 'faster' else 2)
        assert (rois[..., 4] == 0).all()                # theta-0 proposals
        if stages == 2:                                 # rotated stage 1
            assert (pools[1][1][..., 4] != 0).any()
        (boxes, cls), = captured[f'{label}_slice_nms']
        assert boxes.shape[-1] == 5
        calls = captured[f'{label}_slice_assign']
        assert len(calls) == chip_smoke.HBB_ASSIGNS[label]
        assert calls[-1][1].dim() == 2                  # the RPN's, last
        assert all(c[1].dim() == 3 for c in calls[:-1])


def test_phase_hbb_serving_rehearsal(tiny_hbb):
    runs, captured = chip_smoke.phase_hbb_serving(
        'cpu', bsz=1, size=128, warm=1, timed=1, dtype=torch.float32,
        max_num=64, max_candidates=64)
    assert runs == [NO_LAUNCHES] * 3
    for label, stages in chip_smoke.HBB_POOLS.items():
        assert len(captured[f'{label}_roi']) == stages
        assert captured[label][0].shape[-1] == 5


def test_phase_hbb_training_rehearsal(tiny_hbb):
    steps = {k: (2, 6) for k in chip_smoke.HBB_CONFIGS}
    runs, captured = chip_smoke.phase_hbb_training(
        'cpu', bsz=1, size=128, g=8, valid=3, dtype=torch.float32,
        padded_g=16, padded_valid=5, steps=steps, reps=1)
    assert runs == [NO_LAUNCHES] * 3
    for label, assigns in chip_smoke.HBB_ASSIGNS.items():
        calls = captured[f'{label}_train']
        assert len(calls) == assigns and calls[-1][1].dim() == 2
        assert captured[f'{label}_train_padded'][0][0].shape == (1, 16, 5)
    assert len(captured['roitrans_gather']) == 2


def test_hbb_ranges_are_the_detectors():
    """The samplers' ranges phase 33 watches and RoI Transformer's stage
    ranges are the ones the detectors open, in a profiled CPU train step
    and request."""
    from torch.profiler import profile
    from orientedobjectdetection_torch.core import SampleKey
    from orientedobjectdetection_torch.models import build_detector
    from orientedobjectdetection_torch.utils import Config
    detector = build_detector(dict(Config.fromfile(
        chip_smoke.HBB_TINY_CONFIGS['roitrans']).model))
    detector.init_weights(0)
    images = torch.randn(1, 3, 64, 64)
    batch = dict(gt_bboxes=torch.tensor([[[30.0, 30, 20, 10, 0.3]]]),
                 gt_labels=torch.zeros(1, 1, dtype=torch.long),
                 gt_mask=torch.ones(1, 1, dtype=torch.bool))
    with profile() as prof:
        out = detector(images, batch=batch, train=True,
                       rng=SampleKey(step=0))
        detector.loss_from_outputs(out, batch)
        with torch.no_grad():
            detector.bboxes_from_outputs(detector(images))
    seen = {e.key for e in prof.key_averages()
            if e.key.startswith('two_stage.')}
    assert set(chip_smoke.HBB_SAMPLERS) - seen == {'two_stage.sample_rois'}
    assert {'two_stage.roialign_head_0', 'two_stage.roialign_head_1',
            'two_stage.roi_pool_0', 'two_stage.roi_pool_1'} <= seen


def test_phase_hbb_loops_rehearsal(tmp_path):
    from orientedobjectdetection_torch.tools.generate_synth import \
        generate_synth
    root = str(tmp_path / 'tiny')
    generate_synth(root, 4, 128, seed=0)
    configs = {k: derived_config(tmp_path, v, TINY_FAMILY)
               for k, v in chip_smoke.HBB_TINY_CONFIGS.items()}
    runs, inputs = chip_smoke.phase_hbb_loops(
        root, str(tmp_path / 'work'), configs=configs, steps=2,
        dtype=torch.float32, device='cpu', log_interval=1)
    assert runs == [NO_LAUNCHES] * 3
    for label, assigns in chip_smoke.HBB_ASSIGNS.items():
        assert len(inputs[f'{label}_loop_assign']) == 2 * assigns
        pools = inputs[f'{label}_loop_roi_align']
        assert len(pools) == chip_smoke.HBB_POOLS[label]  # one eval batch
        assert pools[0][2] == (1 if label == 'faster' else 2)
        assert inputs[f'{label}_loop_nms']


# ---- phases 35-38 at a tiny size: the Swin, ConvNeXt and ReDet configs cut
# narrow (a 16-dim Swin of depths 2, a ConvNeXt of dims 16-64 added to the
# port's ARCHS, ReResNet-18) at 128 px
TINY_TWO_STAGE = '''
    train_cfg=dict(rpn_proposal=dict(nms_pre=128, max_per_img=64)),
    test_cfg=dict(rpn=dict(nms_pre=128, max_per_img=64)))
'''
TINY_BACKBONES = {
    'swin': '''
model = dict(
    backbone=dict(embed_dims=16, depths=[2, 2, 2, 2], num_heads=[1, 2, 2, 4]),
    neck=dict(in_channels=[16, 32, 64, 128]),''' + TINY_TWO_STAGE,
    'convnext': '''
model = dict(
    backbone=dict(arch='narrow'),
    neck=dict(in_channels=[16, 32, 48, 64], out_channels=32),
    bbox_head=dict(in_channels=32, feat_channels=32, stacked_convs=1),
    test_cfg=dict(nms_pre=64, max_candidates=64, max_per_img=50))
''',
    'redet': '''
model = dict(
    backbone=dict(depth=18),''' + TINY_TWO_STAGE,
}


@pytest.fixture
def tiny_backbones(tmp_path, monkeypatch):
    """The phases' configs replaced by narrow copies."""
    from orientedobjectdetection_torch.models.backbones import convnext
    monkeypatch.setitem(convnext.ARCHS, 'narrow', dict(
        depths=(1, 1, 2, 1), dims=(16, 32, 48, 64)))
    configs = {k: derived_config(tmp_path, v, TINY_BACKBONES[k])
               for k, v in chip_smoke.BACKBONE_CONFIGS.items()}
    monkeypatch.setattr(chip_smoke, 'BACKBONE_CONFIGS', configs)
    return configs


def test_phase_backbone_slice_rehearsal(tiny_backbones):
    captured = chip_smoke.phase_backbone_slice('cpu', bsz=1, size=128, g=8,
                                               valid=3, max_num=64,
                                               max_candidates=64)
    for label in ('swin', 'redet'):
        (levels, rois, ratio), = captured[f'{label}_slice_roi']
        assert rois.shape == (1, 64, 5) and ratio == 2
        assert levels[0].shape[-1] == 256      # ReFPN: 32 fields x 8
        (boxes, cls), = captured[f'{label}_slice_nms']
        assert boxes.shape[-1] == 5
        calls = captured[f'{label}_slice_assign']
        assert len(calls) == 2 and calls[-1][1].dim() == 2
    assert 'convnext_slice_assign' not in captured


def test_phase_backbone_serving_rehearsal(tiny_backbones):
    runs, captured = chip_smoke.phase_backbone_serving(
        'cpu', bsz=1, size=128, warm=1, timed=1, dtype=torch.float32,
        max_num=64, max_candidates=64)
    assert runs == [NO_LAUNCHES] * 3
    assert len(captured['swin_roi']) == len(captured['redet_roi']) == 1
    assert 'convnext_roi' not in captured
    for label in chip_smoke.BACKBONE_CONFIGS:
        assert captured[label][0].shape[-1] == 5


def test_phase_backbone_training_rehearsal(tiny_backbones):
    steps = {k: (2, 6) for k in chip_smoke.BACKBONE_CONFIGS}
    runs, captured = chip_smoke.phase_backbone_training(
        'cpu', bsz=1, size=128, g=8, valid=3, dtype=torch.float32,
        padded_g=16, padded_valid=5, steps=steps)
    assert runs == [NO_LAUNCHES] * 3
    for label, assigns in chip_smoke.BACKBONE_ASSIGNS.items():
        calls = captured[f'{label}_train']
        assert len(calls) == assigns
        assert captured[f'{label}_train_padded'][0][0].shape[-2] == 16


def test_module_ranges_split_a_request_and_come_off():
    """The profiled modules run inside their ``module.*`` ranges while the
    context is open, ReDet's roll inside the RoI head's, and the class's
    forward is back afterwards."""
    from torch.profiler import profile
    from orientedobjectdetection_torch.models import build_detector
    from orientedobjectdetection_torch.utils import Config
    detector = build_detector(dict(Config.fromfile(
        chip_smoke.REDET_TINY_CONFIGS['redet']).model))
    detector.init_weights(0)
    with profile() as prof, torch.no_grad(), \
            chip_smoke.module_ranges(detector):
        detector(torch.randn(1, 3, 64, 64))
    seen = {e.key for e in prof.key_averages()}
    assert {'module.backbone', 'module.neck', 'module.rpn_head',
            'module.roi_head', 'two_stage.ri_roll'} <= seen
    assert 'forward' not in vars(detector.backbone)


def test_phase_redet_loop_rehearsal(tmp_path):
    from orientedobjectdetection_torch.tools.generate_synth import \
        generate_synth
    root = str(tmp_path / 'tiny')
    generate_synth(root, 4, 128, seed=0)
    configs = {k: derived_config(tmp_path, v, TINY_FAMILY)
               for k, v in chip_smoke.REDET_TINY_CONFIGS.items()}
    runs, inputs = chip_smoke.phase_redet_loop(
        root, str(tmp_path / 'work'), configs=configs, steps=2,
        dtype=torch.float32, device='cpu', log_interval=1)
    assert runs == [NO_LAUNCHES]
    assert len(inputs['redet_loop_assign']) == 4
    (levels, rois, ratio), = inputs['redet_loop_roi_align']
    assert levels[0].shape[-1] == 64 and ratio == 2
    assert inputs['redet_loop_nms']
