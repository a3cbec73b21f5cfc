"""The port's CUDA kernels on the card, against their plain versions.

Marked ``gpu``: each test asks for the ``cuda`` fixture, which skips when no
CUDA device is present. This file imports no JAX, so on a machine with a
card and without JAX it runs as
``python -m pytest tests/test_torch_gpu.py -m gpu --noconftest``.
"""

import numpy as np
import pytest
import torch

from orientedobjectdetection_torch.apis import DetectorBundle, init_detector
from orientedobjectdetection_torch.core import MaxIoUAssigner
from orientedobjectdetection_torch.ops.iou import rbbox_overlaps
from orientedobjectdetection_torch.ops.iou_kernels import (
    box_iou_rotated_matrix, box_iou_rotated_matrix_plain, nms_pair_mask,
    nms_pair_mask_plain, pair_iou)
from orientedobjectdetection_torch.utils import Config

pytestmark = pytest.mark.gpu

BAND = 2e-3
IOU_ATOL = 2e-5      # sincosf and FMA contraction against torch.sin / cos


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def sorted_inputs(bsz, n, seed, num_classes=3):
    rng = np.random.default_rng(seed)
    boxes = np.stack([rng.uniform(0, 200, (bsz, n)),
                      rng.uniform(0, 200, (bsz, n)),
                      rng.uniform(4, 60, (bsz, n)),
                      rng.uniform(4, 60, (bsz, n)),
                      rng.uniform(-np.pi / 2, np.pi / 2, (bsz, n))],
                     -1).astype(np.float32)
    cls = np.sort(rng.integers(0, num_classes, (bsz, n)), -1)
    return torch.from_numpy(boxes), torch.from_numpy(cls.astype(np.int32))


@pytest.mark.parametrize('bsz,n', [(1, 1), (3, 100), (2, 129), (4, 640)])
@pytest.mark.parametrize('with_cls', [False, True])
def test_pair_mask_kernel_matches_plain(cuda, bsz, n, with_cls):
    boxes, cls = sorted_inputs(bsz, n, n)
    boxes = boxes.to(cuda)
    cls = cls.to(cuda) if with_cls else None
    before = nms_pair_mask.launches
    got = nms_pair_mask(boxes, 0.1, cls)
    torch.cuda.synchronize()
    assert nms_pair_mask.launches == before + 1
    assert got.dtype == torch.uint8 and got.shape == (bsz, n, n)
    ref = nms_pair_mask_plain(boxes, 0.1, cls)
    band = (pair_iou(boxes) - 0.1).abs() < BAND
    assert torch.equal(got[~band], ref[~band])
    assert not got.tril().any()


def test_pair_mask_rejects_mixed_devices(cuda):
    boxes, cls = sorted_inputs(1, 16, 0)
    with pytest.raises(ValueError):
        nms_pair_mask(boxes.to(cuda), 0.1, cls)


def small_cfg():
    anchor = dict(type='RotatedAnchorGenerator', octave_base_scale=4,
                  scales_per_octave=3, ratios=[1.0, 0.5, 2.0],
                  strides=[8, 16, 32, 64, 128])
    coder = dict(type='DeltaXYWHAOBBoxCoder', angle_range='le90',
                 norm_factor=None, edge_swap=True, proj_xy=True)
    return Config(dict(model=dict(
        type='RotatedRetinaNet',
        backbone=dict(type='ResNet', depth=18),
        neck=dict(type='FPN', in_channels=[64, 128, 256, 512],
                  out_channels=32, start_level=1,
                  add_extra_convs='on_input', num_outs=5),
        bbox_head=dict(type='RotatedRetinaHead', num_classes=4,
                       in_channels=32, feat_channels=32, stacked_convs=1,
                       anchor_generator=anchor, bbox_coder=coder),
        test_cfg=dict(nms_pre=2000, score_thr=0.05, nms=dict(iou_thr=0.1),
                      max_per_img=300, max_candidates=512))))


def test_small_slice_kernel_equals_plain(cuda):
    """A small detector on the card: the same head outputs decoded with the
    kernel and with the plain pair mask give the same detections."""
    bundle = init_detector(small_cfg(), device=cuda, seed=1)
    head = bundle.detector.bbox_head
    with torch.no_grad():
        head.retina_cls.bias.zero_()        # scores above score_thr
        head.retina_reg.weight.mul_(0.05)   # boxes near their anchors
    plain = DetectorBundle(bundle.cfg, bundle.detector, plain_pair_mask=True)
    images = torch.from_numpy(np.random.default_rng(2).normal(
        0, 1, (2, 256, 256, 3)).astype(np.float32))
    outputs = bundle.forward(images)
    before = nms_pair_mask.launches
    dets, labels, valid = bundle.decode(outputs)
    assert nms_pair_mask.launches == before + 1
    p_dets, p_labels, p_valid = plain.decode(outputs)
    assert nms_pair_mask.launches == before + 1
    assert valid.sum() > 20
    assert torch.equal(valid, p_valid) and torch.equal(labels, p_labels)
    assert (dets - p_dets).abs().max() <= 1e-3


def random_boxes(shape, seed, extent=400.0):
    rng = np.random.default_rng(seed)
    boxes = np.stack([rng.uniform(0, extent, shape),
                      rng.uniform(0, extent, shape),
                      rng.uniform(2, 80, shape), rng.uniform(2, 80, shape),
                      rng.uniform(-np.pi, np.pi, shape)], -1)
    return torch.from_numpy(boxes.astype(np.float32))


@pytest.mark.parametrize('shape1,shape2', [
    ((1,), (1,)), ((7,), (1000,)), ((1000,), (7,)), ((3, 33), (777,)),
    ((777,), (3, 33)), ((2, 65), (2, 300)), ((300,), (300,))])
@pytest.mark.parametrize('mode', ['iou', 'iof'])
def test_iou_matrix_kernel_matches_plain(cuda, shape1, shape2, mode):
    """Either set may be the longer one (the kernel then writes the
    transposed buffer) and either may be batched."""
    b1 = random_boxes(shape1, 1).to(cuda)
    b2 = random_boxes(shape2, 2).to(cuda)
    b2[..., 0, :] = b1.reshape(-1, 5)[0]            # an identical pair
    b1[..., -1, 2:4] = 0.0                          # a zero-size box
    before = box_iou_rotated_matrix.launches
    got = box_iou_rotated_matrix(b1, b2, mode)
    torch.cuda.synchronize()
    assert box_iou_rotated_matrix.launches == before + 1
    ref = box_iou_rotated_matrix_plain(b1, b2, mode)
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max() <= IOU_ATOL
    assert (got[..., -1, :] == 0).all()             # zero box: exact 0


def test_iou_matrix_wrapper_contract(cuda):
    b = random_boxes((16,), 3)
    with pytest.raises(ValueError):
        box_iou_rotated_matrix(b.to(cuda), b)       # mixed devices
    with pytest.raises(ValueError):
        box_iou_rotated_matrix(b.to(cuda)[:, :4], b.to(cuda))
    before = box_iou_rotated_matrix.launches
    empty = box_iou_rotated_matrix(b.to(cuda)[:0].contiguous(), b.to(cuda))
    assert empty.shape == (0, 16)
    assert box_iou_rotated_matrix.launches == before   # nothing to launch
    # rbbox_overlaps always takes the kernel on the card, whatever the size
    rbbox_overlaps(b.to(cuda)[:2], b.to(cuda)[:3])
    assert box_iou_rotated_matrix.launches == before + 1
    # ... except for inputs that need a gradient
    rbbox_overlaps(b.to(cuda).requires_grad_(), b.to(cuda)).sum().backward()
    assert box_iou_rotated_matrix.launches == before + 1


def test_max_ties_go_to_the_lowest_index_on_the_card(cuda):
    x = torch.zeros((2, 5, 1000), device=cuda)
    x[:, 2:4] = 0.7
    assert (x.max(dim=1).indices == 2).all()
    assert (x.max(dim=2).indices == 0).all()


def test_assigner_kernel_equals_plain(cuda):
    """One batched assignment on grid anchors: the kernel's matrix and the
    plain one give the same assignment away from the thresholds."""
    from orientedobjectdetection_torch.core import RotatedAnchorGenerator
    gen = RotatedAnchorGenerator(octave_base_scale=4, scales_per_octave=3,
                                 ratios=[1.0, 0.5, 2.0],
                                 strides=[8, 16, 32, 64, 128])
    anchors = torch.cat(gen.grid_priors(
        [(-(-256 // s), -(-256 // s)) for s in (8, 16, 32, 64, 128)],
        device=cuda), 0)
    rng = np.random.default_rng(4)
    gts = torch.zeros((3, 8, 5), device=cuda)
    pick = torch.from_numpy(rng.choice(len(anchors), 3 * 5)).to(cuda)
    gts[:, :5] = anchors[pick].reshape(3, 5, 5)
    gts[:, :5, :2] += 2.5
    gts[:, :5, 4] = 0.2
    labels = torch.from_numpy(rng.integers(0, 4, (3, 8))).to(cuda)
    mask = (torch.arange(8, device=cuda) < 5)[None].repeat(3, 1)
    cfg = dict(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0,
               match_low_quality=False)
    before = box_iou_rotated_matrix.launches
    got = MaxIoUAssigner(**cfg)(anchors, gts, labels, mask)
    assert box_iou_rotated_matrix.launches == before + 1
    ref = MaxIoUAssigner(plain_iou=True, **cfg)(anchors, gts, labels, mask)
    assert box_iou_rotated_matrix.launches == before + 1
    band = ((ref.max_overlaps - 0.4).abs() < 1e-5) | \
        ((ref.max_overlaps - 0.5).abs() < 1e-5)
    assert torch.equal(got.assigned_gt_inds[~band],
                       ref.assigned_gt_inds[~band])
    assert torch.equal(got.labels[~band], ref.labels[~band])
    assert (got.assigned_gt_inds >= 0).any()
    assert (got.max_overlaps - ref.max_overlaps).abs().max() <= IOU_ATOL
