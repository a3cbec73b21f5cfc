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
    nms_pair_mask_plain, pair_iou, pairs_in_reach)
from orientedobjectdetection_torch.ops.roi_align_kernels import (
    roi_align_rotated_pyramid, roi_align_rotated_pyramid_plain, vector_path)
from orientedobjectdetection_torch.utils import Config

pytestmark = pytest.mark.gpu

BAND = 2e-3
IOU_ATOL = 2e-5      # sincosf and FMA contraction against torch.sin / cos
# RoIAlign against its plain version, per element: ROI_RTOL x max |feature|,
# since bilinear interpolation is continuous in the sample coordinates, which
# sincosf and FMA contraction move by ~1e-4 cells; bfloat16 adds one rounding
# step of that element, at most 2^-7 of its own magnitude
ROI_RTOL = 2e-4
ROI_BF16_STEP = {torch.float32: 0.0, torch.bfloat16: 2 ** -7}
ROI_SCALES = (1 / 4, 1 / 8, 1 / 16, 1 / 32)


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


def check_pair_mask(boxes, cls, thr=0.1):
    """One launch; equal to the plain version outside the band; nothing on
    or below the diagonal; nothing where the reject applies."""
    before = nms_pair_mask.launches
    got = nms_pair_mask(boxes, thr, cls)
    torch.cuda.synchronize()
    assert nms_pair_mask.launches == before + 1
    n = boxes.shape[1]
    assert got.dtype == torch.uint8 and got.shape == (boxes.shape[0], n, n)
    ref = nms_pair_mask_plain(boxes, thr, cls)
    band = (pair_iou(boxes) - thr).abs() < BAND
    assert torch.equal(got[~band], ref[~band])
    assert not got.tril().any()
    assert not got[~pairs_in_reach(boxes, boxes)].any()
    return got


def dense_inputs(bsz, n, seed, classes):
    """Boxes crowded enough to overlap at any N, with class ids: 'none'
    (``class_ids=None``), 'one', 'fifteen' (sorted, class-major) or
    'unsorted' (15 classes in random order: the tile skip may only
    prune)."""
    rng = np.random.default_rng(seed)
    extent = 40.0 * np.sqrt(n) + 50.0
    boxes = np.stack([rng.uniform(0, extent, (bsz, n)),
                      rng.uniform(0, extent, (bsz, n)),
                      rng.uniform(4, 60, (bsz, n)),
                      rng.uniform(4, 60, (bsz, n)),
                      rng.uniform(-np.pi / 2, np.pi / 2, (bsz, n))],
                     -1).astype(np.float32)
    cls = {'none': None, 'one': np.zeros((bsz, n)),
           'fifteen': np.sort(rng.integers(0, 15, (bsz, n)), -1),
           'unsorted': rng.integers(0, 15, (bsz, n))}[classes]
    return (torch.from_numpy(boxes),
            None if cls is None else torch.from_numpy(cls.astype(np.int32)))


@pytest.mark.parametrize('n', [1, 63, 64, 65, 300, 2000])
@pytest.mark.parametrize('classes', ['none', 'one', 'fifteen', 'unsorted'])
def test_pair_mask_sizes_and_class_orders(cuda, n, classes):
    """N below, at and above one 64-row band, N % 16 == 0 (16-byte stores),
    N % 4 == 0 (4-byte stores) and odd N (byte stores)."""
    boxes, cls = dense_inputs(2, n, n + len(classes), classes)
    got = check_pair_mask(boxes.to(cuda), None if cls is None
                          else cls.to(cuda))
    if n >= 64:
        assert got.any()                    # the case suppresses something


def special_boxes(case):
    """(1, N, 5) boxes and (1, N) sorted class ids of one kind."""
    rng = np.random.default_rng(len(case))
    if case == 'coincident':           # every box twice, and one 5 times
        one = rng.uniform(0, 200, (60, 5)).astype(np.float32)
        one[:, 2:4] = rng.uniform(4, 40, (60, 2))
        boxes = np.concatenate([one, one, np.repeat(one[:1], 5, 0)])
    elif case == 'touching':           # a grid of squares sharing edges
        xs, ys = np.meshgrid(np.arange(12) * 10.0, np.arange(10) * 10.0)
        boxes = np.stack([xs.ravel(), ys.ravel(), np.full(120, 10.0),
                          np.full(120, 10.0), np.zeros(120)], -1)
        boxes[::7, 4] = np.pi / 2      # the same square, turned
    elif case == 'reach_edge':         # pairs 0.01 inside / outside reach
        rows = []
        for k in range(80):
            w, h = rng.uniform(4, 60, 2)
            step = w + h + (0.01 if k % 2 else -0.01)
            axis = np.array([step, 0.0] if k % 4 < 2 else [0.0, step])
            base = np.array([300.0 * (k % 10), 300.0 * (k // 10)])
            rows.append([*base, w, h, rng.uniform(-np.pi, np.pi)])
            rows.append([*(base + axis), w, h, rng.uniform(-np.pi, np.pi)])
        boxes = np.asarray(rows)
    else:                              # 'zero_padding'
        real = rng.uniform(0, 150, (100, 5))
        real[:, 2:4] = rng.uniform(4, 40, (100, 2))
        boxes = np.concatenate([real, np.zeros((100, 5))])
        boxes[100:110, 2] = 5.0        # zero area, one side not zero
    n = len(boxes)
    cls = np.zeros(n, np.int32)
    if case == 'zero_padding':
        cls[100:] = 15                 # padding sorts behind every class
    return (torch.from_numpy(boxes.astype(np.float32))[None],
            torch.from_numpy(cls)[None])


@pytest.mark.parametrize('case', ['coincident', 'touching', 'reach_edge',
                                  'zero_padding'])
def test_pair_mask_special_boxes(cuda, case):
    boxes, cls = special_boxes(case)
    boxes, cls = boxes.to(cuda), cls.to(cuda)
    got = check_pair_mask(boxes, cls)
    keep = pairs_in_reach(boxes, boxes)
    if case == 'coincident':
        assert got[0, :60, 60:120].diagonal().all()   # each with its twin
    if case == 'reach_edge':
        inside = keep[0, 0::2, 1::2].diagonal()
        assert inside.tolist() == [k % 2 == 0 for k in range(80)]
    if case == 'zero_padding':
        assert not got[0, 100:].any() and not got[0, :, 100:].any()
        assert got[0, :100, :100].any()


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


def test_kernel_functions_are_resolved_once(cuda):
    """Both wrappers take their C entry point, with its argument types,
    from one cache: built and typed at the first call only."""
    from orientedobjectdetection_torch.ops import iou_kernels as ik
    box_iou_rotated_matrix(random_boxes((4,), 1).to(cuda),
                           random_boxes((9,), 2).to(cuda))
    nms_pair_mask(sorted_inputs(1, 8, 0)[0].to(cuda), 0.1)
    for name, args in ((ik.MATRIX_KERNEL, ik.MATRIX_ARGS),
                       (ik.KERNEL, ik.PAIR_MASK_ARGS)):
        fn = ik.kernel_function(name, args)
        assert fn is ik._FUNCTIONS[name] and fn.argtypes == args


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


def check_iou_matrix(boxes1, boxes2, mode):
    """One launch; within IOU_ATOL of the plain version; exactly 0 where
    ``pairs_in_reach`` rejects the pair. Returns the pairs in reach."""
    before = box_iou_rotated_matrix.launches
    got = box_iou_rotated_matrix(boxes1, boxes2, mode)
    torch.cuda.synchronize()
    assert box_iou_rotated_matrix.launches == before + 1
    ref = box_iou_rotated_matrix_plain(boxes1, boxes2, mode)
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max() <= IOU_ATOL
    live = pairs_in_reach(boxes1, boxes2).expand_as(got)
    assert (got[~live] == 0).all() and (ref[~live] == 0).all()
    return live


def grid_anchors(size, device):
    from orientedobjectdetection_torch.core import RotatedAnchorGenerator
    gen = RotatedAnchorGenerator(octave_base_scale=4, scales_per_octave=3,
                                 ratios=[1.0, 0.5, 2.0],
                                 strides=[8, 16, 32, 64, 128])
    return torch.cat(gen.grid_priors(
        [(-(-size // s), -(-size // s)) for s in (8, 16, 32, 64, 128)],
        device=device), 0)


@pytest.mark.parametrize('n', [1, 3, 5, 255, 4099, 4100, 4111])
@pytest.mark.parametrize('g', [1, 33])
@pytest.mark.parametrize('mode', ['iou', 'iof'])
def test_iou_matrix_column_counts(cuda, n, g, mode):
    """N below one chunk of 16 columns, not a multiple of 4 (the scalar
    store path) and a multiple of 4 (16-byte stores); G of one row and of
    two row tiles. Where G > N the gts are the columns."""
    boxes = random_boxes((n,), n, extent=150.0).to(cuda)
    gts = random_boxes((2, g), g + 7, extent=150.0).to(cuda)
    gts[:, 0] = boxes[0]                            # an identical pair
    live = check_iou_matrix(gts, boxes, mode)
    assert live.any()


@pytest.mark.parametrize('mode', ['iou', 'iof'])
def test_iou_matrix_loader_padding(cuda, mode):
    """G = 512 as the loader pads it: 20 gts per image near anchors, 492
    zero rows at the origin, which reach nothing."""
    anchors = grid_anchors(256, cuda)
    rng = np.random.default_rng(5)
    gts = torch.zeros((3, 512, 5), device=cuda)
    pick = torch.from_numpy(rng.choice(len(anchors), 60)).to(cuda)
    gts[:, :20] = anchors[pick].reshape(3, 20, 5)
    gts[:, :20, :2] += 1.5
    gts[:, :20, 4] = 0.3
    b1, b2 = (gts, anchors) if mode == 'iou' else (anchors, gts)
    live = check_iou_matrix(b1, b2, mode)
    padded = live[:, 20:] if mode == 'iou' else live[:, :, 20:]
    assert not padded.any() and live.any()


def test_iou_matrix_every_pair_in_reach(cuda):
    """32 large gts over a 256 px image: every pair of every block is in
    reach, so each block clips all 32 x 256 of its pairs."""
    anchors = grid_anchors(256, cuda)
    rng = np.random.default_rng(6)
    gts = torch.from_numpy(np.stack([
        rng.uniform(100, 156, 32), rng.uniform(100, 156, 32),
        rng.uniform(300, 600, 32), rng.uniform(300, 600, 32),
        rng.uniform(-np.pi, np.pi, 32)], -1).astype(np.float32))
    live = check_iou_matrix(gts.to(cuda)[None].repeat(2, 1, 1), anchors,
                            'iou')
    assert live.all()


@pytest.mark.parametrize('gts_first', [True, False])
def test_iou_matrix_zero_boxes_at_the_origin(cuda, gts_first):
    """Zero boxes at the origin among 512-px anchors around it: in reach by
    their centres, rejected by their area, so exactly 0."""
    xs, ys = np.meshgrid(np.arange(-256.0, 257.0, 32.0),
                         np.arange(-256.0, 257.0, 32.0))
    anchors = torch.from_numpy(np.stack(
        [xs.ravel(), ys.ravel(), np.full(xs.size, 512.0),
         np.full(xs.size, 362.0), np.full(xs.size, 0.5)],
        -1).astype(np.float32)).to(cuda)
    gts = torch.zeros((2, 40, 5), device=cuda)
    gts[:, 0] = torch.tensor([5.0, -7.0, 40.0, 20.0, 0.2], device=cuda)
    b1, b2 = (gts, anchors) if gts_first else (anchors, gts)
    live = check_iou_matrix(b1, b2, 'iou' if gts_first else 'iof')
    assert live.sum() == 2 * len(anchors)           # the one real box


@pytest.mark.parametrize('n', [1, 33, 264, 2032, 4099])
@pytest.mark.parametrize('mode', ['iou', 'iof'])
def test_iou_matrix_per_image_columns(cuda, n, mode):
    """Each image's own column set (``cols_batched``), the RoI assigner's
    layout: each image's padded gts (8 valid of 32) against its proposals,
    which start with its gts (N = 2032: 2000 proposals and 32 gts), w and h
    clamped to 1e-3 as ``rbbox_overlaps`` does. IoU is the assigner's mode.
    IoF, over the first set's area, takes the proposals first (the ignore
    regions' form): over a padded 1e-3 x 1e-3 box it is ill-conditioned in
    both versions, the pair frame's coordinates being 1e4 times its sides.
    Each image's slice equals that image's own unbatched matrix."""
    from orientedobjectdetection_torch.ops.iou import _clamp_wh
    rng = np.random.default_rng(n)
    gts = random_boxes((3, 32), n + 1, extent=300.0)
    gts[:, 8:] = 0.0                                # padding
    props = random_boxes((3, n), n + 2, extent=300.0)
    near = gts[:, rng.integers(0, 8, n)].clone()
    near[..., :2] += torch.from_numpy(rng.normal(0, 3, (3, n, 2)).astype(
        np.float32))
    props = torch.where(torch.from_numpy(rng.uniform(size=(3, n, 1)) < 0.5),
                        near, props)
    first = min(n, 32 if mode == 'iou' else 8)      # the gts come first
    props[:, :first] = gts[:, :first]
    gts, props = _clamp_wh(gts).to(cuda), _clamp_wh(props).to(cuda)
    pair = (gts, props) if mode == 'iou' else (props, gts)
    live = check_iou_matrix(*pair, mode)
    assert live.any()
    got = box_iou_rotated_matrix(*pair, mode)
    for b in range(3):
        one = box_iou_rotated_matrix(pair[0][b].contiguous(),
                                     pair[1][b].contiguous(), mode)
        assert torch.equal(one, got[b])


def test_small_two_stage_train_step_kernel_equals_plain(cuda):
    """A small Oriented R-CNN train step on the card, from one seeded state
    and rng: with the kernel in both assigners (two launches), in neither,
    and in the RoI head's only. The RoI head's kernel gives the plain run's
    sampled RoIs, labels, targets and all four losses; the RPN's assigns
    as the plain matrix does except within 1e-5 of a threshold or of a
    gt's best IoU, where rounding breaks ties either way
    (``chip_smoke.check_assigner``)."""
    import os.path as osp

    from chip_smoke import check_assigner
    from orientedobjectdetection_torch.core import SampleKey
    from orientedobjectdetection_torch.models import build_detector
    from orientedobjectdetection_torch.ops.boxes import obb2hbb
    cfg = Config.fromfile(osp.join(
        osp.dirname(__file__), '..', 'configs', 'oriented_rcnn',
        'oriented_rcnn_tiny_synth.py'))
    rng = np.random.default_rng(3)
    gts = np.zeros((2, 16, 5), np.float32)
    gts[:, :5] = np.stack([rng.uniform(40, 216, (2, 5)),
                           rng.uniform(40, 216, (2, 5)),
                           rng.uniform(16, 80, (2, 5)),
                           rng.uniform(16, 80, (2, 5)),
                           rng.uniform(-1.5, 1.5, (2, 5))], -1)
    batch = dict(gt_bboxes=torch.from_numpy(gts).to(cuda),
                 gt_labels=torch.from_numpy(rng.integers(0, 2, (2, 16))).to(
                     cuda),
                 gt_mask=(torch.arange(16) < 5).repeat(2, 1).to(cuda))
    images = torch.from_numpy(rng.normal(0, 1, (2, 3, 256, 256)).astype(
        np.float32)).to(cuda)
    runs = {}
    for name, plain_rpn, plain_roi in (('kernels', False, False),
                                       ('plain', True, True),
                                       ('roi kernel', True, False)):
        det = build_detector(dict(cfg.model))
        det.init_weights(4)
        det.to(cuda)
        det.rpn_head.assigner.plain_iou = plain_rpn
        det.roi_head.assigner.plain_iou = plain_roi
        before = box_iou_rotated_matrix.launches
        outputs = det(images, batch=batch, train=True, rng=SampleKey(step=2))
        losses = det.loss_from_outputs(outputs, batch)
        torch.cuda.synchronize()
        assert box_iou_rotated_matrix.launches == \
            before + (not plain_rpn) + (not plain_roi)
        runs[name] = (outputs, {k: float(v.detach())
                                for k, v in losses.items()})
    ref, ref_losses = runs['plain']
    for name in ('kernels', 'roi kernel'):
        got = runs[name][0]
        for k in ('rois', 'labels', 'label_weights', 'bbox_weights'):
            assert torch.equal(got[k], ref[k]), (name, k)
        assert (got['bbox_targets'] - ref['bbox_targets']).abs().max() \
            <= 1e-5
    assert ref['bbox_weights'].sum() > 0
    for k, v in ref_losses.items():
        assert abs(runs['roi kernel'][1][k] - v) <= 1e-4 * abs(v), k
    sizes = [(256 // s, 256 // s) for s in (4, 8, 16, 32, 64)]
    anchors = det.rpn_head.train_anchors(sizes, cuda)[1]
    positives = check_assigner(
        det.rpn_head.assigner, anchors,
        obb2hbb(batch['gt_bboxes'], det.rpn_head.version),
        torch.zeros_like(batch['gt_labels']), batch['gt_mask'])[0]
    assert positives > 0


def test_iou_matrix_misaligned_columns(cuda):
    """A column set that starts 20 bytes into its storage takes the scalar
    loads and gives the same matrix as an aligned copy of it."""
    base = grid_anchors(256, cuda)
    view = base[1:]                                 # contiguous, misaligned
    assert view.data_ptr() % 16 != 0
    gts = random_boxes((2, 9), 8, extent=256.0).to(cuda)
    check_iou_matrix(gts, view, 'iou')
    assert torch.equal(box_iou_rotated_matrix(gts, view),
                       box_iou_rotated_matrix(gts, view.clone()))


def roi_case(bsz, r, size, channels, dtype, seed, device):
    """RoIs on all four levels, elongated, giant, over the edge and
    zero-size (the last eighth), with normal features."""
    rng = np.random.default_rng(seed)
    side = np.exp(rng.uniform(np.log(16.0), np.log(1.2 * size), (bsz, r)))
    aspect = np.exp(rng.uniform(-2.2, 2.2, (bsz, r)))
    rois = np.stack([rng.uniform(-0.05 * size, 1.05 * size, (bsz, r)),
                     rng.uniform(-0.05 * size, 1.05 * size, (bsz, r)),
                     side * np.sqrt(aspect), side / np.sqrt(aspect),
                     rng.uniform(-np.pi / 2, np.pi / 2, (bsz, r))], -1)
    rois[:, 0] = [size / 2, size / 2, 600.0, 500.0, 0.7]
    rois[:, -max(r // 8, 1):] = 0.0
    feats = [torch.from_numpy(rng.normal(
        size=(bsz, -(-size // s), -(-size // s), channels)
    ).astype(np.float32)).to(device=device, dtype=dtype)
        for s in (4, 8, 16, 32)]
    return feats, torch.from_numpy(rois.astype(np.float32)).to(device)


@pytest.mark.parametrize('bsz,r,size,channels', [
    (1, 1, 64, 1), (2, 37, 200, 64), (3, 100, 256, 48), (2, 64, 512, 256),
    (1, 16, 128, 300)])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('clockwise', [False, True])
def test_roi_align_kernel_matches_plain(cuda, bsz, r, size, channels, dtype,
                                        clockwise):
    """Channel counts below, at and above the block's 256 threads, and not
    a multiple of 32."""
    feats, rois = roi_case(bsz, r, size, channels, dtype, r, cuda)
    args = (feats, rois, (7, 7), ROI_SCALES, 2, 56.0, clockwise)
    before = roi_align_rotated_pyramid.launches
    got = roi_align_rotated_pyramid(*args)
    torch.cuda.synchronize()
    assert roi_align_rotated_pyramid.launches == before + 1
    ref = roi_align_rotated_pyramid_plain(*args)
    assert roi_align_rotated_pyramid.launches == before + 1
    assert got.shape == (bsz, r, 7, 7, channels) and got.dtype == dtype
    assert torch.isfinite(got).all()
    scale = max(float(f.abs().max()) for f in feats)
    allowed = ROI_RTOL * scale + ROI_BF16_STEP[dtype] * ref.float().abs()
    assert ((got.float() - ref.float()).abs() <= allowed).all()
    assert not got[:, -max(r // 8, 1):].any()       # padding: exact zeros
    if r > 1:
        assert got[:, 0].abs().max() > 0            # the giant RoI pooled


@pytest.mark.parametrize('dtype,channels,vector', [
    (torch.bfloat16, 8, True), (torch.bfloat16, 256, True),
    (torch.bfloat16, 300, False), (torch.float32, 4, True),
    (torch.float32, 300, True), (torch.float32, 6, False)])
@pytest.mark.parametrize('bsz,r', [(1, 13), (3, 29)])
def test_roi_align_vector_and_scalar_paths(cuda, dtype, channels, vector,
                                           bsz, r):
    """Both paths in both types; RoI counts that are not a multiple of the
    RoIs per block (8 for bfloat16 and 4 for float32 at C = 256)."""
    feats, rois = roi_case(bsz, r, 256, channels, dtype, r + channels, cuda)
    assert vector_path(feats) is vector
    args = (feats, rois, (7, 7), ROI_SCALES, 2, 56.0, False)
    before = roi_align_rotated_pyramid.launches
    got = roi_align_rotated_pyramid(*args)
    torch.cuda.synchronize()
    assert roi_align_rotated_pyramid.launches == before + 1
    ref = roi_align_rotated_pyramid_plain(*args)
    assert got.shape == (bsz, r, 7, 7, channels) and got.dtype == dtype
    scale = max(float(f.abs().max()) for f in feats)
    allowed = ROI_RTOL * scale + ROI_BF16_STEP[dtype] * ref.float().abs()
    assert ((got.float() - ref.float()).abs() <= allowed).all()
    assert not got[:, -max(r // 8, 1):].any()       # padding: exact zeros
    assert got[:, :-max(r // 8, 1)].abs().max() > 0


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_roi_align_misaligned_level_takes_the_scalar_path(cuda, dtype):
    """A level that is a view one element into its storage is not 16-byte
    aligned: the wrapper takes the scalar path (it does not raise), which
    gives the vector path's values."""
    feats, rois = roi_case(2, 21, 256, 64, dtype, 9, cuda)
    storage = torch.empty(feats[1].numel() + 1, dtype=dtype, device=cuda)
    shifted = storage[1:].view(feats[1].shape)
    shifted.copy_(feats[1])
    moved = [feats[0], shifted] + feats[2:]
    assert vector_path(feats) and not vector_path(moved)
    args = ((7, 7), ROI_SCALES, 2, 56.0)
    vec = roi_align_rotated_pyramid(feats, rois, *args)
    scalar = roi_align_rotated_pyramid(moved, rois, *args)
    ref = roi_align_rotated_pyramid_plain(feats, rois, *args)
    torch.cuda.synchronize()
    assert torch.equal(scalar, vec)
    scale = max(float(f.abs().max()) for f in feats)
    allowed = ROI_RTOL * scale + ROI_BF16_STEP[dtype] * ref.float().abs()
    assert ((scalar.float() - ref.float()).abs() <= allowed).all()


def test_roi_align_fewer_levels_and_wrapper_contract(cuda):
    feats, rois = roi_case(2, 20, 256, 32, torch.float32, 5, cuda)
    two = roi_align_rotated_pyramid(feats[:2], rois, (7, 7), ROI_SCALES[:2])
    ref = roi_align_rotated_pyramid_plain(feats[:2], rois, (7, 7),
                                          ROI_SCALES[:2])
    assert (two - ref).abs().max() <= 2e-4 * float(feats[0].abs().max())
    with pytest.raises(ValueError):
        roi_align_rotated_pyramid(feats, rois.cpu(), (7, 7), ROI_SCALES)
    with pytest.raises(ValueError):
        roi_align_rotated_pyramid(feats, rois, (5, 5), ROI_SCALES)
    with pytest.raises(ValueError):
        roi_align_rotated_pyramid(feats, rois, (7, 7), ROI_SCALES, 4)
    with pytest.raises(ValueError):
        roi_align_rotated_pyramid([f.half() for f in feats], rois, (7, 7),
                                  ROI_SCALES)
    before = roi_align_rotated_pyramid.launches
    # no gradient, and none dropped quietly: nothing launches, no gather
    wants_grad = [feats[0].clone().requires_grad_()] + feats[1:]
    for fn in (roi_align_rotated_pyramid, roi_align_rotated_pyramid_plain):
        with pytest.raises(ValueError, match='gradient'):
            fn(wants_grad, rois, (7, 7), ROI_SCALES)
    assert roi_align_rotated_pyramid.launches == before
    empty = roi_align_rotated_pyramid(feats, rois[:, :0].contiguous(),
                                      (7, 7), ROI_SCALES)
    assert empty.shape == (2, 0, 7, 7, 32)
    assert roi_align_rotated_pyramid.launches == before   # nothing to launch


def test_small_two_stage_slice_kernels_equal_plain(cuda):
    """A small Oriented R-CNN on the card: the RoIAlign kernel and its
    plain version give the same head outputs to 1e-3 and the same
    detections up to near-ties in score; the pair-mask kernel and its plain
    version give equal detections from the same head outputs."""
    import os.path as osp

    from chip_smoke import same_detections
    cfg = Config.fromfile(osp.join(
        osp.dirname(__file__), '..', 'configs', 'oriented_rcnn',
        'oriented_rcnn_tiny_synth.py'))
    bundle = init_detector(cfg, device=cuda, seed=1)
    det = bundle.detector
    with torch.no_grad():
        det.rpn_head.rpn_reg.weight.mul_(0.05)
        det.roi_head.bbox_head.fc_reg.weight.mul_(0.05)
    images = torch.from_numpy(np.random.default_rng(2).normal(
        0, 1, (2, 256, 256, 3)).astype(np.float32))
    roi_before = roi_align_rotated_pyramid.launches
    mask_before = nms_pair_mask.launches
    outputs = bundle.forward(images)
    dets, labels, valid = bundle.decode(outputs)
    assert roi_align_rotated_pyramid.launches == roi_before + 1
    assert nms_pair_mask.launches == mask_before + 1
    assert valid.sum() > 20

    plain_mask = DetectorBundle(bundle.cfg, det, plain_pair_mask=True)
    m_dets, m_labels, m_valid = plain_mask.decode(outputs)
    assert nms_pair_mask.launches == mask_before + 1
    assert torch.equal(valid, m_valid) and torch.equal(labels, m_labels)
    assert (dets - m_dets).abs().max() <= 1e-3

    plain_roi = DetectorBundle(bundle.cfg, det, plain_roi_align=True)
    p_outputs = plain_roi.forward(images)
    assert roi_align_rotated_pyramid.launches == roi_before + 1
    assert torch.equal(outputs['proposals'], p_outputs['proposals'])
    for k in ('cls_score', 'bbox_pred'):
        assert (outputs[k] - p_outputs[k]).abs().max() <= 1e-3
    scores = torch.softmax(outputs['cls_score'], -1)[..., :-1].flatten(1)
    cut = scores.topk(min(2000, scores.shape[1]))[0][:, -1]
    same_detections((dets, labels, valid), plain_roi.decode(p_outputs), cut)


@pytest.mark.parametrize('ratio', [1, 2])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('theta', ['zero', 'stage1'])
def test_roi_align_on_theta0_and_refined_rois(cuda, ratio, dtype, theta):
    """The horizontal-proposal detectors' RoIs: theta-0 proposals (Rotated
    Faster R-CNN pools them at 1 sample a bin side, Gliding Vertex and RoI
    Transformer's stage 0 at 2), and RoI Transformer's stage-1 RoIs, those
    proposals decoded with seeded deltas (some giant, some over the
    edge)."""
    from orientedobjectdetection_torch.core import DeltaXYWHAHBBoxCoder
    feats, rois = roi_case(2, 120, 256, 64, dtype, 11 + ratio, cuda)
    rois[..., 4] = 0.0
    if theta == 'stage1':
        deltas = torch.from_numpy(np.random.default_rng(5).normal(
            0, 1.5, (2, 120, 5)).astype(np.float32)).to(cuda)
        coder = DeltaXYWHAHBBoxCoder(angle_range='le90', norm_factor=2,
                                     edge_swap=True,
                                     target_stds=(0.1, 0.1, 0.2, 0.2, 0.1))
        live = rois[..., 2:3] > 0
        rois = torch.where(live, coder.decode(rois, deltas), rois)
        assert (rois[..., 4].abs() > 1e-3).float().mean() > 0.5
    args = (feats, rois.contiguous(), (7, 7), ROI_SCALES, ratio, 56.0)
    before = roi_align_rotated_pyramid.launches
    got = roi_align_rotated_pyramid(*args)
    torch.cuda.synchronize()
    assert roi_align_rotated_pyramid.launches == before + 1
    ref = roi_align_rotated_pyramid_plain(*args)
    scale = max(float(f.abs().max()) for f in feats)
    allowed = ROI_RTOL * scale + ROI_BF16_STEP[dtype] * ref.float().abs()
    assert ((got.float() - ref.float()).abs() <= allowed).all()
    assert not got[:, -15:].any()                   # padding: exact zeros
    assert got[:, :-15].abs().max() > 0


@pytest.mark.parametrize('family', ['rotated_faster_rcnn/'
                                    'rotated_faster_rcnn_tiny_synth.py',
                                    'gliding_vertex/'
                                    'gliding_vertex_tiny_synth.py',
                                    'roi_trans/roi_trans_tiny_synth.py'])
def test_small_hbb_slice_kernels_equal_plain(cuda, family):
    """The tiny horizontal-proposal detectors on the card: 1 / 1 / 2
    RoIAlign launches a request, and the RoIAlign and pair-mask kernels
    give the same detections as their plain versions up to near-ties in
    score."""
    import os.path as osp

    from chip_smoke import HBB_POOLS, hbb_cut, same_detections, \
        seed_hbb_detections
    cfg = Config.fromfile(osp.join(osp.dirname(__file__), '..', 'configs',
                                   family))
    bundle = init_detector(cfg, device=cuda, seed=1)
    seed_hbb_detections(bundle.detector)
    pools = HBB_POOLS[{'rotated_faster_rcnn': 'faster',
                       'gliding_vertex': 'gv',
                       'roi_trans': 'roitrans'}[family.split('/')[0]]]
    images = torch.from_numpy(np.random.default_rng(3).normal(
        0, 1, (2, 256, 256, 3)).astype(np.float32))
    roi_before = roi_align_rotated_pyramid.launches
    outputs = bundle.forward(images)
    got = bundle.decode(outputs)
    assert roi_align_rotated_pyramid.launches == roi_before + pools
    assert got[2].sum() > 20
    cut = hbb_cut(outputs, 2000)
    for switch in ('plain_roi_align', 'plain_pair_mask'):
        plain = DetectorBundle(bundle.cfg, bundle.detector, **{switch: True})
        same_detections(got, plain.decode(plain.forward(images)), cut)
    assert roi_align_rotated_pyramid.launches == roi_before + 2 * pools


# ---- the trainer and the evaluator (configs/rotated_retinanet/
# rotated_retinanet_tiny_synth.py cut to 128 px, 4 synthetic images)
TINY_SYNTH = '''
model = dict(test_cfg=dict(nms_pre=500, max_candidates=512, max_per_img=50))
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
data = dict(samples_per_gpu=2, pad_size=(128, 128),
            train=dict(pipeline=train_pipeline),
            val=dict(pipeline=test_pipeline),
            test=dict(pipeline=test_pipeline))
pad_size = (128, 128)
checkpoint_config = dict(interval=1)
evaluation = dict(interval=1, samples_per_gpu=2)
'''


def test_loader_train_step_eval_round_trip(cuda, tmp_path):
    """``train_detector`` on the card: the loader's pinned batches through
    ``train_step`` (one IoU-matrix launch a step), the evaluation at the
    epoch's end (the pair mask and the IoU matrix of ``eval_rbbox_map`` on
    the card), a checkpoint that ``init_detector`` serves from."""
    import os
    from orientedobjectdetection_torch.apis.eval import (_default_norm,
                                                         eval_from_state)
    from orientedobjectdetection_torch.apis.train import train_detector
    from orientedobjectdetection_torch.datasets import build_dataset
    from orientedobjectdetection_torch.tools.generate_synth import \
        generate_synth
    from orientedobjectdetection_torch.tools.train import load_config
    root = str(tmp_path / 'synth')
    generate_synth(root, num_images=4, size=128, seed=0)
    config = tmp_path / 'tiny.py'
    base = os.path.join(os.path.dirname(__file__), '..', 'configs',
                        'rotated_retinanet', 'rotated_retinanet_tiny_synth.py')
    config.write_text(f'_base_ = [{os.path.abspath(base)!r}]\n' + TINY_SYNTH)
    cfg = load_config(str(config), [f'data_root={root}/'])
    before = box_iou_rotated_matrix.launches
    pairs = nms_pair_mask.launches
    state = train_detector(cfg, str(tmp_path / 'work'), max_steps=2,
                           log_interval=1, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert state.step == 2
    assert next(state.model.parameters()).is_cuda
    # 2 steps, then the evaluation's IoUs (one launch a class with both)
    assert box_iou_rotated_matrix.launches - before >= 2
    assert nms_pair_mask.launches > pairs           # 512 candidates
    ckpt = str(tmp_path / 'work' / 'ckpt_00000002.pth')
    bundle = init_detector(cfg, ckpt, device_norm=_default_norm(cfg))
    assert bundle.device.type == 'cuda'
    val = build_dataset(dict(cfg.data['val'], test_mode=True,
                             filter_empty_gt=False))
    ev = eval_from_state(bundle, state.model.state_dict(), val,
                         batch_size=2)
    assert 0 <= ev['mAP'] <= 1


@pytest.mark.parametrize('seed', [0, 1])
def test_eval_iou_matrices_kernel_equals_plain(cuda, seed):
    """``eval_rbbox_map``'s batched IoUs (each image's dets against its gts,
    zero-padded) with the kernel and with the plain version; the same AP
    from both."""
    from orientedobjectdetection_torch.core.eval_map import (batched_ious,
                                                             eval_rbbox_map)
    rng = np.random.default_rng(seed)

    def boxes(n):
        return np.stack([rng.uniform(0, 256, n), rng.uniform(0, 256, n),
                         rng.uniform(4, 60, n), rng.uniform(4, 60, n),
                         rng.uniform(-np.pi / 2, np.pi / 2, n)],
                        -1).astype(np.float32)

    gts = [boxes(int(rng.integers(0, 9))) for _ in range(7)]
    dets = [np.concatenate([np.concatenate(
        [g + rng.normal(0, 2, g.shape).astype(np.float32), boxes(30)]),
        rng.random((len(g) + 30, 1)).astype(np.float32)], 1) for g in gts]
    before = box_iou_rotated_matrix.launches
    got = batched_ious(dets, gts, device=cuda)
    assert box_iou_rotated_matrix.launches == before + 1
    ref = batched_ious(dets, gts, device=cuda, plain_iou=True)
    for g, r, d, t in zip(got, ref, dets, gts):
        assert g.shape == r.shape == (len(d), len(t))
        np.testing.assert_allclose(g, r, rtol=0, atol=IOU_ATOL)
    anns = [dict(bboxes=g, labels=np.zeros(len(g), np.int64)) for g in gts]
    results = [[d] for d in dets]
    got_map = eval_rbbox_map(results, anns, device=cuda, logger='silent')[0]
    ref_map = eval_rbbox_map(results, anns, device=cuda, plain_iou=True,
                             logger='silent')[0]
    assert abs(got_map - ref_map) <= 1e-4


@pytest.mark.parametrize('g,valid', [(32, 8), (512, 64)])
def test_atss_iou_matrix_priors_as_rows(cuda, g, valid):
    """ATSS's orientation: ``rbbox_overlaps(priors, gts)`` with the 21,824
    single-anchor priors of a 1024^2 image first and the batch's padded gts
    second; the kernel keeps the gts in shared memory and hands back the
    transpose of the ``(B, G, N)`` buffer it wrote. Then the whole assigner
    with the kernel and with the plain matrix."""
    from orientedobjectdetection_torch.core import (ATSSObbAssigner,
                                                    RotatedAnchorGenerator)
    strides = [8, 16, 32, 64, 128]
    levels = RotatedAnchorGenerator(
        octave_base_scale=4, scales_per_octave=1, ratios=[1.0],
        strides=strides).grid_priors([(1024 // s, 1024 // s)
                                      for s in strides], device=cuda)
    priors = torch.cat(levels, 0)
    assert priors.shape == (21824, 5)
    rng = np.random.default_rng(g)
    gts = np.zeros((8, g, 5), np.float32)
    gts[:, :valid] = np.stack([rng.uniform(0, 1024, (8, valid)),
                               rng.uniform(0, 1024, (8, valid)),
                               rng.uniform(8, 200, (8, valid)),
                               rng.uniform(8, 200, (8, valid)),
                               rng.uniform(-1.5, 1.5, (8, valid))], -1)
    gts = torch.from_numpy(gts).to(cuda)
    before = box_iou_rotated_matrix.launches
    got = rbbox_overlaps(priors, gts)
    assert box_iou_rotated_matrix.launches == before + 1
    assert got.shape == (8, 21824, g)
    ref = rbbox_overlaps(priors, gts, plain=True)
    assert float((got - ref).abs().max()) <= IOU_ATOL
    mask = torch.arange(g, device=cuda)[None].expand(8, g) < valid
    labels = torch.zeros((8, g), dtype=torch.int64, device=cuda)
    num_level = [len(lv) for lv in levels]
    kernel = ATSSObbAssigner()(priors, num_level, gts, labels, mask)
    plain = ATSSObbAssigner(plain_iou=True)(priors, num_level, gts, labels,
                                            mask)
    assert (kernel.assigned_gt_inds >= 0).sum() > 0
    assert int((kernel.assigned_gt_inds != plain.assigned_gt_inds).sum()) \
        <= 2
    assert kernel.assigned_gt_inds.max() < valid


def test_tpfp_default_on_the_card_equals_the_cpu(cuda):
    """``tpfp_default`` computes its IoUs on the card by default: the same
    TP / FP marks as with ``device='cpu'``."""
    from orientedobjectdetection_torch.core.eval_map import tpfp_default
    rng = np.random.default_rng(3)

    def boxes(n):
        return np.stack([rng.uniform(0, 256, n), rng.uniform(0, 256, n),
                         rng.uniform(4, 60, n), rng.uniform(4, 60, n),
                         rng.uniform(-np.pi / 2, np.pi / 2, n)],
                        -1).astype(np.float32)

    gts, ignore = boxes(12), boxes(3)
    dets = np.concatenate([np.concatenate(
        [gts + rng.normal(0, 2, gts.shape).astype(np.float32), boxes(40)]),
        rng.random((52, 1)).astype(np.float32)], 1)
    before = box_iou_rotated_matrix.launches
    got = tpfp_default(dets, gts, ignore)
    assert box_iou_rotated_matrix.launches == before + 1
    ref = tpfp_default(dets, gts, ignore, device='cpu')
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    assert got[0].sum() > 0


def refined_rois(bsz, size, seed, device, far=0.05):
    """Each image's refined boxes as a refine stage sees them: S2ANet's FAM
    anchors of a ``size``^2 image (one 4-stride square a location, 21,824 at
    1024^2) decoded with random deltas, a ``far`` share of them thrown
    far off their anchors (a seeded head's outliers)."""
    from orientedobjectdetection_torch.core import (DeltaXYWHAOBBoxCoder,
                                                    RotatedAnchorGenerator)
    strides = [8, 16, 32, 64, 128]
    anchors = torch.cat(RotatedAnchorGenerator(
        scales=[4], ratios=[1.0], strides=strides).grid_priors(
            [(-(-size // s), -(-size // s)) for s in strides]), 0)
    rng = np.random.default_rng(seed)
    deltas = rng.normal(0, 0.3, (bsz, len(anchors), 5))
    out = rng.random((bsz, len(anchors))) < far
    deltas[out, :2] *= 40.0
    deltas[out, 2:4] += 2.5
    coder = DeltaXYWHAOBBoxCoder(angle_range='le135', norm_factor=1,
                                 edge_swap=False, proj_xy=True)
    rois = coder.decode(anchors[None], torch.from_numpy(
        deltas.astype(np.float32)))
    return rois.to(device)


@pytest.mark.parametrize('g,valid', [(32, 8), (512, 64)])
def test_iou_matrix_on_refined_rois(cuda, g, valid):
    """The refine stages' assigner input: each image's padded gts against
    its own 21,824 refined boxes (``cols_batched``), some far from any
    anchor and large; within IOU_ATOL of the plain version, exactly 0 out
    of reach; then the MaxIoU assigner alike with the kernel and the plain
    matrix outside a band of 1e-5 around its thresholds."""
    from orientedobjectdetection_torch.ops.iou import _clamp_wh
    rois = _clamp_wh(refined_rois(8, 1024, g, cuda))
    assert rois.shape == (8, 21824, 5)
    rng = np.random.default_rng(g + 1)
    gts = np.zeros((8, g, 5), np.float32)
    gts[:, :valid] = np.stack([rng.uniform(0, 1024, (8, valid)),
                               rng.uniform(0, 1024, (8, valid)),
                               rng.uniform(8, 200, (8, valid)),
                               rng.uniform(8, 200, (8, valid)),
                               rng.uniform(-1.5, 1.5, (8, valid))], -1)
    gts = _clamp_wh(torch.from_numpy(gts).to(cuda))
    live = check_iou_matrix(gts, rois, 'iou')
    assert live[:, :valid].any()
    mask = torch.arange(g, device=cuda)[None].expand(8, g) < valid
    labels = torch.zeros((8, g), dtype=torch.int64, device=cuda)
    kw = dict(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0)
    got = MaxIoUAssigner(**kw)(rois, gts, labels, mask)
    ref = MaxIoUAssigner(plain_iou=True, **kw)(rois, gts, labels, mask)
    band = ((ref.max_overlaps - 0.4).abs() < 1e-5) | \
        ((ref.max_overlaps - 0.5).abs() < 1e-5)
    assert torch.equal(got.assigned_gt_inds[~band],
                       ref.assigned_gt_inds[~band])
    assert (got.assigned_gt_inds >= 0).any()


REFINE_TINY = ['configs/s2anet/s2anet_tiny_synth.py',
               'configs/r3det/r3det_tiny_synth.py']


@pytest.mark.parametrize('config', REFINE_TINY)
def test_refine_train_step_kernel_equals_plain(cuda, config):
    """A tiny S2ANet / R3Det train step on the card from one seeded state:
    two IoU-matrix launches (the first stage's shared anchors, the refine
    stage's per-image rois) and none with the plain matrix; the same
    losses within 1e-4. The gts are ``chip_smoke.well_posed_batch``'s,
    whose first-stage assignment no rounding decides."""
    import chip_smoke
    from orientedobjectdetection_torch.models import build_detector
    from orientedobjectdetection_torch.parallel import (create_train_state,
                                                        build_optimizer,
                                                        make_train_step)
    rng = np.random.default_rng(4)
    batch = chip_smoke.well_posed_batch(2, 256, 16, 6, 4, cuda)
    batch['images'] = torch.from_numpy(rng.normal(
        0, 1, (2, 256, 256, 3)).astype(np.float32))
    batch['gt_labels'] = batch['gt_labels'] % 2
    metrics = []
    for plain in (False, True):
        cfg = Config.fromfile(config)
        detector = build_detector(dict(cfg.model))
        for head in detector.heads():
            head.assigner.plain_iou = plain
        tx = build_optimizer(dict(cfg.optimizer), 0.01,
                             grad_clip=dict(max_norm=35))
        state = create_train_state(detector, tx, device=cuda, seed=0)
        step = make_train_step(detector, tx)
        before = box_iou_rotated_matrix.launches
        state, m = step(state, batch)
        torch.cuda.synchronize()
        assert box_iou_rotated_matrix.launches - before == \
            (0 if plain else 2)
        metrics.append({k: float(v) for k, v in m.items()})
    for k, v in metrics[1].items():
        if k != 'grad_norm':
            assert abs(metrics[0][k] - v) <= 1e-4 * abs(v), k


@pytest.mark.parametrize('config', REFINE_TINY)
def test_refine_bundle_kernel_equals_plain(cuda, config):
    """A tiny S2ANet / R3Det served on the card (class bias zeroed, so
    scores pass score_thr): one pair-mask launch a request, the same
    detections with the plain pair mask."""
    bundle = init_detector(config, device=cuda, seed=0)
    last = bundle.detector.heads()[-1]
    with torch.no_grad():
        (last.odm_cls if hasattr(last, 'odm_cls') else
         last.retina_cls).bias.zero_()
    plain = DetectorBundle(bundle.cfg, bundle.detector, plain_pair_mask=True)
    images = torch.from_numpy(np.random.default_rng(2).normal(
        0, 1, (2, 256, 256, 3)).astype(np.float32))
    before = nms_pair_mask.launches
    dets, labels, valid = bundle(images)
    torch.cuda.synchronize()
    assert nms_pair_mask.launches == before + 1
    p_dets, p_labels, p_valid = plain(images)
    assert valid.any()
    assert torch.equal(valid, p_valid) and torch.equal(labels, p_labels)
    assert (dets - p_dets).abs().max() <= 1e-3


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('fields', [8, 32])
def test_roi_align_on_re_fpn_levels_then_the_roll(cuda, dtype, fields):
    """ReDet's serving pooling: the kernel on ReFPN-like levels (``fields``
    x 8 orientation channels; 8 fields in the tiny config, 32 in the DOTA
    one) and RoIs at every orientation bin and its boundaries, then the
    orientation roll, against the plain version and the same roll. The
    roll is a gather, so the tolerance is the kernel's own."""
    from orientedobjectdetection_torch.models.backbones.re_resnet import (
        orientation_shift, ri_roll)
    feats, rois = roi_case(2, 160, 256, fields * 8, dtype, 21 + fields, cuda)
    k = torch.arange(160, device=cuda) % 17 - 8
    rois[..., 4] = (k * (np.pi / 8)).float() + torch.tensor(
        [0.0, 1e-6, -1e-6, 0.2], device=cuda).repeat(40)
    args = (feats, rois.contiguous(), (7, 7), ROI_SCALES, 2, 56.0)
    before = roi_align_rotated_pyramid.launches
    got = ri_roll(roi_align_rotated_pyramid(*args), rois)
    torch.cuda.synchronize()
    assert roi_align_rotated_pyramid.launches == before + 1
    ref = ri_roll(roi_align_rotated_pyramid_plain(*args), rois)
    scale = max(float(f.abs().max()) for f in feats)
    allowed = ROI_RTOL * scale + ROI_BF16_STEP[dtype] * ref.float().abs()
    assert ((got.float() - ref.float()).abs() <= allowed).all()
    shifts = orientation_shift(rois[..., 4])
    assert set(shifts.flatten().tolist()) == set(range(8))
    assert torch.equal(shifts.cpu(), orientation_shift(rois[..., 4].cpu()))


# ---- the point-set families (no kernel of their own: B1 serves them) -------
REPPOINTS_TINY = ['configs/oriented_reppoints/'
                  'oriented_reppoints_tiny_synth.py',
                  'configs/cfa/cfa_tiny_synth.py',
                  'configs/sasm_reppoints/sasm_tiny_synth.py',
                  'configs/g_reppoints/g_reppoints_tiny_synth.py']


def spread_points(head):
    """The initial points on a 3 x 3 grid 2 cells apart, the point outputs'
    weights x 0.05 (``chip_smoke.spread_point_sets``)."""
    grid = torch.tensor([-2.0, 0.0, 2.0])
    gy, gx = torch.meshgrid(grid, grid, indexing='ij')
    with torch.no_grad():
        for conv in (head.reppoints_pts_init_out,
                     head.reppoints_pts_refine_out):
            conv.weight.mul_(0.05)
        head.reppoints_pts_init_out.bias.copy_(
            torch.stack([gy.reshape(-1), gx.reshape(-1)], -1).reshape(-1))
        head.reppoints_pts_refine_out.bias.zero_()


def test_convex_iou_chunks_on_the_card_equal_one_chunk(cuda):
    """``convex_iou`` in chunks of 2^14 pairs equals one chunk bit for bit
    on the card, and the CPU's within 1e-5."""
    from orientedobjectdetection_torch.ops.points import convex_iou
    rng = np.random.default_rng(5)
    sets = rng.uniform(0, 300, (2, 3000, 1, 2)) + \
        rng.normal(0, 12, (2, 3000, 9, 2))
    sets = torch.from_numpy(sets.reshape(2, 3000, 18).astype(np.float32))
    ctr = rng.uniform(0, 300, (2, 32, 1, 2))
    corners = np.array([[-20, -8], [20, -8], [20, 8], [-20, 8]])
    polys = torch.from_numpy((ctr + corners).reshape(2, 32, 8).astype(
        np.float32))
    whole = convex_iou(sets.to(cuda), polys.to(cuda), pairs=1 << 40)
    chunked = convex_iou(sets.to(cuda), polys.to(cuda), pairs=1 << 14)
    assert torch.equal(whole, chunked)
    assert (whole > 0).sum() > 100
    assert (whole.cpu() - convex_iou(sets, polys)).abs().max() <= 1e-5


def test_rotated_reppoints_bundle_kernel_equals_plain(cuda):
    """Rotated RepPoints R50 (its DOTA config) served on the card at 256²,
    points spread and class bias zeroed: one pair-mask launch a request,
    the same detections with the plain pair mask."""
    bundle = init_detector(
        'configs/rotated_reppoints/rotated_reppoints_r50_fpn_1x_dota_oc.py',
        device=cuda, seed=0)
    head = bundle.detector.bbox_head
    spread_points(head)
    with torch.no_grad():
        head.reppoints_cls_out.bias.zero_()
    plain = DetectorBundle(bundle.cfg, bundle.detector, plain_pair_mask=True)
    images = torch.from_numpy(np.random.default_rng(3).normal(
        0, 1, (2, 256, 256, 3)).astype(np.float32))
    before = nms_pair_mask.launches
    dets, labels, valid = bundle(images)
    torch.cuda.synchronize()
    assert nms_pair_mask.launches == before + 1
    p_dets, p_labels, p_valid = plain(images)
    assert valid.sum() > 100
    assert torch.equal(valid, p_valid) and torch.equal(labels, p_labels)
    assert (dets - p_dets).abs().max() <= 1e-3


@pytest.mark.parametrize('config', REPPOINTS_TINY)
def test_reppoints_targets_on_the_card_equal_the_cpu(cuda, config):
    """A tiny-synth point-set detector's targets of one batch (256², G=16
    with 6 valid), from the same outputs on the card and on the CPU: the
    assignments, positives and keeps equal, the losses within 1e-4."""
    from orientedobjectdetection_torch.models import build_detector
    detector = build_detector(dict(Config.fromfile(config).model))
    detector.init_weights(0)
    head = detector.bbox_head
    spread_points(head)
    detector.to(cuda)
    rng = np.random.default_rng(6)
    images = torch.from_numpy(rng.normal(0, 1, (2, 3, 256, 256)).astype(
        np.float32)).to(cuda)
    obb = np.stack([rng.uniform(30, 226, (2, 16)),
                    rng.uniform(30, 226, (2, 16)),
                    rng.uniform(12, 70, (2, 16)),
                    rng.uniform(12, 70, (2, 16)),
                    rng.uniform(-0.7, 0.7, (2, 16))], -1).astype(np.float32)
    gts = [torch.from_numpy(obb),
           torch.from_numpy(rng.integers(0, 15, (2, 16))),
           torch.arange(16)[None].expand(2, 16) < 6]
    with torch.no_grad():
        outputs = detector(images)

    def cpu(tree):
        if isinstance(tree, (list, tuple)):
            return type(tree)(cpu(v) for v in tree)
        return tree.cpu()

    card = head.targets(outputs, *[t.to(cuda) for t in gts])
    host = head.targets(cpu(outputs), *gts)
    for k in ('init_w', 'pos_r', 'neg_r', 'labels_r', 'keep'):
        if k in host:
            assert torch.equal(card[k].cpu(), host[k]), k
    assert host['pos_r'].sum() > 0
    with torch.no_grad():
        on_card = head.losses(head.flat_outputs(outputs), card)
        on_cpu = head.losses(head.flat_outputs(cpu(outputs)), host)
    for k, v in on_cpu.items():
        assert abs(float(on_card[k]) - float(v)) <= 1e-4 * abs(float(v)), k


YOLO_TINY = 'configs/jy/rotated_yolov8_tiny_synth.py'


def test_yolov8_bundle_kernel_equals_plain(cuda):
    """prototype4 (its DOTA config, CSPNeXt-M) served on the card at 256²,
    the class bias zeroed: one pair-mask launch a request, the same
    detections with the plain pair mask."""
    bundle = init_detector('configs/jy/prototype4.py', device=cuda, seed=0)
    head = bundle.detector.bbox_head
    with torch.no_grad():
        for i in range(3):
            getattr(head, f'cls_pred_{i}').bias.zero_()
    plain = DetectorBundle(bundle.cfg, bundle.detector, plain_pair_mask=True)
    images = torch.from_numpy(np.random.default_rng(4).normal(
        0, 1, (2, 256, 256, 3)).astype(np.float32))
    before = nms_pair_mask.launches
    dets, labels, valid = bundle(images)
    torch.cuda.synchronize()
    assert nms_pair_mask.launches == before + 1
    p_dets, p_labels, p_valid = plain(images)
    assert valid.sum() > 100
    assert torch.equal(valid, p_valid) and torch.equal(labels, p_labels)
    assert (dets - p_dets).abs().max() <= 1e-3


@pytest.mark.parametrize('norm_eval', [True, False])
def test_yolov8_targets_on_the_card_equal_the_cpu(cuda, norm_eval):
    """The tiny-synth RotatedYOLOv8's targets of one batch (256², G=16
    with 6 valid) from the same outputs on the card (the IoU-matrix kernel,
    one launch) and on the CPU: labels, positives and angle targets equal,
    the box targets within 1e-5 strides, the losses within 1e-4; then a
    train step on the card (live BN with ``norm_eval=False``) is finite."""
    from orientedobjectdetection_torch.models import build_detector
    from orientedobjectdetection_torch.parallel import (build_optimizer,
                                                        create_train_state,
                                                        make_train_step)
    cfg = Config.fromfile(YOLO_TINY)
    detector = build_detector(dict(cfg.model))
    tx = build_optimizer(dict(type='sgd', momentum=0.9), 1e-3)
    state = create_train_state(detector, tx, device=cuda)
    head = detector.bbox_head
    rng = np.random.default_rng(7)
    images = rng.normal(0, 1, (2, 256, 256, 3)).astype(np.float32)
    obb = np.stack([rng.uniform(30, 226, (2, 16)),
                    rng.uniform(30, 226, (2, 16)),
                    rng.uniform(12, 70, (2, 16)),
                    rng.uniform(12, 70, (2, 16)),
                    rng.uniform(-1.2, 1.2, (2, 16))], -1).astype(np.float32)
    gts = [torch.from_numpy(obb),
           torch.from_numpy(rng.integers(0, 2, (2, 16))),
           torch.arange(16)[None].expand(2, 16) < 6]
    with torch.no_grad():
        outputs = detector(torch.from_numpy(images).permute(0, 3, 1, 2).to(
            cuda))
    cpu_outputs = tuple(tuple(m.cpu() for m in level) for level in outputs)
    before = box_iou_rotated_matrix.launches
    card = head.targets(outputs, *[t.to(cuda) for t in gts])
    torch.cuda.synchronize()
    assert box_iou_rotated_matrix.launches == before + 1
    host = head.targets(cpu_outputs, *gts)
    for i in (0, 2, 3):
        assert torch.equal(card[i].cpu(), host[i]), i
    assert (card[1].cpu() - host[1]).abs().max() <= 1e-5
    assert host[3].sum() > 0
    with torch.no_grad():
        on_card = head.losses(outputs, *card)
        on_cpu = head.losses(cpu_outputs, *host)
    for k, v in on_cpu.items():
        assert abs(float(on_card[k]) - float(v)) <= 1e-4 * abs(float(v)), k
    step = make_train_step(detector, tx, norm_eval=norm_eval)
    batch = dict(images=torch.from_numpy(images), gt_bboxes=gts[0],
                 gt_labels=gts[1], gt_mask=gts[2])
    stats = head.cls_conv_0_0.bn.running_var.clone()
    state, metrics = step(state, batch)
    assert all(torch.isfinite(v) for v in metrics.values())
    moved = not torch.equal(head.cls_conv_0_0.bn.running_var, stats)
    assert moved == (not norm_eval)


def test_native_host_nms_keeps_what_the_pair_mask_keeps(cuda):
    """``nms_rotated_np`` on the CPU (the native C++ NMS) and on the card
    (one pair-mask launch and the scan): the same keep list on a dense
    class with duplicates and score ties."""
    from orientedobjectdetection_torch.ops.nms import nms_rotated_np
    rng = np.random.default_rng(3)
    n = 2500
    boxes = np.stack([rng.uniform(0, 400, n), rng.uniform(0, 400, n),
                      rng.uniform(4, 60, n), rng.uniform(4, 60, n),
                      rng.uniform(-np.pi / 2, np.pi / 2, n)],
                     -1).astype(np.float32)
    boxes[1::5] = boxes[0::5][:len(boxes[1::5])]
    scores = (rng.integers(0, 200, n) / 200).astype(np.float32)
    before = nms_pair_mask.launches
    on_card = nms_rotated_np(boxes, scores, 0.1, device=cuda)
    assert nms_pair_mask.launches == before + 1
    np.testing.assert_array_equal(
        nms_rotated_np(boxes, scores, 0.1, device='cpu'), on_card)


def test_bundle_over_every_card_equals_one_card(cuda):
    """``DetectorBundle(devices=[every local card])``: each card runs its
    shard's kernels on its own device; the padded detections equal one
    card's on the same shards."""
    devices = [f'cuda:{i}' for i in range(torch.cuda.device_count())]
    one = init_detector(small_cfg(), device=cuda, seed=1)
    split = init_detector(small_cfg(), devices=devices, seed=1)
    images = torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, (2 * len(devices), 128, 128, 3)).astype(np.float32))
    got = split(images)
    shards = [one(s) for s in torch.tensor_split(images, len(devices))]
    for k in range(3):
        assert torch.equal(got[k].cpu(),
                           torch.cat([s[k].cpu() for s in shards]))
