"""Port parity, ops: geometry, rotated IoU, the NMS pair mask (plain version
of the CUDA kernel) and NMS, against the JAX package on the CPU.

Inputs come from numpy seeds and go to both packages. Tolerances: geometry
and IoU atol 1e-4 (float32, same formulation, different libm); masks exact
outside a +-2e-3 band around the threshold (``tests/test_ops/test_iou.py``'s
band for the TPU kernel, which uses a different shrink and frame)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orientedobjectdetection_tpu.ops import boxes as jboxes
from orientedobjectdetection_tpu.ops import iou as jiou
from orientedobjectdetection_tpu.ops import nms as jnms
from orientedobjectdetection_tpu.ops.iou_pallas import nms_pair_mask_pallas
from orientedobjectdetection_torch.ops import boxes as tboxes
from orientedobjectdetection_torch.ops import iou as tiou
from orientedobjectdetection_torch.ops import iou_kernels, nms as tnms

torch.set_num_threads(1)

BAND = 2e-3

# jitted JAX references: one compile each instead of per-op dispatch
j_iou = jax.jit(jiou.box_iou_rotated, static_argnames=('mode', 'aligned'))
j_poly = jax.jit(jboxes.obb2poly)
j_norm = jax.jit(jboxes.norm_angle, static_argnames=('angle_range',))
j_upper = jax.jit(lambda b, c, thr: jnms._upper_pair_mask(
    b, jiou.box_iou_rotated, thr, class_ids=c), static_argnames=('thr',))
j_nms = jax.jit(jnms.nms_rotated, static_argnames=('iou_threshold',))
j_mc = jax.jit(jnms.multiclass_nms_rotated, static_argnames=(
    'score_thr', 'iou_thr', 'max_per_img', 'max_candidates'))


def dota_boxes(n, seed, lo=0.0, hi=1024.0, smin=4.0, smax=64.0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(lo, hi, n), rng.uniform(lo, hi, n),
                     rng.uniform(smin, smax, n), rng.uniform(smin, smax, n),
                     rng.uniform(-np.pi / 2, np.pi / 2, n)],
                    -1).astype(np.float32)


def clustered_boxes(n, seed):
    """Boxes crowded into a 200 px square: many overlaps near any
    threshold."""
    return dota_boxes(n, seed, hi=200.0, smin=10.0, smax=60.0)


def iou_cases():
    rand1, rand2 = dota_boxes(40, 0, hi=150.0), dota_boxes(30, 1, hi=150.0)
    same = dota_boxes(20, 2, hi=150.0)
    touching = np.asarray([[10., 10., 10., 10., 0.], [20., 10., 10., 10., 0.],
                           [10., 20., 10., 10., 0.], [30., 10., 10., 10., 0.],
                           [0., 0., 8., 4., np.pi / 2]], np.float32)
    zero = np.concatenate([np.zeros((3, 5), np.float32),
                           np.asarray([[5., 5., 0., 0., 0.3],
                                       [5., 5., 6., 0., 0.]], np.float32),
                           rand1[:5]])
    return {'random': (rand1, rand2), 'coincident': (same, same.copy()),
            'touching': (touching, touching), 'zero_size': (zero, zero)}


def test_obb2poly_and_norm_angle():
    b = np.concatenate([dota_boxes(64, 3), np.zeros((2, 5), np.float32)])
    np.testing.assert_allclose(
        tboxes.obb2poly(torch.from_numpy(b)).numpy(),
        np.asarray(j_poly(jnp.asarray(b))), atol=1e-4)
    a = np.random.default_rng(4).uniform(-10, 10, 500).astype(np.float32)
    for version in ('oc', 'le90', 'le135'):
        np.testing.assert_allclose(
            tboxes.norm_angle(torch.from_numpy(a), version).numpy(),
            np.asarray(j_norm(jnp.asarray(a), angle_range=version)),
            atol=1e-4)


@pytest.mark.parametrize('case', ['random', 'coincident', 'touching',
                                  'zero_size'])
@pytest.mark.parametrize('mode', ['iou', 'iof'])
def test_box_iou_rotated(case, mode):
    b1, b2 = iou_cases()[case]
    got = tiou.box_iou_rotated(torch.from_numpy(b1), torch.from_numpy(b2),
                               mode=mode).numpy()
    ref = np.asarray(j_iou(jnp.asarray(b1), jnp.asarray(b2), mode=mode))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=1e-4)
    aligned = tiou.box_iou_rotated(torch.from_numpy(b1[:len(b2)]),
                                   torch.from_numpy(b2[:len(b1)]),
                                   mode=mode, aligned=True).numpy()
    np.testing.assert_allclose(
        aligned, np.asarray(j_iou(
            jnp.asarray(b1[:len(b2)]), jnp.asarray(b2[:len(b1)]), mode=mode,
            aligned=True)), atol=1e-4)


def _pair_inputs(n, seed, with_cls):
    """Score-sorted (here: index-ordered) boxes, class-major when classes
    are used, as NMS hands them to the pair mask."""
    boxes = clustered_boxes(n, seed)
    if not with_cls:
        return boxes, None
    cls = np.sort(np.random.default_rng(seed + 1).integers(0, 3, n))
    return boxes, cls.astype(np.int32)


def _band(boxes, thr):
    iou = np.asarray(j_iou(jnp.asarray(boxes), jnp.asarray(boxes)))
    return np.abs(iou - thr) < BAND


def _port_plain(boxes, cls, thr):
    out = iou_kernels.nms_pair_mask_plain(
        torch.from_numpy(boxes)[None], thr,
        None if cls is None else torch.from_numpy(cls)[None])
    assert out.dtype == torch.uint8
    return out[0].numpy().astype(bool)


@pytest.mark.parametrize('with_cls', [False, True])
def test_pair_mask_plain_vs_jax_jnp(with_cls):
    boxes, cls = _pair_inputs(300, 10, with_cls)
    thr = 0.1
    ref = np.asarray(j_upper(
        jnp.asarray(boxes), None if cls is None else jnp.asarray(cls), thr))
    got = _port_plain(boxes, cls, thr)
    band = _band(boxes, thr)
    np.testing.assert_array_equal(got[~band], ref[~band])
    assert not got[np.tril_indices(len(boxes))].any()
    assert got.sum() > 100              # the case exercises suppression


@pytest.mark.parametrize('with_cls', [False, True])
def test_pair_mask_plain_vs_pallas_interpret(with_cls):
    boxes, cls = _pair_inputs(300, 20, with_cls)
    thr = 0.1
    ref = np.asarray(nms_pair_mask_pallas(
        jnp.asarray(boxes), thr, interpret=True,
        class_ids=None if cls is None else jnp.asarray(cls)))
    got = _port_plain(boxes, cls, thr)
    band = _band(boxes, thr)
    np.testing.assert_array_equal(got[~band], ref[~band])
    assert got.sum() > 100


def test_pair_mask_wrapper_on_cpu_takes_plain():
    boxes = torch.from_numpy(np.stack([clustered_boxes(70, 30),
                                       clustered_boxes(70, 31)]))
    cls = torch.from_numpy(np.sort(np.random.default_rng(32).integers(
        0, 4, (2, 70)), -1).astype(np.int32))
    before = iou_kernels.nms_pair_mask.launches
    got = iou_kernels.nms_pair_mask(boxes, 0.1, cls)
    assert iou_kernels.nms_pair_mask.launches == before   # no launch
    assert got.device.type == 'cpu' and got.dtype == torch.uint8
    torch.testing.assert_close(
        got, iou_kernels.nms_pair_mask_plain(boxes, 0.1, cls), rtol=0,
        atol=0)


@pytest.mark.parametrize('bad', ['float64', 'shape', 'cls_dtype',
                                 'cls_shape', 'noncontiguous'])
def test_pair_mask_wrapper_rejects(bad):
    boxes = torch.from_numpy(clustered_boxes(16, 33))[None]
    cls = torch.zeros((1, 16), dtype=torch.int32)
    if bad == 'float64':
        boxes = boxes.double()
    elif bad == 'shape':
        boxes = boxes[0]
    elif bad == 'cls_dtype':
        cls = cls.long()
    elif bad == 'cls_shape':
        cls = cls[:, :8]
    else:
        boxes = torch.cat([boxes, boxes], -1)[..., ::2]
    with pytest.raises(ValueError):
        iou_kernels.nms_pair_mask(boxes, 0.1, cls)


@pytest.mark.parametrize('with_cls', [False, True])
def test_nms_rotated(with_cls):
    rng = np.random.default_rng(40)
    bsz, n = 2, 120
    boxes = np.stack([clustered_boxes(n, 41 + i) for i in range(bsz)])
    # quantized scores: ties that stable ordering must break by index
    scores = (rng.integers(0, 20, (bsz, n)) / 20).astype(np.float32)
    valid = rng.uniform(size=(bsz, n)) > 0.1
    cls = rng.integers(0, 3, (bsz, n)).astype(np.int32) if with_cls else None
    keep, order = tnms.nms_rotated(
        torch.from_numpy(boxes), torch.from_numpy(scores), 0.1,
        valid_mask=torch.from_numpy(valid),
        class_ids=None if cls is None else torch.from_numpy(cls))
    for i in range(bsz):
        rk, ro = j_nms(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]), 0.1,
            valid_mask=jnp.asarray(valid[i]),
            class_ids=None if cls is None else jnp.asarray(cls[i]))
        np.testing.assert_array_equal(order[i].numpy(), np.asarray(ro))
        np.testing.assert_array_equal(keep[i].numpy(), np.asarray(rk))


def test_topk_candidates_ties_match_lax():
    x = (np.random.default_rng(50).integers(0, 8, (3, 400)) / 8
         ).astype(np.float32)
    v, i = tnms.topk_candidates(torch.from_numpy(x), 57)
    rv, ri = jax.lax.top_k(jnp.asarray(x), 57)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))


@pytest.mark.parametrize('tied', [False, True])
def test_multiclass_nms_rotated(tied):
    rng = np.random.default_rng(60 + tied)
    bsz, n, c = 2, 150, 4
    bboxes = np.stack([clustered_boxes(n, 61 + i) for i in range(bsz)])
    scores = rng.uniform(0, 1, (bsz, n, c + 1)).astype(np.float32)
    if tied:
        # bf16-like coarse scores: many ties at the top-k cut
        scores = (np.round(scores * 16) / 16).astype(np.float32)
    kw = dict(score_thr=0.05, iou_thr=0.1, max_per_img=120,
              max_candidates=256)
    dets, labels, valid = tnms.multiclass_nms_rotated(
        torch.from_numpy(bboxes), torch.from_numpy(scores), **kw)
    for i in range(bsz):
        rd, rl, rv = j_mc(
            jnp.asarray(bboxes[i]), jnp.asarray(scores[i]), **kw)
        np.testing.assert_array_equal(valid[i].numpy(), np.asarray(rv))
        np.testing.assert_array_equal(labels[i].numpy(), np.asarray(rl))
        np.testing.assert_allclose(dets[i].numpy(), np.asarray(rd),
                                   atol=1e-5)
    assert 0 < valid.sum() < valid.numel()
