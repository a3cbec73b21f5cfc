"""Port parity, the assignment IoU matrix: ``rbbox_overlaps`` and the plain
version of the CUDA kernel ``box_iou_rotated_matrix`` against the JAX
package on the same numpy inputs.

Tolerances: 1e-5 against the jnp ``box_iou_rotated`` (the same float32
formulation, element-wise); 2e-3 against the Pallas kernel in interpret
mode (the JAX suite's own tolerance for it: that kernel shrinks by 1e-4 in a
global frame)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from orientedobjectdetection_tpu.ops.iou import \
    box_iou_rotated as j_box_iou_rotated
from orientedobjectdetection_tpu.ops.iou import \
    rbbox_overlaps as j_rbbox_overlaps
from orientedobjectdetection_tpu.ops.iou_pallas import \
    box_iou_rotated_pallas_interpret
from orientedobjectdetection_torch.core import RotatedAnchorGenerator
from orientedobjectdetection_torch.ops import (box_iou_rotated,
                                               box_iou_rotated_matrix,
                                               box_iou_rotated_matrix_plain,
                                               obb2hbb, rbbox_overlaps)
from orientedobjectdetection_torch.ops.iou_kernels import (matrix_layout,
                                                           pairs_in_reach)

torch.set_num_threads(1)

ANCHOR_CFG = dict(octave_base_scale=4, scales_per_octave=3,
                  ratios=[1.0, 0.5, 2.0], strides=[8, 16, 32, 64, 128])


def random_boxes(n, seed, extent=100.0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(0, extent, n), rng.uniform(0, extent, n),
                     rng.uniform(2, 60, n), rng.uniform(2, 60, n),
                     rng.uniform(-np.pi, np.pi, n)], -1).astype(np.float32)


def grid_anchors(size):
    sizes = [(-(-size // s), -(-size // s)) for s in ANCHOR_CFG['strides']]
    return torch.cat(
        RotatedAnchorGenerator(**ANCHOR_CFG).grid_priors(sizes), 0).numpy()


def dota_like(size=128, g=8, valid=3, seed=0):
    """The anchors of a ``size`` px image and a padded gt set: ``valid``
    boxes near anchors, one exact copy of an anchor, zero boxes after."""
    anchors = grid_anchors(size)
    rng = np.random.default_rng(seed)
    gts = np.zeros((g, 5), np.float32)
    pick = rng.choice(len(anchors), valid, replace=False)
    gts[:valid] = anchors[pick]
    gts[1:valid, :2] += rng.uniform(-4, 4, (valid - 1, 2))
    gts[1:valid, 2:4] *= rng.uniform(0.7, 1.4, (valid - 1, 2))
    gts[1:valid, 4] = rng.uniform(-1.5, 1.5, valid - 1)
    return anchors, gts


@pytest.mark.parametrize('mode', ['iou', 'iof'])
def test_matrix_plain_matches_jnp(mode):
    b1, b2 = random_boxes(40, 0), random_boxes(300, 1)
    got = box_iou_rotated_matrix_plain(torch.from_numpy(b1),
                                       torch.from_numpy(b2), mode)
    ref = np.asarray(j_box_iou_rotated(jnp.asarray(b1), jnp.asarray(b2),
                                       mode=mode))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


def test_matrix_plain_matches_pallas_interpret():
    b1, b2 = random_boxes(24, 7), random_boxes(150, 8)
    got = box_iou_rotated_matrix_plain(torch.from_numpy(b1),
                                       torch.from_numpy(b2))
    pal = np.asarray(box_iou_rotated_pallas_interpret(jnp.asarray(b1),
                                                      jnp.asarray(b2)))
    np.testing.assert_allclose(got.numpy(), pal, atol=2e-3)


def test_matrix_dota_like_anchors():
    """Grid anchors x padded gts: an identical pair is 1, zero-size padded
    rows are exactly 0 and finite, and the whole matrix matches jnp."""
    anchors, gts = dota_like()
    got = box_iou_rotated_matrix(torch.from_numpy(gts),
                                 torch.from_numpy(anchors)).numpy()
    ref = np.asarray(j_box_iou_rotated(jnp.asarray(gts),
                                       jnp.asarray(anchors)))
    np.testing.assert_allclose(got, ref, atol=1e-5)
    assert np.isfinite(got).all()
    assert abs(got[0].max() - 1.0) < 1e-4          # the copied anchor
    assert (got[3:] == 0).all()                    # padded zero boxes
    assert (got == 0).mean() > 0.5                 # most pairs out of reach


def test_clamped_boxes_far_from_origin():
    """1e-3-sized (clamped) boxes at x ~ 1000 next to ordinary ones: the
    pair-midpoint frame keeps float32 exact enough there."""
    b1 = np.array([[1000.0, 1000.0, 0.0, 0.0, 0.3],
                   [1000.0, 1000.0, 20.0, 10.0, 0.3],
                   [1003.0, 998.0, 1e-4, 30.0, -0.7]], np.float32)
    b2 = np.concatenate([b1, random_boxes(50, 3, extent=40.0) + np.array(
        [980.0, 980.0, 0, 0, 0], np.float32)])
    got = rbbox_overlaps(torch.from_numpy(b1), torch.from_numpy(b2)).numpy()
    ref = np.asarray(j_rbbox_overlaps(jnp.asarray(b1), jnp.asarray(b2)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    assert got[1, 1] > 0.999


@pytest.mark.parametrize('batched', ['neither', 'first', 'second', 'both'])
@pytest.mark.parametrize('mode', ['iou', 'iof'])
def test_blocked_equals_unblocked(batched, mode):
    """Blocks over either axis, batched or shared sets: bit-identical to one
    unblocked call (which is the differentiable ``box_iou_rotated``)."""
    b1 = torch.from_numpy(random_boxes(2 * 37, 4).reshape(2, 37, 5))
    b2 = torch.from_numpy(random_boxes(2 * 90, 5).reshape(2, 90, 5))
    if batched in ('neither', 'second'):
        b1 = b1[0].contiguous()
    if batched in ('neither', 'first'):
        b2 = b2[0].contiguous()
    ref = box_iou_rotated(b1, b2, mode)     # an unbatched set broadcasts
    for x, y, r in ((b1, b2, ref), (b2, b1, None)):
        got = box_iou_rotated_matrix_plain(x, y, mode, max_pairs=500)
        if r is None:
            r = box_iou_rotated_matrix_plain(x, y, mode, max_pairs=1 << 30)
        assert got.shape == r.shape
        assert torch.equal(got, r)
    # the wrapper takes the plain version for CPU tensors, without a launch
    before = box_iou_rotated_matrix.launches
    assert torch.equal(box_iou_rotated_matrix(b1, b2, mode), ref)
    assert box_iou_rotated_matrix.launches == before


@pytest.mark.parametrize('mode', ['iou', 'iof'])
@pytest.mark.parametrize('aligned', [False, True])
def test_rbbox_overlaps_matches_jax(mode, aligned):
    n = 60
    b1, b2 = random_boxes(n, 10), random_boxes(n if aligned else 45, 11)
    b1[:5, 2:4] = 0.0                               # clamped to 1e-3
    got = rbbox_overlaps(torch.from_numpy(b1), torch.from_numpy(b2), mode,
                         is_aligned=aligned)
    ref = np.asarray(j_rbbox_overlaps(jnp.asarray(b1), jnp.asarray(b2),
                                      mode=mode, is_aligned=aligned))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


def test_rbbox_overlaps_six_columns_and_empty():
    b1, b2 = random_boxes(12, 20), random_boxes(9, 21)
    with_score = np.concatenate([b1, np.ones((12, 1), np.float32)], -1)
    got = rbbox_overlaps(torch.from_numpy(with_score), torch.from_numpy(b2))
    ref = rbbox_overlaps(torch.from_numpy(b1), torch.from_numpy(b2))
    assert torch.equal(got, ref)
    empty = torch.zeros((0, 5))
    assert rbbox_overlaps(empty, torch.from_numpy(b2)).shape == (0, 9)
    assert rbbox_overlaps(torch.from_numpy(b1), empty).shape == (12, 0)
    assert rbbox_overlaps(empty, empty, is_aligned=True).shape == (0,)


def test_rbbox_overlaps_keeps_gradient():
    """Inputs that require a gradient take the differentiable plain
    function, not the matrix wrapper."""
    b1 = torch.tensor([[50., 50., 20., 10., 0.3]], requires_grad=True)
    b2 = torch.tensor([[52., 51., 18., 12., 0.5]])
    rbbox_overlaps(b1, b2).sum().backward()
    assert torch.isfinite(b1.grad).all() and b1.grad[0, 0] > 0
    with torch.no_grad():
        assert not rbbox_overlaps(b1, b2).requires_grad


def test_matrix_rejects_bad_inputs():
    b = torch.from_numpy(random_boxes(4, 0))
    with pytest.raises(ValueError):
        box_iou_rotated_matrix(b, b, mode='giou')
    with pytest.raises(ValueError):
        box_iou_rotated_matrix(b.double(), b)
    with pytest.raises(ValueError):
        box_iou_rotated_matrix(b[:, :4], b)
    with pytest.raises(ValueError):
        box_iou_rotated_matrix(b[None].repeat(2, 1, 1),
                               b[None].repeat(3, 1, 1))


def zero_boxes_at_origin():
    """Four zero boxes at the origin and two real boxes, against 512-px
    anchors (square and 1:2, turned) whose centres lie within 256 px of
    the origin: every zero box is in reach of them by its centre, and only
    its area takes it out of reach."""
    rng = np.random.default_rng(40)
    xs, ys = np.meshgrid(np.arange(-256.0, 257.0, 64.0),
                         np.arange(-256.0, 257.0, 64.0))
    k = xs.size
    anchors = np.stack([xs.ravel(), ys.ravel(),
                        np.where(np.arange(k) % 2, 362.0, 512.0),
                        np.where(np.arange(k) % 2, 724.0, 512.0),
                        rng.uniform(-np.pi / 2, np.pi / 2, k)], -1)
    gts = np.zeros((6, 5))
    gts[4] = [10.0, -20.0, 60.0, 30.0, 0.4]
    gts[5] = [200.0, 180.0, 40.0, 90.0, -1.1]
    return (torch.from_numpy(gts.astype(np.float32)),
            torch.from_numpy(anchors.astype(np.float32)))


@pytest.mark.parametrize('gts_first', [True, False])
@pytest.mark.parametrize('mode', ['iou', 'iof'])
def test_plain_matrix_is_zero_out_of_reach_zero_boxes(gts_first, mode):
    """The kernel rejects every pair that ``pairs_in_reach`` rejects and
    writes 0 there: the plain matrix must be exactly 0 at those pairs, here
    zero boxes at the origin that the reach test alone would keep."""
    gts, anchors = zero_boxes_at_origin()
    b1, b2 = (gts, anchors) if gts_first else (anchors, gts)
    live = pairs_in_reach(b1, b2)
    got = box_iou_rotated_matrix_plain(b1, b2, mode)
    assert gts[:4].abs().max() == 0
    reach = 0.5 * (anchors[:, 2] + anchors[:, 3])
    assert (anchors[:, :2].abs().amax(1) <= reach).all()   # centres reach
    gt_rows = live[:4] if gts_first else live[:, :4].T
    assert not gt_rows.any()
    assert live.any()                             # the real boxes reach
    assert (got[~live] == 0).all()
    assert (got[live] > 0).any()


def test_plain_matrix_is_zero_out_of_reach_loader_padding():
    """A G = 512 gt set as the JAX loader pads it (``max_gt`` 512), 20 valid
    boxes and 492 zero rows, on a small anchor grid: exactly 0 wherever
    ``pairs_in_reach`` is False, in both orientations."""
    anchors, gts = dota_like(size=64, g=512, valid=20, seed=41)
    anchors, gts = torch.from_numpy(anchors), torch.from_numpy(gts)
    got = box_iou_rotated_matrix_plain(gts, anchors)
    live = pairs_in_reach(gts, anchors)
    assert got.shape == live.shape == (512, anchors.shape[0])
    assert not live[20:].any() and live[:20].any()
    assert (got[~live] == 0).all()
    iof = box_iou_rotated_matrix_plain(anchors, gts, 'iof')
    assert (iof[~pairs_in_reach(anchors, gts)] == 0).all()


@pytest.mark.parametrize('shape1,shape2,mode,flags', [
    ((8, 32, 5), (1000, 5), 'iou', (8, 32, 1000, 1, 0, 0, 1)),
    ((1000, 5), (8, 32, 5), 'iof', (8, 32, 1000, 1, 0, 1, 0)),
    ((7, 5), (3, 7, 5), 'iou', (3, 7, 7, 0, 1, 0, 1)),
    ((2, 9, 5), (2, 4, 5), 'iof', (2, 4, 9, 1, 1, 1, 0)),
])
def test_matrix_layout(shape1, shape2, mode, flags):
    """The shorter set are the kernel's rows: the C entry point's ints, and
    which tensor is which."""
    b1, b2 = torch.zeros(shape1), torch.zeros(shape2)
    rows, cols, got = matrix_layout(b1, b2, mode)
    assert got == flags
    assert (rows, cols) == ((b1, b2) if flags[-1] else (b2, b1))


@pytest.mark.parametrize('version', ['oc', 'le90', 'le135'])
def test_obb2hbb_matches_jax(version):
    from orientedobjectdetection_tpu.ops.boxes import obb2hbb as j_obb2hbb
    b = random_boxes(64, 30)
    if version == 'oc':
        b[:, 4] = np.random.default_rng(1).uniform(0.01, np.pi / 2, 64)
    got = obb2hbb(torch.from_numpy(b), version).numpy()
    np.testing.assert_allclose(got, np.asarray(j_obb2hbb(jnp.asarray(b),
                                                         version)),
                               rtol=1e-5, atol=1e-5)
