"""Port parity, the parts of the point-set heads: the assigners
(``ConvexAssigner``, ``MaxConvexIoUAssigner``, the point-set ATSS-KLD,
``SASAssigner`` and the box ``ATSSKldAssigner``), batched over images in
the port and run image by image in the JAX package; the losses
(``ConvexGIoULoss``, ``BCConvexGIoULoss``, ``KLDRepPointsLoss``,
``SpatialBorderLoss``) with their gradients; and the selection helpers
(``rank_in_group``, ``sampling_edge_points``, ``chamfer_quality``,
``_focal_elementwise``).

Assignments equal, with exact ties on purpose: duplicated point sets, gt
centres halfway between grid points (the lowest index wins in both);
overlaps at atol 1e-5; losses at rtol 1e-5; gradients at rtol 1e-4 with a
floor of 1e-6 of each tensor's largest entry."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orientedobjectdetection_tpu.core import assigners as j_assigners
from orientedobjectdetection_tpu.models.dense_heads import \
    rotated_reppoints_head as j_rp
from orientedobjectdetection_tpu.models.losses import \
    kld_reppoints_loss as j_kld
from orientedobjectdetection_tpu.models.losses import \
    spatial_border_loss as j_sb
from orientedobjectdetection_tpu.ops import boxes as j_boxes
from orientedobjectdetection_torch.core.anchors import MlvlPointGenerator
from orientedobjectdetection_torch.core.assigners import (ATSSKldAssigner,
                                                          SASAssigner)
from orientedobjectdetection_torch.models.dense_heads import \
    rotated_reppoints_head as rp
from orientedobjectdetection_torch.models.losses import (KLDRepPointsLoss,
                                                         SpatialBorderLoss)

torch.set_num_threads(1)

SIZE = 128
STRIDES = [8, 16, 32, 64, 128]
SIZES = [(SIZE // s, SIZE // s) for s in STRIDES]


def t(a):
    return torch.from_numpy(np.array(a))


def gts(rng, bsz=2, g=8, valid=5, classes=3, lo=12, hi=70):
    obb = np.stack([rng.uniform(20, SIZE - 20, (bsz, g)),
                    rng.uniform(20, SIZE - 20, (bsz, g)),
                    rng.uniform(lo, hi, (bsz, g)),
                    rng.uniform(lo, hi, (bsz, g)),
                    rng.uniform(-0.7, 0.7, (bsz, g))], -1).astype(np.float32)
    mask = np.arange(g)[None].repeat(bsz, 0) < valid
    obb[~mask] = 0
    labels = rng.integers(0, classes, (bsz, g)).astype(np.int32)
    return obb, labels, mask


def polys_of(obb):
    return np.asarray(j_boxes.obb2poly(jnp.asarray(obb)))


def point_sets_near(rng, polys, n, spread=10.0):
    """(B, n, 18) point sets around the gts' centres and elsewhere, the last
    four copies of four earlier ones (exact IoU ties)."""
    bsz, g = polys.shape[:2]
    ctr = polys.reshape(bsz, g, 4, 2).mean(2)
    which = rng.integers(0, 5, (bsz, n))
    base = np.take_along_axis(ctr, which[..., None], 1)
    base = base + rng.normal(0, 8, (bsz, n, 2))
    base[:, n // 2:] = rng.uniform(10, SIZE - 10, (bsz, n - n // 2, 2))
    sets = base[:, :, None] + rng.normal(0, 1, (bsz, n, 9, 2)) * \
        rng.uniform(0.3, 1.0, (bsz, n, 1, 2)) * spread
    sets[:, -4:] = sets[:, 3:7]
    return sets.reshape(bsz, n, 18).astype(np.float32)


# ---- assigners --------------------------------------------------------------
@pytest.mark.parametrize('pos_num', [1, 3])
def test_convex_assigner_matches_jax(pos_num):
    """Nearest points of the gt's level: the same claims, positives and
    labels; gts centred halfway between grid points tie in exact arithmetic
    and go to the lowest index in both."""
    rng = np.random.default_rng(pos_num)
    obb, labels, mask = gts(rng)
    obb[0, 0, :2] = (32.0, 40.0)                # on a cell corner: 4 ties
    obb[1, 1, :2] = (48.0, 52.0)
    polys = polys_of(obb)
    pts = MlvlPointGenerator(STRIDES).grid_priors(SIZES, 'cpu')
    xy = torch.cat(pts)
    lvl = torch.cat([torch.full((len(p),), int(np.log2(s)))
                     for p, s in zip(pts, STRIDES)])
    got = rp.ConvexAssigner(scale=4, pos_num=pos_num)(
        xy, lvl, t(polys), t(labels), t(mask), 3)
    ja = j_rp.ConvexAssigner(scale=4, pos_num=pos_num)
    ref = jax.jit(jax.vmap(lambda p, gl, gm: ja(
        jnp.asarray(xy.numpy()), jnp.asarray(lvl.numpy()), p, gl, gm, 3)))(
            polys, labels, mask)
    best, pos, lab = (np.asarray(r) for r in ref)
    assert pos.sum() >= (pos_num * 5 if pos_num == 1 else 20)
    np.testing.assert_array_equal(got[1].numpy(), pos)
    np.testing.assert_array_equal(got[2].numpy(), lab)
    np.testing.assert_array_equal(got[0].numpy()[pos], best[pos])


@pytest.mark.parametrize('assign_all', [True, False])
def test_max_convex_iou_assigner_matches_jax(assign_all):
    """The same positives, negatives, labels and gts of positives;
    overlaps at atol 1e-5; duplicated point sets tie at a gt's best IoU and
    are both claimed (or the first only, without ``gt_max_assign_all``)."""
    rng = np.random.default_rng(10 + assign_all)
    obb, labels, mask = gts(rng)
    polys = polys_of(obb)
    sets = point_sets_near(rng, polys, 64)
    kw = dict(pos_iou_thr=0.4, neg_iou_thr=0.3, min_pos_iou=0.0,
              gt_max_assign_all=assign_all)
    got = rp.MaxConvexIoUAssigner(**kw)(t(sets), t(polys), t(labels),
                                        t(mask), 3)
    ja = j_rp.MaxConvexIoUAssigner(**kw)
    ref = [np.asarray(r) for r in jax.jit(jax.vmap(
        lambda s, p, gl, gm: ja(s, p, gl, gm, 3)))(sets, polys, labels,
                                                    mask)]
    pos = ref[1]
    assert 0 < pos.sum() < pos.size and ref[2].sum() > 0
    for g, r, name in zip(got[1:4], ref[1:4], ('pos', 'neg', 'labels')):
        np.testing.assert_array_equal(g.numpy(), r, err_msg=name)
    np.testing.assert_array_equal(got[0].numpy()[pos], ref[0][pos])
    np.testing.assert_allclose(got[4].numpy(), ref[4], rtol=0, atol=1e-5)


def test_atss_kld_points_assigner_matches_jax():
    """G-RepPoints' refine assigner: the same positives, labels and gts of
    positives; the KLD qualities at rtol 1e-5."""
    rng = np.random.default_rng(20)
    obb, labels, mask = gts(rng)
    polys = polys_of(obb)
    sets = point_sets_near(rng, polys, 80)
    levels = [48, 20, 12]
    got = rp.ATSSKldPointsAssigner(topk=9)(t(sets), levels, t(polys),
                                           t(labels), t(mask), 3)
    ja = j_rp.ATSSKldPointsAssigner(topk=9)
    ref = [np.asarray(r) for r in jax.jit(jax.vmap(
        lambda s, p, gl, gm: ja(s, levels, p, gl, gm, 3)))(sets, polys,
                                                            labels, mask)]
    pos = ref[1]
    assert pos.sum() > 5
    for g, r, name in zip(got[1:4], ref[1:4], ('pos', 'neg', 'labels')):
        np.testing.assert_array_equal(g.numpy(), r, err_msg=name)
    np.testing.assert_array_equal(got[0].numpy()[pos], ref[0][pos])
    np.testing.assert_allclose(got[4].numpy(), ref[4], rtol=1e-5, atol=1e-7)


def test_sas_assigner_matches_jax():
    """SASM's assigner: the same assigned gts (-1 negative) and labels;
    max overlaps at atol 1e-5."""
    rng = np.random.default_rng(30)
    obb, labels, mask = gts(rng)
    polys = polys_of(obb)
    sets = point_sets_near(rng, polys, 80, spread=14.0)
    levels = [48, 20, 12]
    got = SASAssigner(topk=9)(t(sets), levels, t(polys), t(labels), t(mask))
    ja = j_assigners.SASAssigner(topk=9)
    ref = jax.jit(jax.vmap(lambda s, p, gl, gm: ja(s, levels, p, gl, gm)))(
        sets, polys, labels, mask)
    inds = np.asarray(ref.assigned_gt_inds)
    assert (inds >= 0).sum() > 5
    np.testing.assert_array_equal(got.assigned_gt_inds.numpy(), inds)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
    np.testing.assert_allclose(got.max_overlaps.numpy(),
                               np.asarray(ref.max_overlaps), rtol=0,
                               atol=1e-5)


def test_atss_kld_assigner_matches_jax():
    """The box ``ATSSKldAssigner`` (registered; the point-set configs map to
    the point-set form): on RetinaNet-like priors, the same assignments
    and labels, max overlaps at rtol 1e-5."""
    rng = np.random.default_rng(40)
    obb, labels, mask = gts(rng, lo=16, hi=60)
    pts = MlvlPointGenerator(STRIDES[:3]).grid_priors(SIZES[:3], 'cpu')
    levels = [len(p) for p in pts]
    xy = torch.cat(pts).numpy()
    size = np.repeat(np.asarray(STRIDES[:3], np.float32) * 4, levels)
    priors = np.concatenate([xy, size[:, None], size[:, None],
                             np.zeros((len(xy), 1), np.float32)], 1)
    got = ATSSKldAssigner(topk=9)(t(priors), levels, t(obb), t(labels),
                                  t(mask))
    ja = j_assigners.ATSSKldAssigner(topk=9)
    ref = jax.jit(jax.vmap(lambda g, gl, gm: ja(
        jnp.asarray(priors), levels, g, gl, gm)))(obb, labels, mask)
    inds = np.asarray(ref.assigned_gt_inds)
    assert (inds >= 0).sum() > 10
    np.testing.assert_array_equal(got.assigned_gt_inds.numpy(), inds)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
    np.testing.assert_allclose(got.max_overlaps.numpy(),
                               np.asarray(ref.max_overlaps), rtol=1e-5)


# ---- losses -----------------------------------------------------------------
def loss_inputs(seed, n=48):
    """Point sets near their own target polygons (aligned), weights and an
    average factor."""
    rng = np.random.default_rng(seed)
    obb, _, _ = gts(rng, bsz=1, g=n, valid=n)
    polys = polys_of(obb[0])
    ctr = polys.reshape(n, 4, 2).mean(1)
    sets = ctr[:, None] + rng.normal(0, 1, (n, 9, 2)) * \
        rng.uniform(3, 25, (n, 1, 2))
    sets = sets.reshape(n, 18).astype(np.float32)
    weight = (rng.random(n) < 0.7).astype(np.float32)
    return sets, polys, weight


def check_loss(port_loss, j_loss, sets, polys, weight):
    """Value at rtol 1e-5; gradient in the points at rtol 1e-4 with a floor
    of 1e-6 of its largest entry."""
    pts = t(sets).requires_grad_()
    got = port_loss(pts, t(polys), weight=t(weight), avg_factor=7.0)
    ref = jax.jit(lambda s: j_loss(s, polys, weight=weight,
                                   avg_factor=7.0))(sets)
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    got.backward()
    j_grad = np.asarray(jax.jit(jax.grad(lambda s: j_loss(
        s, polys, weight=weight, avg_factor=7.0)))(sets))
    assert np.abs(j_grad).max() > 0
    np.testing.assert_allclose(pts.grad.numpy(), j_grad, rtol=1e-4,
                               atol=1e-6 * np.abs(j_grad).max())
    return float(ref)


@pytest.mark.parametrize('name', ['ConvexGIoULoss', 'BCConvexGIoULoss'])
def test_convex_giou_losses_match_jax(name):
    sets, polys, weight = loss_inputs(50)
    value = check_loss(getattr(rp, name)(loss_weight=0.375),
                       getattr(j_rp, name)(loss_weight=0.375), sets, polys,
                       weight)
    assert value > 0


def test_kld_reppoints_loss_matches_jax():
    """G-RepPoints' loss (a Gaussian fitted to each point set)."""
    sets, polys, weight = loss_inputs(51)
    assert check_loss(KLDRepPointsLoss(), j_kld.KLDRepPointsLoss(), sets,
                      polys, weight) > 0


def test_spatial_border_loss_matches_jax():
    """Oriented RepPoints' border loss: each point set against its own
    polygon only (the JAX package's (N, N) diagonal, at N = 48), points
    inside and outside."""
    sets, polys, weight = loss_inputs(52)
    assert check_loss(SpatialBorderLoss(loss_weight=0.1),
                      j_sb.SpatialBorderLoss(loss_weight=0.1), sets, polys,
                      weight) > 0


# ---- selection helpers ------------------------------------------------------
def test_rank_in_group_matches_jax():
    """Ranks within groups, batched over two rows, with tied qualities (the
    lowest index ranks first) and invalid elements (rank N)."""
    rng = np.random.default_rng(60)
    n, groups = 200, 12
    gid = rng.integers(0, groups, (2, n))
    q = rng.integers(0, 15, (2, n)).astype(np.float32) / 4
    valid = rng.random((2, n)) < 0.8
    got = rp.rank_in_group(t(gid), t(q), t(valid), groups)
    ref = np.stack([np.asarray(jax.jit(
        lambda a, b, c: j_rp.rank_in_group(a, b, c, groups))(
            gid[i], q[i], valid[i])) for i in range(2)])
    np.testing.assert_array_equal(got.numpy(), ref)


def test_edge_points_and_chamfer_quality_match_jax():
    """Edge samples at rtol 1e-6 (a few float32 steps of a coordinate: the
    jitted interpolation fuses its products); the chamfer quality at rtol
    1e-5, batched (2, 30) polygons."""
    rng = np.random.default_rng(61)
    a = polys_of(gts(rng, g=30, valid=30)[0])
    b = polys_of(gts(rng, g=30, valid=30)[0])
    np.testing.assert_allclose(
        rp.sampling_edge_points(t(a)).numpy(),
        np.asarray(jax.jit(j_rp.sampling_edge_points)(a)), rtol=1e-6,
        atol=1e-6)
    np.testing.assert_allclose(
        rp.chamfer_quality(t(a), t(b)).numpy(),
        np.asarray(jax.jit(j_rp.chamfer_quality)(a, b)), rtol=1e-5)


def test_focal_elementwise_matches_jax():
    """The per-element focal quality over (2, 50) logits, background label
    = num_classes, at rtol 1e-5."""
    rng = np.random.default_rng(62)
    logits = rng.normal(0, 2, (2, 50, 4)).astype(np.float32)
    labels = rng.integers(0, 5, (2, 50))
    np.testing.assert_allclose(
        rp._focal_elementwise(t(logits), t(labels), 4).numpy(),
        np.asarray(jax.jit(lambda x, y: j_rp._focal_elementwise(x, y, 4))(
            logits, labels)), rtol=1e-5, atol=1e-7)
