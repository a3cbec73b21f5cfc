"""Port parity, label assignment: the batched ``MaxIoUAssigner`` against
the JAX package's per-image one on the same numpy inputs.

``assigned_gt_inds`` and ``labels`` must be equal; ``max_overlaps`` within
1e-5 (float32 IoU, element-wise). Inputs keep every IoU further than 1e-4
from a threshold, so a float32 rounding difference between the two
packages cannot flip an assignment; exact ties are built from repeated
boxes, where both packages compute the same bits."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orientedobjectdetection_tpu.core.anchors import \
    anchor_inside_flags as j_inside_flags
from orientedobjectdetection_tpu.core.assigners import \
    MaxIoUAssigner as JAssigner
from orientedobjectdetection_torch.core import (MaxIoUAssigner,
                                                RotatedAnchorGenerator,
                                                anchor_inside_flags)
from orientedobjectdetection_torch.core.assigners import IGNORE, NEG
from orientedobjectdetection_torch.utils.registry import BBOX_ASSIGNERS

torch.set_num_threads(1)

ANCHOR_CFG = dict(octave_base_scale=4, scales_per_octave=3,
                  ratios=[1.0, 0.5, 2.0], strides=[8, 16, 32, 64, 128])
SIZE = 128
THRESHOLDS = (0.3, 0.4, 0.5)


def anchors_np():
    sizes = [(-(-SIZE // s), -(-SIZE // s)) for s in ANCHOR_CFG['strides']]
    return torch.cat(RotatedAnchorGenerator(**ANCHOR_CFG).grid_priors(sizes),
                     0).numpy()


def padded_gts(bsz, g, valid, seed, hbb=None):
    """(B, G, 5) gts near anchors, labels, mask; image b has valid[b] real
    boxes. A box is drawn again while its IoU with any anchor (taken on its
    circumscribed horizontal box when ``hbb`` names an angle version) lies
    within 1e-4 of a threshold, or while its two best anchors are closer
    than 1e-5 without being equal."""
    from orientedobjectdetection_torch.ops import box_iou_rotated, obb2hbb
    rng = np.random.default_rng(seed)
    anchors = anchors_np()
    gts = np.zeros((bsz, g, 5), np.float32)
    for b in range(bsz):
        for i in range(valid[b]):
            while True:
                a = anchors[rng.integers(len(anchors))]
                angle = rng.uniform(0.05, 1.5) if hbb == 'oc' \
                    else rng.uniform(-1.5, 1.5)
                box = torch.tensor([[a[0] + rng.uniform(-6, 6),
                                     a[1] + rng.uniform(-6, 6),
                                     a[2] * rng.uniform(0.6, 1.5),
                                     a[3] * rng.uniform(0.6, 1.5), angle]],
                                   dtype=torch.float32)
                iou = box_iou_rotated(box if hbb is None
                                      else obb2hbb(box, hbb),
                                      torch.from_numpy(anchors))[0]
                top = iou.topk(2).values
                if all((iou - t).abs().min() > 1e-4 for t in THRESHOLDS) \
                        and top[0] - top[1] > 1e-5:
                    break
            gts[b, i] = box[0].numpy()
    labels = rng.integers(0, 4, (bsz, g)).astype(np.int32)
    mask = np.arange(g)[None, :] < np.asarray(valid)[:, None]
    return anchors, gts, labels, mask


def run_both(cfg, anchors, gts, labels, mask, ign=None, ign_mask=None):
    """The port's one batched call and the JAX assigner image by image."""
    t = lambda x: None if x is None else torch.from_numpy(np.asarray(x))
    got = MaxIoUAssigner(**cfg)(t(anchors), t(gts), t(labels), t(mask),
                                t(ign), t(ign_mask))
    j_assigner = JAssigner(**cfg)
    fn = jax.jit(lambda *a: tuple(j_assigner(*a)))
    for b in range(gts.shape[0]):
        extra = () if ign is None else (ign[b], ign_mask[b])
        ref = fn(anchors, gts[b], labels[b], mask[b], *extra)
        np.testing.assert_array_equal(got.assigned_gt_inds[b].numpy(),
                                      np.asarray(ref[0]), err_msg=f'img {b}')
        np.testing.assert_allclose(got.max_overlaps[b].numpy(),
                                   np.asarray(ref[1]), atol=1e-5)
        np.testing.assert_array_equal(got.labels[b].numpy(),
                                      np.asarray(ref[2]))
    return got


BASE = dict(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0,
            ignore_iof_thr=-1)


@pytest.mark.parametrize('cfg', [
    BASE,
    dict(BASE, neg_iou_thr=(0.0, 0.3)),
    dict(BASE, match_low_quality=False),
    dict(BASE, gt_max_assign_all=False),
    dict(BASE, min_pos_iou=0.3),
    dict(BASE, assign_by_circumhbbox='le90'),
    dict(BASE, assign_by_circumhbbox='oc', gt_max_assign_all=False),
], ids=['retina', 'neg-range', 'no-low-quality', 'first-best-only',
        'min-pos-0.3', 'circumhbbox-le90', 'circumhbbox-oc-first-best'])
def test_max_iou_assigner_matches_jax(cfg):
    anchors, gts, labels, mask = padded_gts(
        3, 8, (3, 0, 8), seed=1, hbb=cfg.get('assign_by_circumhbbox'))
    got = run_both(cfg, anchors, gts, labels, mask)
    assert (got.assigned_gt_inds[0] >= 0).any()
    # image 1 has no valid gt: every prior is a plain negative
    assert (got.assigned_gt_inds[1] == NEG).all()
    assert (got.labels[1] == -1).all()


def test_gt_that_touches_nothing_and_ties():
    """With min_pos_iou=0 a valid gt outside the image has max IoU 0 and
    claims every zero-overlap prior; with two such gts and with duplicated
    gts the highest gt index wins, and argmax ties go to the lowest."""
    anchors, gts, labels, mask = padded_gts(2, 8, (2, 3), seed=2)
    gts[0, 2] = [5000., 5000., 30., 20., 0.2]       # touches nothing
    gts[0, 3] = [9000., 5000., 30., 20., 0.2]       # neither
    mask[0, 2:4] = True
    gts[1, 3] = gts[1, 0]                           # exact duplicates
    gts[1, 4] = gts[1, 0]
    mask[1, 3:5] = True
    got = run_both(BASE, anchors, gts, labels, mask)
    inds = got.assigned_gt_inds
    untouched = got.max_overlaps[0] == 0
    assert untouched.any() and (inds[0][untouched] == 3).all()
    # positives of the duplicated gt: low-quality claims go to the highest
    # duplicate (4); plain argmax positives stay with the lowest (0)
    dup = (inds[1] == 0) | (inds[1] == 3) | (inds[1] == 4)
    assert dup.any() and not (inds[1] == 3).any()
    assert (inds[1] == 4).any()
    no_low = MaxIoUAssigner(**dict(BASE, match_low_quality=False))(
        torch.from_numpy(anchors), torch.from_numpy(gts[1]),
        torch.from_numpy(labels[1]), torch.from_numpy(mask[1]))
    assert not ((no_low.assigned_gt_inds == 3) |
                (no_low.assigned_gt_inds == 4)).any()


def test_argmax_ties_go_to_the_lowest_index():
    x = torch.tensor([[0.0, 0.7, 0.2], [0.0, 0.7, 0.2], [0.0, 0.1, 0.2]])
    assert x.max(dim=0).indices.tolist() == [0, 0, 0]
    assert x.argmax(dim=0).tolist() == np.asarray(
        jnp.asarray(x.numpy()).argmax(0)).tolist()


def test_ignore_regions():
    """Mirror of the JAX suite's ignore-region case, then a batched one
    against the JAX assigner with padded ignore boxes."""
    assigner = MaxIoUAssigner(pos_iou_thr=0.5, neg_iou_thr=0.4,
                              min_pos_iou=0, ignore_iof_thr=0.5)
    anchors = torch.tensor([[50., 50., 20., 20., 0.],
                            [150., 150., 20., 20., 0.],
                            [250., 250., 20., 20., 0.]])
    res = assigner(anchors, torch.tensor([[50., 50., 20., 20., 0.]]),
                   torch.tensor([3]), torch.ones(1, dtype=torch.bool),
                   gt_bboxes_ignore=torch.tensor(
                       [[150., 150., 30., 30., 0.]]),
                   gt_ignore_mask=torch.ones(1, dtype=torch.bool))
    assert res.assigned_gt_inds.tolist() == [0, IGNORE, NEG]
    assert res.labels.tolist() == [3, -1, -1]

    anchors, gts, labels, mask = padded_gts(2, 8, (3, 2), seed=3)
    ign = np.zeros((2, 4, 5), np.float32)
    ign[0, 0] = [40., 40., 50., 30., 0.4]
    ign[0, 1] = [100., 90., 30., 30., -0.3]
    ign[1, 0] = [64., 64., 20., 60., 1.0]
    ign[1, 1] = [20., 100., 40., 40., 0.0]          # masked out below
    ign_mask = np.array([[1, 1, 0, 0], [1, 0, 0, 0]], bool)
    cfg = dict(BASE, ignore_iof_thr=0.5)
    got = run_both(cfg, anchors, gts, labels, mask, ign, ign_mask)
    plain = run_both(BASE, anchors, gts, labels, mask)
    newly = (got.assigned_gt_inds == IGNORE) & \
        (plain.assigned_gt_inds != IGNORE)
    assert newly[0].any() and newly[1].any()


def test_assigner_registry_and_plain_flag():
    a = BBOX_ASSIGNERS.build(dict(type='MaxIoUAssigner', plain_iou=True,
                                  **BASE))
    anchors, gts, labels, mask = padded_gts(1, 8, (2,), seed=4)
    args = [torch.from_numpy(x) for x in (anchors, gts, labels, mask)]
    ref = MaxIoUAssigner(**BASE)(*args)
    for x, y in zip(a(*args), ref):
        assert torch.equal(x, y)


@pytest.mark.parametrize('border', [-1, 0, 16])
def test_anchor_inside_flags_matches_jax(border):
    anchors = anchors_np()
    valid = np.random.default_rng(0).random(len(anchors)) > 0.1
    got = anchor_inside_flags(torch.from_numpy(anchors),
                              torch.from_numpy(valid), (100, 120), border)
    ref = j_inside_flags(jnp.asarray(anchors), jnp.asarray(valid),
                         (100, 120), border)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
