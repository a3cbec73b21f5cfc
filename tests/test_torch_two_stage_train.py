"""Port parity, Oriented R-CNN training: the samplers and their keys, the
cross-entropy loss, the RPN loss, the RoI sampling, the gather RoIAlign's
gradient, and whole train steps, each against the JAX package on the same
inputs.

The model is ``configs/oriented_rcnn/oriented_rcnn_tiny_synth.py``
(ResNet-18, 64-wide FPN, 2 classes) at 128 px with random numpy weights
carried by ``from_jax_variables``; the batch holds G = 8 padded gts of which
3 are valid. The port cannot reproduce ``jax.random``'s bits, so the tests
replace the port's one source of uniform numbers
(``core.assigners.uniform``) with one that returns the JAX package's draws
for the same keys.

Tolerances: cross entropy 1e-6 (float32 element-wise math); sampled sets,
labels and RoI order exact; RoIs, targets and weights 1e-5; the gather
RoIAlign gradient 1e-4 of its largest value (float32 sums in another
order); losses rtol 1e-4, per-parameter gradients 1e-3 of each tensor's
largest value, parameters after two SGD steps 1e-5 (the network's float32
convolutions sum in another order, as in ``tests/test_torch_train.py``).
"""

import os.path as osp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orientedobjectdetection_tpu.core import assigners as j_assigners
from orientedobjectdetection_tpu.models import build_detector as j_build
from orientedobjectdetection_tpu.models.losses import common as j_losses
from orientedobjectdetection_tpu.ops import boxes as j_boxes
from orientedobjectdetection_tpu.ops.roi_align_rotated import \
    roi_align_rotated as j_roi_align
from orientedobjectdetection_tpu.parallel import train_state as j_ts
from orientedobjectdetection_tpu.utils.config import Config as JConfig
from orientedobjectdetection_tpu.utils.registry import HEADS as JHEADS
from orientedobjectdetection_torch.core import assigners
from orientedobjectdetection_torch.core.assigners import (
    AssignResult, PseudoSampler, RRandomSampler, SampleKey, gt_seed,
    keep_ranked, random_sample_masks, rng_from_gt)
from orientedobjectdetection_torch.models import build_detector
from orientedobjectdetection_torch.models.losses import CrossEntropyLoss
from orientedobjectdetection_torch.ops.roi_align_rotated import \
    roi_align_rotated
from orientedobjectdetection_torch.parallel import (build_lr_schedule,
                                                    build_optimizer,
                                                    create_train_state,
                                                    frozen_mask,
                                                    make_train_step)
from orientedobjectdetection_torch.utils import Config
from orientedobjectdetection_torch.utils.jax_weights import (
    from_jax_variables, to_jax_layout)

torch.set_num_threads(1)

TINY = osp.join(osp.dirname(__file__), '..', 'configs', 'oriented_rcnn',
                'oriented_rcnn_tiny_synth.py')
SIZE = 128
LR_CONFIG = dict(policy='step', step=[8, 11], warmup='linear',
                 warmup_iters=5, warmup_ratio=1.0 / 3)
OPT_CONFIG = dict(type='sgd', momentum=0.9, weight_decay=1e-2)
MAX_NORM = 0.5           # below the gradient norm: the clip is active
BASE_LR = 0.02


# ---- the JAX package's draws for the port's keys ----------------------------
_gt_keys = jax.jit(jax.vmap(j_assigners.rng_from_gt))


def jax_keys(key: SampleKey):
    """The JAX keys that ``key`` stands for, one per image."""
    batch = key.batch_size()
    if key.gt_bboxes is not None:
        roots = _gt_keys(jnp.asarray(key.gt_bboxes.cpu().numpy()))
        keys = [roots[b] for b in range(batch)]
    else:
        keys = [jax.random.fold_in(jax.random.PRNGKey(0), key.step)] * batch
    out = []
    for b, k in enumerate(keys):
        for n, i in key.path:
            k = jax.random.split(k, n)[b if i is None else i]
        out.append(k)
    return out


def jax_uniform(key, n, device):
    return torch.from_numpy(np.stack([
        np.asarray(jax.random.uniform(k, (n,))) for k in jax_keys(key)
    ])).to(device)


@pytest.fixture
def jax_draws(monkeypatch):
    monkeypatch.setattr(assigners, 'uniform', jax_uniform)


# ---- samplers ---------------------------------------------------------------
def test_rng_from_gt_seed_matches_jax():
    """The port's seed is JAX ``rng_from_gt``'s: exactly where the float32
    sum is exact in any order (pixel boxes, angles in 1/64 rad), and within
    that sum's rounding, n ulps of n terms, on arbitrary boxes (XLA's
    summation order is not specified)."""
    rng = np.random.default_rng(0)
    pixel = np.zeros((4, 8, 5), np.float32)
    pixel[:, :5, :4] = rng.integers(1, 128, (4, 5, 4))
    pixel[:, :5, 4] = rng.integers(-100, 100, (4, 5)) / 64.0
    free = rng.uniform(0, 1024, (6, 32, 5)).astype(np.float32)
    free[..., 4] = rng.uniform(-1.5, 1.5, (6, 32))
    fold = jax.jit(jax.vmap(
        lambda s: jax.random.fold_in(jax.random.PRNGKey(0), s)))
    for gts in (pixel, free):
        seeds = gt_seed(torch.from_numpy(gts))
        total = np.abs((gts * np.float32(997)).astype(np.float64).sum((1, 2)))
        spread = np.ceil(gts[0].size * np.spacing(total.astype(np.float32)))
        for seed, key, s in zip(seeds.tolist(), _gt_keys(jnp.asarray(gts)),
                                spread.astype(int)):
            s = s if gts is free else 0
            near = np.flatnonzero((np.asarray(fold(
                jnp.arange(seed - s, seed + s + 1, dtype=jnp.uint32)))
                == np.asarray(key)).all(-1)) - s
            assert len(near) == 1 and (gts is free or near[0] == 0), \
                (seed, near)
    key = rng_from_gt(torch.from_numpy(pixel))
    assert key.batch_size() == 4 and key.path == ()


def test_uniform_is_the_jax_interval_on_the_device_hash():
    """The port's own draws: multiples of 2^-23 in [0, 1), the same for the
    same key, other for another key, image or split."""
    key = SampleKey(step=5).split(3)
    u = assigners.uniform(key.split(2, 0), 20000, 'cpu')
    assert u.shape == (3, 20000) and u.dtype == torch.float32
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert torch.equal(u * 2 ** 23, (u * 2 ** 23).round())
    assert abs(float(u.mean()) - 0.5) < 0.01
    assert torch.equal(u, assigners.uniform(key.split(2, 0), 20000, 'cpu'))
    assert not torch.equal(u[0], u[1])
    for other in (key.split(2, 1), SampleKey(step=6).split(3).split(2, 0)):
        assert not torch.equal(u, assigners.uniform(other, 20000, 'cpu'))
    with pytest.raises(ValueError):
        SampleKey(step=5).batch_size()


def test_keep_ranked_breaks_ties_to_the_lowest_index():
    """Forced ties at the cut: the JAX formulation
    ``argsort(argsort(-scores)) < k`` and the port keep the same set."""
    scores = np.full((2, 40), -1.0, np.float32)
    scores[0, ::2] = 0.5                     # 20 tied candidates
    scores[0, 5] = 0.75
    scores[1, 3:30] = np.repeat([0.25, 0.5, 0.125], 9)
    for limit in (0, 1, 7, 12, 40):
        got = keep_ranked(torch.from_numpy(scores), limit).numpy()
        rank = np.asarray(jnp.argsort(jnp.argsort(-jnp.asarray(scores))))
        np.testing.assert_array_equal(got, (rank < limit) & (scores >= 0))
    got = keep_ranked(torch.from_numpy(scores), torch.tensor([3, 10]))
    assert got[0].nonzero().flatten().tolist() == [0, 2, 5]
    assert got[1].sum() == 10 and got[1, 12:21].all()


@pytest.mark.parametrize('num,fraction,ub', [(256, 0.5, -1), (64, 0.25, -1),
                                            (40, 0.5, 1)])
def test_random_sample_masks_match_jax(jax_draws, num, fraction, ub):
    """50,000 priors per image: ~75 pairs of equal draws each, and few
    positives or negatives in one image."""
    rng = np.random.default_rng(num)
    n = 50000
    pos = rng.uniform(size=(3, n)) < 0.002
    neg = ~pos & (rng.uniform(size=(3, n)) < 0.7)
    pos[2] = False
    pos[2, :5] = True
    neg[1] = False
    neg[1, 100:110] = True
    key = SampleKey(step=7).split(3)
    got = random_sample_masks(torch.from_numpy(pos), torch.from_numpy(neg),
                              num, fraction, key, neg_pos_ub=ub)
    for b, k in enumerate(jax_keys(key)):
        ref = j_assigners.random_sample_masks(
            jnp.asarray(pos[b]), jnp.asarray(neg[b]), num, fraction, k,
            neg_pos_ub=ub)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(r))
    assert got[0].sum(1).tolist()[2] == 5 and got[1][1].sum() == 10


def test_samplers_match_jax(jax_draws):
    rng = np.random.default_rng(3)
    inds = rng.choice([-2, -1, -1, -1, 0, 1, 2], (2, 3000))
    labels = np.where(inds >= 0, rng.integers(0, 5, (2, 3000)), -1)
    result = AssignResult(torch.from_numpy(inds), torch.zeros(2, 3000),
                          torch.from_numpy(labels))
    key = SampleKey(step=2).split(2)
    got = RRandomSampler(num=128, pos_fraction=0.25)(result, key)
    pseudo = PseudoSampler()(result)
    for b, k in enumerate(jax_keys(key)):
        j_result = j_assigners.AssignResult(jnp.asarray(inds[b]),
                                            jnp.zeros(3000),
                                            jnp.asarray(labels[b]))
        ref = j_assigners.RRandomSampler(num=128, pos_fraction=0.25)(
            j_result, k)
        j_pseudo = j_assigners.PseudoSampler()(j_result)
        for g, r in ((got, ref), (pseudo, j_pseudo)):
            for gf, rf in zip(g, r):
                np.testing.assert_array_equal(gf[b].numpy(), np.asarray(rf))
    assert got.pos_mask.sum(1).tolist() == [32, 32]
    assert got.neg_mask.sum(1).tolist() == [96, 96]


# ---- cross entropy ----------------------------------------------------------
@pytest.mark.parametrize('sigmoid', [False, True])
@pytest.mark.parametrize('kw', [dict(), dict(weight=True),
                                dict(weight=True, avg_factor=7.0,
                                     loss_weight=0.5),
                                dict(reduction='sum'),
                                dict(reduction='none', weight=True)])
def test_cross_entropy_matches_jax(sigmoid, kw):
    rng = np.random.default_rng(4)
    pred = rng.normal(0, 3, (2, 50, 6)).astype(np.float32)
    # labels: 0..5 for softmax; sigmoid also takes 6, the background
    target = rng.integers(0, 7 if sigmoid else 6, (2, 50))
    weight = rng.uniform(0, 1, (2, 50)).astype(np.float32)
    args = dict(use_sigmoid=sigmoid, reduction=kw.get('reduction', 'mean'),
                loss_weight=kw.get('loss_weight', 1.0))
    call = dict(avg_factor=kw.get('avg_factor'))
    got = CrossEntropyLoss(**args)(
        torch.from_numpy(pred), torch.from_numpy(target),
        weight=torch.from_numpy(weight) if kw.get('weight') else None,
        **call)
    ref = j_losses.CrossEntropyLoss(**args)(
        jnp.asarray(pred), jnp.asarray(target),
        weight=jnp.asarray(weight) if kw.get('weight') else None, **call)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    if sigmoid:   # targets of pred's shape: the RPN's form
        soft = (rng.uniform(size=pred.shape) < 0.3).astype(np.float32)
        got = CrossEntropyLoss(use_sigmoid=True)(torch.from_numpy(pred),
                                                 torch.from_numpy(soft))
        ref = j_losses.CrossEntropyLoss(use_sigmoid=True)(
            jnp.asarray(pred), jnp.asarray(soft))
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


# ---- the tiny model ---------------------------------------------------------
def perturb_variables(variables, seed):
    """Random numpy values in the flax tree's shapes; the regression outputs
    of both stages are scaled down, as a trained detector's are."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == 'kernel':
            v = rng.normal(0, 1 / np.sqrt(int(np.prod(shape[:-1]))), shape)
            if path[-2].key in ('rpn_reg', 'fc_reg'):
                v = v * 0.05
        elif name == 'scale':
            v = rng.uniform(0.5, 1.5, shape)
        elif name == 'var':
            v = rng.uniform(0.5, 2.0, shape)
        else:                               # bias, mean
            v = rng.normal(0, 0.1, shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, variables)


def make_batch(seed, bsz=2, g=8, valid=3):
    """Images and gts of 20-60 px inside the image, 3 valid of 8, zero
    boxes after. The gts are pixel-aligned (integer centres and sizes,
    angles in 1/64 rad), so the float32 sum that JAX ``rng_from_gt`` folds
    is exact in any order: XLA sums in another order inside another jitted
    program, so on arbitrary gts the JAX package itself derives one key in
    its train step and another in a standalone call."""
    rng = np.random.default_rng(seed)
    gts = np.zeros((bsz, g, 5), np.float32)
    gts[:, :valid] = np.stack([
        rng.integers(30, SIZE - 30, (bsz, valid)),
        rng.integers(30, SIZE - 30, (bsz, valid)),
        rng.integers(20, 60, (bsz, valid)), rng.integers(20, 60, (bsz, valid)),
        rng.integers(-77, 77, (bsz, valid)) / 64.0], -1)
    return dict(
        images=rng.normal(0, 1, (bsz, SIZE, SIZE, 3)).astype(np.float32),
        gt_bboxes=gts,
        gt_labels=rng.integers(0, 2, (bsz, g)).astype(np.int32),
        gt_mask=np.arange(g)[None, :].repeat(bsz, 0) < valid)


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, path + (k,))
        else:
            yield '/'.join(path + (k,)), np.asarray(v)


def j_rng(step):
    return jax.random.fold_in(jax.random.PRNGKey(0), step)


class Run:
    """The tiny Oriented R-CNN in both packages on the same weights: the
    JAX losses and gradients of step 0, and the JAX state after two steps
    of ``make_train_step``."""

    def __init__(self):
        self.jcfg = JConfig.fromfile(TINY)
        self.cfg = Config.fromfile(TINY)
        det = self.jdet = j_build(dict(self.jcfg.model))
        shapes = jax.eval_shape(det.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, SIZE, SIZE, 3), jnp.float32))
        self.variables = perturb_variables(shapes, 31)
        self.batch = make_batch(32)
        batch = {k: jnp.asarray(v) for k, v in self.batch.items()}
        params = self.variables['params']
        stats = self.variables['batch_stats']

        def loss_fn(p):
            out = det.apply({'params': p, 'batch_stats': stats},
                            batch['images'], batch=batch, train=True,
                            rng=j_rng(0))
            losses = det.loss_from_outputs(out, batch)
            return sum(losses.values()), (losses, out)

        (_, (self.j_losses, self.j_outputs)), self.j_grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(params)

        tx = j_ts.build_optimizer(
            OPT_CONFIG, j_ts.build_lr_schedule(LR_CONFIG, BASE_LR, 10),
            grad_clip=dict(max_norm=MAX_NORM), params=params,
            frozen_stages=1)
        state = j_ts.create_train_state(det, None, None, tx,
                                        variables=self.variables)
        step = jax.jit(j_ts.make_train_step(det, tx))
        self.j_metrics = []
        for _ in range(2):
            state, metrics = step(state, batch)
            self.j_metrics.append({k: float(v) for k, v in metrics.items()})
        self.j_params_after = state.params

    def jax_head(self, name, stage):
        cfg = dict(self.jcfg.model[name])
        cfg['train_cfg'] = self.jcfg.model['train_cfg'][stage]
        cfg['test_cfg'] = self.jcfg.model['test_cfg'].get(stage)
        return JHEADS.build(cfg)

    def port_state(self):
        tx = build_optimizer(
            OPT_CONFIG, build_lr_schedule(LR_CONFIG, BASE_LR, 10),
            grad_clip=dict(max_norm=MAX_NORM), frozen_stages=1)
        detector = build_detector(dict(self.cfg.model))
        state = create_train_state(
            detector, tx, device='cpu',
            state_dict=from_jax_variables(self.variables))
        return detector, tx, state


@pytest.fixture(scope='module')
def run():
    return Run()


def test_weights_round_trip_with_no_leftover_key(run):
    """Training adds no parameter: the carried state loads strictly and
    goes back to the flax tree unchanged."""
    detector = run.port_state()[0]
    assert set(from_jax_variables(run.variables)) == \
        set(detector.state_dict())
    back = dict(leaves(to_jax_layout(detector.state_dict())))
    ref = dict(leaves(run.variables))
    assert sorted(back) == sorted(ref)
    for name, v in ref.items():
        np.testing.assert_array_equal(back[name], v, err_msg=name)


def test_rpn_loss_and_targets_match_jax(run, jax_draws):
    """Random RPN outputs and the batch's gts: both losses, and the sampled
    anchors, labels and targets of the JAX package's own pieces."""
    rng = np.random.default_rng(33)
    sizes = [SIZE // s for s in (4, 8, 16, 32, 64)]
    cls = [rng.normal(0, 2, (2, s, s, 3)).astype(np.float32) for s in sizes]
    reg = [rng.normal(0, 0.5, (2, s, s, 18)).astype(np.float32)
           for s in sizes]
    batch = run.batch
    j_batch = [jnp.asarray(batch[k]) for k in ('gt_bboxes', 'gt_labels',
                                               'gt_mask')]
    head = run.jax_head('rpn_head', 'rpn')
    j_xyxy = head._flat_hbb_anchors([(s, s) for s in sizes])
    j_rot = j_boxes.hbb2obb(j_xyxy, 'le90')

    def j_targets(gb, gm, key):
        assign = head.assigner(j_rot, j_boxes.obb2hbb(gb, 'le90'),
                               jnp.zeros(gm.shape, jnp.int32), gm)
        pos, neg = j_assigners.random_sample_masks(
            assign.assigned_gt_inds >= 0, assign.assigned_gt_inds == -1,
            256, 0.5, key)
        deltas = head.coder.encode(
            j_xyxy, gb[jnp.clip(assign.assigned_gt_inds, 0, None)])
        return pos, pos | neg, jnp.where(pos[:, None], deltas, 0.0)

    tb = to_torch(batch)
    ref, (pos, sampled, deltas) = jax.jit(
        lambda outputs, keys: (head.loss(outputs, *j_batch),
                               jax.vmap(j_targets)(j_batch[0], j_batch[2],
                                                   keys)))(
        (tuple(map(jnp.asarray, cls)), tuple(map(jnp.asarray, reg))),
        jnp.stack(jax_keys(rng_from_gt(tb['gt_bboxes']))))
    rpn = build_detector(dict(run.cfg.model)).rpn_head
    nchw = [torch.from_numpy(x).permute(0, 3, 1, 2) for x in cls + reg]
    got = rpn.loss((tuple(nchw[:5]), tuple(nchw[5:])), tb['gt_bboxes'],
                   tb['gt_labels'], tb['gt_mask'])
    for k in ('loss_rpn_cls', 'loss_rpn_bbox'):
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5)

    # the targets, against the JAX package's assigner, sampler and coder
    xyxy, rot = rpn.train_anchors([(s, s) for s in sizes], 'cpu')
    np.testing.assert_allclose(rot.numpy(), np.asarray(j_rot), atol=1e-5)
    fg, lw, bt, bw = rpn.targets(xyxy, rot, tb['gt_bboxes'], tb['gt_mask'])
    np.testing.assert_array_equal(fg.numpy(), np.asarray(pos))
    np.testing.assert_array_equal(bw.numpy(), np.asarray(pos))
    np.testing.assert_array_equal(lw.numpy(), np.asarray(sampled))
    np.testing.assert_allclose(bt.numpy(), np.asarray(deltas), rtol=1e-5,
                               atol=1e-5)
    assert 0 < fg.sum() < 256 and lw.sum(1).tolist() == [256, 256]


def test_sample_rois_matches_jax(run, jax_draws):
    """Proposals around the gts and elsewhere, a fifth of them padding:
    RoIs, labels, order, weights and targets."""
    rng = np.random.default_rng(34)
    gts = run.batch['gt_bboxes']
    props = np.zeros((2, 256, 5), np.float32)
    for b in range(2):
        near = gts[b, rng.integers(0, 3, 120)].copy()
        near[:, :2] += rng.normal(0, 4, (120, 2))
        near[:, 2:4] *= rng.uniform(0.7, 1.3, (120, 2))
        near[:, 4] += rng.normal(0, 0.2, 120)
        far = np.stack([rng.uniform(0, SIZE, 80), rng.uniform(0, SIZE, 80),
                        rng.uniform(8, 50, 80), rng.uniform(8, 50, 80),
                        rng.uniform(-1.5, 1.5, 80)], -1)
        props[b, :200] = np.concatenate([near, far])
    props[0, 7] = props[0, 6]                 # a duplicate proposal
    valid = np.arange(256)[None].repeat(2, 0) < 200
    key = SampleKey(step=3)
    head = run.jax_head('roi_head', 'rcnn')
    ref = jax.jit(head.sample_rois)(
        jnp.asarray(props), jnp.asarray(valid), jnp.asarray(gts),
        jnp.asarray(run.batch['gt_labels']), jnp.asarray(run.batch['gt_mask']),
        j_rng(3))
    roi_head = build_detector(dict(run.cfg.model)).roi_head
    tb = to_torch(run.batch)
    got = roi_head.sample_rois(torch.from_numpy(props),
                               torch.from_numpy(valid), tb['gt_bboxes'],
                               tb['gt_labels'], tb['gt_mask'], key)
    rois, labels, lw, bt, bw, num_pos = got
    assert rois.shape == (2, 128, 5) and labels.dtype == torch.int64
    np.testing.assert_array_equal(rois.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(lw.numpy(), np.asarray(ref[2]))
    np.testing.assert_allclose(bt.numpy(), np.asarray(ref[3]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(bw.numpy(), np.asarray(ref[4]))
    assert float(num_pos) == float(ref[5]) == float(bw.sum())
    # positives first, then negatives, then padding (an image short of
    # negatives pads)
    npos = bw.sum(1).long().tolist()
    assert 0 < min(npos) and max(npos) <= 32 and 200 < lw.sum() < 256
    for b in range(2):
        assert (labels[b, :npos[b]] < 2).all()
        assert (labels[b, npos[b]:] == 2).all()
        assert (lw[b, :-1] >= lw[b, 1:]).all()


@pytest.mark.parametrize('agnostic', [True, False])
def test_bbox_head_loss_matches_jax(agnostic):
    """The RoI head's losses on random scores and deltas, for a
    class-agnostic and a per-class regression (read at each RoI's label;
    background RoIs carry no box weight)."""
    from orientedobjectdetection_torch.utils.registry import HEADS
    rng = np.random.default_rng(36)
    cfg = dict(type='RotatedShared2FCBBoxHead', num_classes=3,
               in_channels=8, fc_out_channels=16,
               reg_class_agnostic=agnostic)
    b, r = 2, 40
    cls = rng.normal(0, 2, (b, r, 4)).astype(np.float32)
    reg = rng.normal(0, 1, (b, r, 5 if agnostic else 15)).astype(np.float32)
    labels = rng.integers(0, 4, (b, r))
    lw = (rng.uniform(size=(b, r)) < 0.9).astype(np.float32)
    bw = ((labels < 3) & (lw > 0)).astype(np.float32)
    bt = rng.normal(0, 1, (b, r, 5)).astype(np.float32) * bw[..., None]
    rois = np.zeros((b, r, 5), np.float32)
    num_pos = np.float32(max(bw.sum(), 1.0))
    args = (cls, reg, rois, labels, lw, bt, bw, num_pos)
    ref = JHEADS.build(dict(cfg)).loss(*map(jnp.asarray, args))
    got = HEADS.build(dict(cfg)).loss(*(torch.as_tensor(a) for a in args))
    for k in ('loss_cls', 'loss_bbox'):
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-6)


def test_gather_roi_align_gradient_matches_jax():
    """d(sum(pooled * w)) / d(levels) through the gather RoIAlign, against
    ``jax.grad`` of the JAX package's gather op."""
    rng = np.random.default_rng(35)
    feats = [rng.normal(0, 1, (2, 64 // s, 64 // s, 8)).astype(np.float32)
             for s in (4, 8, 16, 32)]
    rois = np.stack([rng.uniform(0, 64, (2, 12)), rng.uniform(0, 64, (2, 12)),
                     np.exp(rng.uniform(np.log(6), np.log(60), (2, 12))),
                     np.exp(rng.uniform(np.log(6), np.log(60), (2, 12))),
                     rng.uniform(-1.5, 1.5, (2, 12))], -1).astype(np.float32)
    rois[1, -2:] = 0.0                        # padding
    w = rng.normal(0, 1, (2, 12, 7, 7, 8)).astype(np.float32)
    scales = [1 / 4, 1 / 8, 1 / 16, 1 / 32]

    def j_loss(levels):
        out = j_roi_align(levels, jnp.asarray(rois), (7, 7),
                                      scales, 2, 56.0)
        return jnp.sum(out * w)

    ref = jax.jit(jax.grad(j_loss))([jnp.asarray(f) for f in feats])
    levels = [torch.from_numpy(f).requires_grad_() for f in feats]
    pooled = roi_align_rotated(levels, torch.from_numpy(rois), (7, 7),
                               scales, 2, 56.0)
    (pooled * torch.from_numpy(w)).sum().backward()
    top = max(float(np.abs(np.asarray(r)).max()) for r in ref)
    hit = 0
    for g, r in zip(levels, ref):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-4 * top)
        hit += int(np.count_nonzero(np.asarray(r)))
    assert hit > 1000


def test_train_forward_and_losses_match_jax(run, jax_draws):
    """Step 0 on carried weights: proposals, the sampled RoIs, the four
    losses, and every trainable tensor's gradient."""
    detector, _, _ = run.port_state()
    batch = to_torch(run.batch)
    outputs = detector(batch['images'].permute(0, 3, 1, 2), batch=batch,
                       train=True, rng=SampleKey(step=0))
    ref = run.j_outputs
    np.testing.assert_array_equal(outputs['labels'].numpy(),
                                  np.asarray(ref['labels']))
    np.testing.assert_allclose(outputs['rois'].numpy(),
                               np.asarray(ref['rois']), rtol=1e-4,
                               atol=1e-3)
    losses = detector.loss_from_outputs(outputs, batch)
    assert sorted(losses) == ['loss_bbox', 'loss_cls', 'loss_rpn_bbox',
                              'loss_rpn_cls']
    for k, v in losses.items():
        np.testing.assert_allclose(float(v.detach()), float(run.j_losses[k]),
                                   rtol=1e-4, err_msg=k)
    assert float(run.j_losses['loss_bbox']) > 0      # RoIs have positives
    assert float(run.j_losses['loss_rpn_bbox']) > 0
    sum(losses.values()).backward()
    grads = to_jax_layout({n: p.grad for n, p in detector.named_parameters()
                           if p.grad is not None})['params']
    got = dict(leaves(grads))
    ref = dict(leaves(run.j_grads))
    mask = frozen_mask(detector, 1)
    assert len(got) == sum(mask.values())
    for name, g in got.items():              # 1e-3 of each tensor's max
        np.testing.assert_allclose(g, ref[name], rtol=0,
                                   atol=1e-3 * np.abs(ref[name]).max(),
                                   err_msg=name)


def test_two_train_steps_match_jax(run, jax_draws):
    """``make_train_step``'s default rng (step 0, then 1), warmup LR, weight
    decay, an active clip, momentum, a frozen stem and layer1."""
    detector, tx, state = run.port_state()
    step = make_train_step(detector, tx)
    metrics = []
    for _ in range(2):
        state, m = step(state, to_torch(run.batch))
        metrics.append({k: float(v) for k, v in m.items()})
    assert state.step == 2
    for got, ref in zip(metrics, run.j_metrics):
        for k in ('loss_rpn_cls', 'loss_rpn_bbox', 'loss_cls', 'loss_bbox',
                  'loss'):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=k)
    assert metrics[0]['grad_norm'] > MAX_NORM
    after = dict(leaves(to_jax_layout(detector.state_dict())['params']))
    ref = dict(leaves(run.j_params_after))
    start = dict(leaves(run.variables['params']))
    assert sorted(after) == sorted(ref)
    moved = 0
    for name, v in after.items():
        np.testing.assert_allclose(v, ref[name], rtol=0, atol=1e-5,
                                   err_msg=name)
        moved += int(not np.array_equal(v, start[name]))
    assert moved == sum(frozen_mask(detector, 1).values())


def test_step_rng_and_single_stage_arguments(run):
    """An explicit rng replaces the step's default; a single-stage detector
    takes the same call and ignores the arguments."""
    detector, tx, state = run.port_state()
    step = make_train_step(detector, tx)
    batch = to_torch(run.batch)
    with torch.no_grad():
        images = batch['images'].permute(0, 3, 1, 2)
        a = detector(images, batch=batch, train=True, rng=SampleKey(step=0))
        b = detector(images, batch=batch, train=True, rng=SampleKey(step=9))
    assert not torch.equal(a['rois'], b['rois'])
    with pytest.raises(ValueError, match='rng'):
        detector(images, batch=batch, train=True)
    state, m = step(state, batch, rng=SampleKey(step=9))
    assert state.step == 1 and torch.isfinite(m['loss'])
    from __graft_entry__ import _retina_cfg
    retina = build_detector(_retina_cfg(num_classes=2, depth=18, channels=16,
                                        stacked=1))
    with torch.no_grad():
        plain = retina(images)
        called = retina(images, batch=batch, train=True,
                        rng=SampleKey(step=0))
    for p, c in zip(plain, called):
        for x, y in zip(p, c):
            assert torch.equal(x, y)
