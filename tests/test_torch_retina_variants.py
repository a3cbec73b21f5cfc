"""Port parity, the RetinaNet recipes of the slice: ``CSLCoder``,
``ATSSObbAssigner`` (ties at grid midpoints, padded gts), the KFIoU, ATSS
and CSL heads (loss, per-parameter gradients, decode) on numpy-seeded
features and carried weights, and two SGD steps of the whole KFIoU
detector, against the JAX package.

Small sizes: one stacked conv, 32-wide towers, 4 classes, 128 px, G = 8
padded gts with 5 valid. Tolerances are stated at each comparison."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orientedobjectdetection_tpu.core.assigners import \
    ATSSObbAssigner as JATSS
from orientedobjectdetection_tpu.core.coders import CSLCoder as JCSLCoder
from orientedobjectdetection_tpu.models import build_detector as j_build
from orientedobjectdetection_tpu.parallel import train_state as j_ts
from orientedobjectdetection_tpu.utils.registry import HEADS as J_HEADS
from orientedobjectdetection_torch.core import (ATSSObbAssigner, CSLCoder,
                                                RotatedAnchorGenerator)
from orientedobjectdetection_torch.core.assigners import \
    _nan_mean_std_unbiased
from orientedobjectdetection_torch.models import build_detector
from orientedobjectdetection_torch.parallel import (build_lr_schedule,
                                                    build_optimizer,
                                                    create_train_state,
                                                    make_train_step)
from orientedobjectdetection_torch.utils import Config
from orientedobjectdetection_torch.utils.jax_weights import (
    from_jax_variables, to_jax_layout)
from orientedobjectdetection_torch.utils.registry import HEADS

torch.set_num_threads(1)

SIZE = 128
STRIDES = [8, 16, 32, 64, 128]
CONFIGS = {
    'kfiou': 'configs/kfiou/'
             'rotated_retinanet_obb_kfiou_r50_fpn_1x_dota_le90.py',
    'atss': 'configs/rotated_atss/rotated_atss_obb_r50_fpn_1x_dota_le90.py',
    'csl': 'configs/csl/'
           'rotated_retinanet_obb_csl_gaussian_r50_fpn_fp16_1x_dota_le90.py',
}


def small_model(variant, channels=32):
    """The published model config, cut to ResNet-18, ``channels``-wide FPN
    and head, one stacked conv and 4 classes."""
    model = copy.deepcopy(dict(Config.fromfile(CONFIGS[variant]).model))
    model['backbone'] = dict(model['backbone'], depth=18, init_cfg=None)
    model['neck'] = dict(model['neck'], in_channels=[64, 128, 256, 512],
                         out_channels=channels)
    model['bbox_head'] = dict(model['bbox_head'], num_classes=4,
                              in_channels=channels, feat_channels=channels,
                              stacked_convs=1)
    model['test_cfg'] = dict(model['test_cfg'], nms_pre=100,
                             max_per_img=60, max_candidates=200)
    return model


def fill_variables(shapes, rng):
    """numpy values in the flax tree's shapes; a zero class bias (scores
    near 0.5, so NMS sees real candidates) and small regression weights
    (deltas of a trained head)."""
    def fill(path, leaf):
        name, parent = path[-1].key, path[-2].key
        if name == 'kernel':
            scale = 0.05 if parent == 'reg_out' else 1.0
            v = rng.normal(0, scale / np.sqrt(np.prod(leaf.shape[:-1])),
                           leaf.shape)
        elif name in ('scale', 'var'):
            v = rng.uniform(0.5, 1.5, leaf.shape)
        elif parent == 'cls_out':
            v = np.zeros(leaf.shape)
        else:                                   # bias, mean
            v = rng.normal(0, 0.1, leaf.shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def anchor_gts(rng, cfg, bsz=2, g=8, valid=5):
    """Padded gts copied from anchors of the config's generator and
    perturbed, so each has positives under MaxIoU; gt 0 of each image is
    centred on a grid midpoint of level 0 (equidistant anchors for ATSS).
    Zero boxes after ``valid``."""
    gen = RotatedAnchorGenerator(**{k: v for k, v in
                                    cfg['anchor_generator'].items()
                                    if k not in ('type', '_delete_')})
    anchors = torch.cat(gen.grid_priors(
        [(SIZE // s, SIZE // s) for s in STRIDES]), 0).numpy()
    inside = anchors[(anchors[:, 2:4].max(1) < 70) &
                     (anchors[:, :2].min(1) > 8)]
    gts = np.zeros((bsz, g, 5), np.float32)
    for b in range(bsz):
        pick = inside[rng.choice(len(inside), valid, replace=False)]
        gts[b, :valid] = pick
        gts[b, :valid, :2] += rng.uniform(-3, 3, (valid, 2))
        gts[b, :valid, 2:4] *= rng.uniform(0.8, 1.25, (valid, 2))
        gts[b, :valid, 4] = rng.uniform(-0.3, 0.3, valid)
        gts[b, 0, :2] = (rng.integers(2, 12, 2) + 0.5) * 8
    labels = rng.integers(0, 4, (bsz, g)).astype(np.int32)
    mask = np.arange(g)[None].repeat(bsz, 0) < valid
    return gts, labels, mask


# ---- CSL coder --------------------------------------------------------------
@pytest.mark.parametrize('window', ['gaussian', 'triangle', 'rect', 'pulse'])
@pytest.mark.parametrize('version', ['oc', 'le90', 'le135'])
def test_csl_coder_matches_jax(version, window):
    omega = 2 if window == 'rect' else 1
    kw = dict(angle_version=version, omega=omega, window=window, radius=6)
    coder, ref = CSLCoder(**kw), JCSLCoder(**kw)
    assert coder.coding_len == ref.coding_len == \
        (90 if version == 'oc' else 180) // omega
    rng = np.random.default_rng(len(version) * 7 + len(window))
    lo = {'oc': 0.0, 'le90': -np.pi / 2, 'le135': -np.pi / 4}[version]
    span = np.pi / 2 if version == 'oc' else np.pi
    angles = rng.uniform(lo, lo + span, (64, 1)).astype(np.float32)
    enc = coder.encode(torch.from_numpy(angles))
    np.testing.assert_allclose(enc.numpy(), np.asarray(
        ref.encode(jnp.asarray(angles))), rtol=1e-6, atol=1e-6)
    # logits with ties: the lowest bin wins in both
    logits = rng.integers(0, 5, (64, coder.coding_len)).astype(np.float32)
    np.testing.assert_array_equal(
        coder.decode(torch.from_numpy(logits)).numpy(),
        np.asarray(ref.decode(jnp.asarray(logits))))
    np.testing.assert_allclose(coder.decode(enc).numpy(), np.asarray(
        ref.decode(jnp.asarray(enc.numpy()))), rtol=0, atol=0)


# ---- ATSS assigner ----------------------------------------------------------
def test_nan_mean_std_unbiased():
    x = torch.tensor([[1.0, np.nan], [3.0, np.nan], [np.nan, np.nan],
                      [4.0, 2.0]])
    mean, std = _nan_mean_std_unbiased(x, dim=0)
    np.testing.assert_allclose(mean.numpy(), [8 / 3, 2.0], rtol=1e-6)
    np.testing.assert_allclose(std.numpy(), [np.std([1, 3, 4], ddof=1),
                                             0.0], rtol=1e-6)
    mean, std = _nan_mean_std_unbiased(torch.full((3, 1), np.nan), dim=0)
    assert torch.isnan(mean).all() and torch.isnan(std).all()


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_atss_assigner_matches_jax(seed):
    """Exact assignments and labels on gts centred on grid midpoints (four
    equidistant priors on level 0, ties broken by the lowest index) and
    padded gts, which are never positive."""
    cfg = small_model('atss')
    rng = np.random.default_rng(seed)
    gts, labels, mask = anchor_gts(rng, cfg['bbox_head'])
    gen = RotatedAnchorGenerator(octave_base_scale=4, scales_per_octave=1,
                                 ratios=[1.0], strides=STRIDES)
    levels = gen.grid_priors([(SIZE // s, SIZE // s) for s in STRIDES])
    num_level = [len(lv) for lv in levels]
    priors = torch.cat(levels, 0)
    got = ATSSObbAssigner(topk=9)(priors, num_level, torch.from_numpy(gts),
                                  torch.from_numpy(labels),
                                  torch.from_numpy(mask))
    ref = jax.vmap(lambda gb, gl, gm: JATSS(topk=9)(
        jnp.asarray(priors.numpy()), num_level, gb, gl, gm))(
            jnp.asarray(gts), jnp.asarray(labels), jnp.asarray(mask))
    np.testing.assert_array_equal(got.assigned_gt_inds.numpy(),
                                  np.asarray(ref.assigned_gt_inds))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
    np.testing.assert_allclose(got.max_overlaps.numpy(),
                               np.asarray(ref.max_overlaps), atol=1e-5)
    inds = got.assigned_gt_inds.numpy()
    assert (inds >= 0).sum() >= 2 * mask.sum(1).min()
    assert inds.max() < mask.sum(1).max()            # no padded gt
    for b in range(len(gts)):                        # the midpoint gt
        assert (inds[b] == 0).any()


# ---- heads ------------------------------------------------------------------
class HeadRun:
    """One variant's head in both packages on the same features and
    weights: JAX outputs, losses, gradients and detections."""

    def __init__(self, variant, seed):
        rng = np.random.default_rng(seed)
        cfg = small_model(variant)
        self.head_cfg = dict(cfg['bbox_head'], train_cfg=cfg['train_cfg'],
                             test_cfg=cfg['test_cfg'])
        c = self.head_cfg['in_channels']
        self.feats = [rng.normal(0, 1, (2, SIZE // s, SIZE // s, c))
                      .astype(np.float32) for s in STRIDES]
        self.gts = anchor_gts(rng, self.head_cfg)
        jh = J_HEADS.build(dict(self.head_cfg))
        feats = [jnp.asarray(f) for f in self.feats]
        shapes = jax.eval_shape(jh.init, jax.random.PRNGKey(0), feats)
        self.variables = fill_variables(shapes, rng)
        gts = [jnp.asarray(a) for a in self.gts]

        def loss_fn(params):
            out = jh.apply({'params': params}, feats)
            losses = jh.loss(out, *gts)
            return sum(losses.values()), (losses, out)

        (_, (losses, out)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(
                self.variables['params'])
        self.j_losses = {k: float(v) for k, v in losses.items()}
        self.j_grads = jax.tree_util.tree_map(np.asarray, grads)
        self.j_dets = jax.tree_util.tree_map(
            np.asarray, jax.jit(jh.get_bboxes)(out))

    def port_head(self):
        head = HEADS.build(dict(self.head_cfg))
        sd = from_jax_variables({'params': {
            'bbox_head': self.variables['params']}})
        head.load_state_dict({k[len('bbox_head.'):]: v
                              for k, v in sd.items()})
        return head

    def port_feats(self):
        return [torch.from_numpy(f).permute(0, 3, 1, 2) for f in self.feats]


_RUNS = {}


def head_run(variant):
    if variant not in _RUNS:
        _RUNS[variant] = HeadRun(variant, seed=list(CONFIGS).index(variant))
    return _RUNS[variant]


@pytest.mark.parametrize('variant', list(CONFIGS))
def test_head_loss_and_gradients_match_jax(variant):
    run = head_run(variant)
    head = run.port_head()
    out = head(run.port_feats())
    assert len(out) == (3 if variant == 'csl' else 2)
    losses = head.loss(out, *[torch.from_numpy(a) for a in run.gts])
    assert sorted(losses) == sorted(run.j_losses)
    for k, v in losses.items():                  # rtol 1e-4: float32 sums
        np.testing.assert_allclose(v.item(), run.j_losses[k], rtol=1e-4,
                                   err_msg=k)
        assert run.j_losses[k] > 0
    sum(losses.values()).backward()
    grads = to_jax_layout({f'bbox_head.{n}': p.grad
                           for n, p in head.named_parameters()})
    got = dict(jax.tree_util.tree_leaves_with_path(
        grads['params']['bbox_head']))
    ref = dict(jax.tree_util.tree_leaves_with_path(run.j_grads))
    assert sorted(map(str, got)) == sorted(map(str, ref))
    for path, r in ref.items():                  # 1e-3 of each tensor's max
        assert np.abs(r).max() > 0, path
        np.testing.assert_allclose(got[path], r, rtol=0,
                                   atol=1e-3 * np.abs(r).max(),
                                   err_msg=str(path))


@pytest.mark.parametrize('variant', list(CONFIGS))
def test_head_decode_matches_jax(variant):
    """Labels and valid flags exact, boxes and scores to 1e-4; the CSL
    head's angles come from the argmax bin."""
    run = head_run(variant)
    head = run.port_head()
    with torch.no_grad():
        dets, labels, valid = head.get_bboxes(head(run.port_feats()))
    r_dets, r_labels, r_valid = run.j_dets
    assert r_valid.sum() > 20
    np.testing.assert_array_equal(valid.numpy(), r_valid)
    np.testing.assert_array_equal(labels.numpy(), r_labels)
    np.testing.assert_allclose(dets.numpy(), r_dets, rtol=0, atol=1e-4)


# ---- two SGD steps of the whole detector ------------------------------------
LR_CONFIG = dict(policy='step', step=[8, 11], warmup='linear',
                 warmup_iters=5, warmup_ratio=1.0 / 3)
OPT_CONFIG = dict(type='sgd', momentum=0.9, weight_decay=1e-2)


def test_two_kfiou_train_steps_match_jax():
    """Warmup LR, weight decay, an active clip, momentum and the frozen
    stem and layer1, through ``make_train_step`` and the JAX package's
    jitted step; losses at rtol 1e-4, parameters to 1e-5."""
    cfg = small_model('kfiou')
    det = j_build(cfg)
    rng = np.random.default_rng(5)
    images = rng.normal(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    shapes = jax.eval_shape(det.init, jax.random.PRNGKey(0),
                            jnp.asarray(images))
    variables = fill_variables(shapes, rng)
    gts, labels, mask = anchor_gts(rng, cfg['bbox_head'])
    batch = dict(images=images, gt_bboxes=gts, gt_labels=labels,
                 gt_mask=mask)

    sched = j_ts.build_lr_schedule(LR_CONFIG, 0.05, 10)
    tx = j_ts.build_optimizer(OPT_CONFIG, sched, grad_clip=dict(max_norm=1.0),
                              params=variables['params'], frozen_stages=1)
    state = j_ts.create_train_state(det, None, None, tx, variables=variables)
    step = jax.jit(j_ts.make_train_step(det, tx))
    j_metrics = []
    for _ in range(2):
        state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        j_metrics.append({k: float(v) for k, v in m.items()})

    port_tx = build_optimizer(OPT_CONFIG, build_lr_schedule(LR_CONFIG, 0.05,
                                                            10),
                              grad_clip=dict(max_norm=1.0), frozen_stages=1)
    detector = build_detector(cfg)
    port_state = create_train_state(detector, port_tx, device='cpu',
                                    state_dict=from_jax_variables(variables))
    port_step = make_train_step(detector, port_tx)
    for ref in j_metrics:
        port_state, m = port_step(port_state, {
            k: torch.from_numpy(v) for k, v in batch.items()})
        for k in ('loss_cls', 'loss_bbox', 'loss'):
            np.testing.assert_allclose(float(m[k]), ref[k], rtol=1e-4,
                                       err_msg=k)
    assert j_metrics[0]['grad_norm'] > 1.0          # the clip is active
    after = dict(jax.tree_util.tree_leaves_with_path(
        to_jax_layout(detector.state_dict())['params']))
    ref = dict(jax.tree_util.tree_leaves_with_path(state.params))
    assert sorted(map(str, after)) == sorted(map(str, ref))
    for path, r in ref.items():
        np.testing.assert_allclose(after[path], np.asarray(r), rtol=0,
                                   atol=1e-5, err_msg=str(path))
