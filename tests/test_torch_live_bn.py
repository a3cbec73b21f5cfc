"""Port parity, live BatchNorm: ``FrozenBatchNorm`` in live mode against
the JAX package's ``FrozenBatchNorm`` applied with a mutable
``batch_stats`` collection (the output, the biased-variance EMA of the
running statistics, the gradients through the batch statistics), and
whole-detector SGD steps of prototype4 (``configs/jy/prototype4.py``, the
backbone and neck cut to deepen 0.33 / widen 0.125, 4 classes, 64 px)
through ``make_train_step(norm_eval=False)`` against the JAX package's
jitted ``make_train_step(norm_eval=False)`` (the frozen step is in
``tests/test_torch_yolov8_train.py``); then the updated
statistics through a checkpoint and ``init_detector``.

Tolerances: the layer's output and statistics within 1e-6 of their
largest magnitude (float32 reductions in other orders), its gradients
within 1e-5; the detector's loss terms at rtol 1e-4, each parameter's
change in the step within 2e-3 of that tensor's largest change in JAX
plus 2 float32 ulps of its largest value (the rounding of the
subtraction), and every running statistic after the step within 1e-5."""

import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orientedobjectdetection_tpu.models import build_detector as j_build
from orientedobjectdetection_tpu.models.backbones.resnet import \
    FrozenBatchNorm as JBN
from orientedobjectdetection_tpu.parallel import train_state as j_ts
from orientedobjectdetection_torch.apis import init_detector
from orientedobjectdetection_torch.models import build_detector
from orientedobjectdetection_torch.models.blocks import (FrozenBatchNorm,
                                                         live_batch_norm)
from orientedobjectdetection_torch.parallel import (build_lr_schedule,
                                                    build_optimizer,
                                                    create_train_state,
                                                    make_train_step)
from orientedobjectdetection_torch.utils import Config
from orientedobjectdetection_torch.utils.checkpoint import (load_checkpoint,
                                                            save_checkpoint)
from orientedobjectdetection_torch.utils.jax_weights import (
    from_jax_variables, to_jax_layout)
from test_torch_cspnext import fill_variables
from test_torch_refine import leaves
from test_torch_yolov8 import random_gts

torch.set_num_threads(1)

CONFIG = 'configs/jy/prototype4.py'
SIZE = 64
# The step's peak rate: 400 times the config's 0.0025, so that the warmup's
# first rate (0.1) moves the parameters well above the float32 rounding of
# their values, where each tensor's change can be held to JAX's.
LR = 1.0


def layer_case(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = (rng.normal(0.5, 2, (3, 5, 6, 8))).astype(np.float32)
    stats = dict(mean=rng.normal(0, 0.3, 8).astype(np.float32),
                 var=rng.uniform(0.5, 2, 8).astype(np.float32))
    params = dict(scale=rng.uniform(0.5, 1.5, 8).astype(np.float32),
                  bias=rng.normal(0, 0.2, 8).astype(np.float32))
    return x, params, stats


def port_layer(params, stats):
    bn = FrozenBatchNorm(8)
    bn.load_state_dict({'weight': torch.from_numpy(params['scale']),
                        'bias': torch.from_numpy(params['bias']),
                        'running_mean': torch.from_numpy(stats['mean']),
                        'running_var': torch.from_numpy(stats['var'])})
    return bn


@pytest.mark.parametrize('seed', range(3))
def test_live_layer_matches_jax(seed):
    """Live: batch mean and biased variance over (N, H, W) in float32, the
    running statistics ``0.9 old + 0.1 batch``, the gradient through the
    batch statistics; frozen afterwards: the running statistics."""
    x, params, stats = layer_case(seed)
    jbn = JBN()
    variables = {'params': params, 'batch_stats': stats}
    w = np.random.default_rng(seed + 9).normal(0, 1, x.shape).astype(
        np.float32)

    def jfn(xx, p):
        y, upd = jbn.apply({'params': p, 'batch_stats': stats}, xx,
                           mutable=['batch_stats'])
        return (y * w).sum(), (y, upd['batch_stats'])

    (_, (ref, ref_stats)), (gx, gp) = jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True)(jnp.asarray(x), params)
    bn = port_layer(params, stats)
    xt = torch.from_numpy(np.transpose(x, (0, 3, 1, 2)).copy())
    xt.requires_grad_(True)
    with live_batch_norm(bn):
        y = bn(xt)
    assert not bn.live
    (y * torch.from_numpy(np.transpose(w, (0, 3, 1, 2)).copy())).sum(
        ).backward()
    ref = np.transpose(np.asarray(ref), (0, 3, 1, 2))
    np.testing.assert_allclose(y.detach().numpy(), ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())
    for ours, theirs in (('running_mean', 'mean'), ('running_var', 'var')):
        r = np.asarray(ref_stats[theirs])
        np.testing.assert_allclose(getattr(bn, ours).numpy(), r, rtol=0,
                                   atol=1e-6 * np.abs(r).max())
    gx = np.transpose(np.asarray(gx), (0, 3, 1, 2))
    np.testing.assert_allclose(xt.grad.numpy(), gx, rtol=0,
                               atol=1e-5 * np.abs(gx).max())
    for ours, theirs in (('weight', 'scale'), ('bias', 'bias')):
        r = np.asarray(gp[theirs])
        np.testing.assert_allclose(getattr(bn, ours).grad.numpy(), r,
                                   rtol=0, atol=1e-5 * np.abs(r).max())
    # frozen again: the updated running statistics normalize
    frozen = jbn.apply({'params': params, 'batch_stats': ref_stats},
                       jnp.asarray(x))
    with torch.no_grad():
        again = bn(xt)
    frozen = np.transpose(np.asarray(frozen), (0, 3, 1, 2))
    np.testing.assert_allclose(again.numpy(), frozen, rtol=0,
                               atol=1e-6 * np.abs(frozen).max())


def test_live_layer_keeps_the_input_dtype_and_the_biased_variance():
    """bfloat16 input: statistics in float32, the affine in bfloat16; the
    update uses the biased variance (``F.batch_norm`` would use the
    unbiased one)."""
    x, params, stats = layer_case(5)
    bn = port_layer(params, stats)
    xt = torch.from_numpy(np.transpose(x, (0, 3, 1, 2)).copy())
    with live_batch_norm(bn), torch.no_grad():
        y = bn(xt.bfloat16())
    assert y.dtype == torch.bfloat16
    xb = xt.bfloat16().float()
    biased = xb.var((0, 2, 3), unbiased=False)
    expect = 0.9 * torch.from_numpy(stats['var']) + 0.1 * biased
    torch.testing.assert_close(bn.running_var, expect, rtol=1e-6, atol=0)


def small_model():
    m = copy.deepcopy(dict(Config.fromfile(CONFIG).model))
    m['backbone'] = dict(m['backbone'], deepen_factor=0.33,
                         widen_factor=0.125)
    m['neck'] = dict(m['neck'], deepen_factor=0.33, widen_factor=0.125)
    m['bbox_head'] = dict(m['bbox_head'], num_classes=4, widen_factor=0.125,
                          regress_ranges=((-1, 24), (24, 48), (48, 96)))
    m['train_cfg'] = dict(assigner=dict(type='OBBLabelAssigner',
                                        num_classes=4, topk=6))
    return m


def filled(det, images, rng):
    shapes = jax.eval_shape(det.init, jax.random.PRNGKey(0),
                            jnp.asarray(images))
    variables = fill_variables(shapes, rng)

    def bias(path, v):
        name = path[-2].key if len(path) > 1 else ''
        if path[-1].key == 'bias' and name.startswith('reg_pred'):
            return np.ones_like(v)
        if path[-1].key == 'bias' and name.startswith('cls_pred'):
            return np.full_like(v, -2.0)
        return v

    return jax.tree_util.tree_map_with_path(bias, variables)


@functools.lru_cache(maxsize=None)
def run_step(norm_eval: bool) -> dict:
    """One SGD step of the cut prototype4 in both packages with the
    config's optimizer (momentum, weight decay, clip, warmup)."""
    full = Config.fromfile(CONFIG)
    cfg = small_model()
    det = j_build(cfg)
    rng = np.random.default_rng(21)
    images = rng.normal(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    variables = filled(det, images, rng)
    gts = random_gts(rng, valid=4, size=SIZE)
    gts[0][..., 2:4] *= 0.5
    batch = dict(images=images, gt_bboxes=gts[0], gt_labels=gts[1],
                 gt_mask=gts[2])
    opt = dict(full.optimizer)
    opt.pop('lr')
    lr = LR
    grad_clip = dict(full.optimizer_config['grad_clip'])
    sched = j_ts.build_lr_schedule(dict(full.lr_config), lr, 10)
    tx = j_ts.build_optimizer(opt, sched, grad_clip=grad_clip,
                              params=variables['params'])
    state = j_ts.create_train_state(det, None, None, tx, variables=variables)
    step = jax.jit(j_ts.make_train_step(det, tx, norm_eval=norm_eval))
    state, j_metrics = step(state, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
    port_tx = build_optimizer(opt, build_lr_schedule(dict(full.lr_config),
                                                     lr, 10),
                              grad_clip=grad_clip)
    detector = build_detector(cfg)
    port_state = create_train_state(detector, port_tx, device='cpu',
                                    state_dict=from_jax_variables(variables))
    port_step = make_train_step(detector, port_tx, norm_eval=norm_eval)
    port_state, metrics = port_step(port_state, {
        k: torch.from_numpy(v) for k, v in batch.items()})
    return dict(norm_eval=norm_eval, variables=variables, state=state,
                decay=float(sched(0)) * opt['weight_decay'],
                j_metrics=j_metrics, detector=detector,
                port_state=port_state, metrics=metrics, port_tx=port_tx,
                cfg=cfg)


@pytest.fixture(scope='module')
def stepped():
    """The live step (``tests/test_torch_yolov8_train.py`` holds the frozen
    one with the same test)."""
    return run_step(False)


def check_param_changes(stepped) -> int:
    """Each parameter's change in the step against JAX's: within 2e-3 of
    that tensor's largest change in JAX plus 2 ulps of its largest value.
    Returns the number of tensors that the gradient moved: whose change
    less the weight decay's part (``-rate * wd * p``) exceeds that
    tolerance."""
    layout = to_jax_layout(stepped['detector'].state_dict())
    after = dict(leaves(layout['params']))
    params = dict(leaves(jax.tree_util.tree_map(np.asarray,
                                                stepped['state'].params)))
    before = dict(leaves(stepped['variables']['params']))
    assert sorted(after) == sorted(params) == sorted(before)
    moved = 0
    for name, r in params.items():
        p = before[name]
        ref = r - p
        atol = (2e-3 * np.abs(ref).max()
                + 2 * np.spacing(np.abs(p).max().astype(np.float32)))
        np.testing.assert_allclose(after[name] - p, ref, rtol=0, atol=atol,
                                   err_msg=name)
        moved += np.abs(ref + stepped['decay'] * p).max() > atol
    return moved


def test_train_step_matches_jax(stepped):
    """Loss terms at rtol 1e-4; each parameter's change as JAX's (see
    :func:`check_param_changes`), and the gradient moved more than 85% of
    the tensors (the coarsest level's reg and angle towers see no positive
    at 64 px); with live BN every running statistic within 1e-5 of JAX's
    ``batch_stats`` and moved, with frozen BN every statistic unchanged."""
    ref, got = stepped['j_metrics'], stepped['metrics']
    for k in ('loss_cls', 'loss_bbox', 'loss'):
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-4,
                                   err_msg=k)
        assert float(ref[k]) > 0, k
    n_params = len(dict(leaves(stepped['variables']['params'])))
    moved = check_param_changes(stepped)
    assert moved > 0.85 * n_params, (moved, n_params)
    layout = to_jax_layout(stepped['detector'].state_dict())
    stats = dict(leaves(layout['batch_stats']))
    ref_stats = dict(leaves(jax.tree_util.tree_map(
        np.asarray, stepped['state'].batch_stats)))
    before = dict(leaves(stepped['variables']['batch_stats']))
    assert sorted(stats) == sorted(ref_stats) == sorted(before)
    moved = 0
    for name, r in ref_stats.items():
        np.testing.assert_allclose(stats[name], r, rtol=0, atol=1e-5,
                                   err_msg=name)
        moved += not np.array_equal(r, before[name])
    if stepped['norm_eval']:
        assert moved == 0
    else:
        assert moved == len(ref_stats)


def test_live_statistics_survive_a_checkpoint_and_the_inference_load(
        tmp_path):
    """The running statistics after a live step: saved with the
    checkpoint, loaded back into a fresh state, and served by
    ``init_detector`` from the checkpoint's path."""
    stepped = run_step(False)
    detector = stepped['detector']
    fresh = build_detector(stepped['cfg'])
    state = create_train_state(fresh, build_optimizer(
        dict(type='sgd', momentum=0.9), 0.01), device='cpu')
    path = save_checkpoint(str(tmp_path), stepped['port_state'], 1)
    load_checkpoint(path, state)
    cfg = Config.fromfile(CONFIG)
    cfg.model = stepped['cfg']
    bundle = init_detector(cfg, path, device='cpu')
    ref = {k: v for k, v in detector.state_dict().items()
           if k.endswith(('running_mean', 'running_var'))}
    assert len(ref) > 50
    for k, v in ref.items():
        assert torch.equal(fresh.state_dict()[k], v), k
        assert torch.equal(bundle.detector.state_dict()[k], v), k
