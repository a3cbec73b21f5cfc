"""Port parity, training the refine detectors: two SGD steps of S2ANet and
of R3Det through ``make_train_step`` against the JAX package's jitted step,
and the losses and per-parameter gradients of the KFIoU refine recipes
(``KFIoURRetinaHead`` + ``KFIoUODMRefineHead``, ``KFIoURRetinaHead`` +
``KFIoURRetinaRefineHead``) and of the two-stage cascade
(``r3det_refine``), with its forward outputs.

The sizes and carried weights of ``tests/test_torch_refine.py``.
Tolerances are stated at each comparison."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orientedobjectdetection_tpu.models import build_detector as j_build
from orientedobjectdetection_tpu.parallel import train_state as j_ts
from orientedobjectdetection_torch.models import build_detector
from orientedobjectdetection_torch.parallel import (build_lr_schedule,
                                                    build_optimizer,
                                                    create_train_state,
                                                    make_train_step)
from orientedobjectdetection_torch.utils.jax_weights import (
    from_jax_variables, to_jax_layout)
from test_torch_refine import (SIZE, DetRun, anchor_gts, batch_of,
                               check_outputs, fill_variables, leaves,
                               small_model, to_jax)

torch.set_num_threads(1)

LR_CONFIG = dict(policy='step', step=[8, 11], warmup='linear',
                 warmup_iters=5, warmup_ratio=1.0 / 3)
OPT_CONFIG = dict(type='sgd', momentum=0.9, weight_decay=1e-2)


@pytest.mark.parametrize('key', ['s2anet', 'r3det'])
def test_two_train_steps_match_jax(key):
    """Warmup LR, weight decay, an active clip, momentum and the frozen
    stem and layer1, through ``make_train_step`` and the JAX package's
    jitted step: every loss term at rtol 1e-4, parameters to 1e-5."""
    cfg = small_model(key)
    det = j_build(cfg)
    rng = np.random.default_rng(40 + len(key))
    images = rng.normal(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    shapes = jax.eval_shape(det.init, jax.random.PRNGKey(0),
                            jnp.asarray(images))
    variables = fill_variables(shapes, rng)
    batch = batch_of(images, anchor_gts(rng))

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
    terms = [k for k in j_metrics[0] if 'loss_' in k]
    assert len(terms) == 4
    for ref in j_metrics:
        port_state, m = port_step(port_state, {
            k: torch.from_numpy(v) for k, v in batch.items()})
        for k in terms + ['loss']:
            np.testing.assert_allclose(float(m[k]), ref[k], rtol=1e-4,
                                       err_msg=k)
    assert j_metrics[0]['grad_norm'] > 1.0          # the clip is active
    after = dict(leaves(to_jax_layout(detector.state_dict())['params']))
    ref = dict(leaves(jax.tree_util.tree_map(np.asarray, state.params)))
    assert sorted(after) == sorted(ref)
    for name, r in ref.items():
        np.testing.assert_allclose(after[name], r, rtol=0, atol=1e-5,
                                   err_msg=name)


_RUNS = {}


def run_of(key):
    if key not in _RUNS:
        _RUNS[key] = DetRun(key, seed=20 + len(_RUNS), decode=False)
    return _RUNS[key]


@pytest.mark.parametrize('key', ['s2anet_kfiou', 'r3det_kfiou',
                                 'r3det_refine'])
def test_recipe_loss_and_gradients_match_jax(key):
    """The KFIoU refine losses (``KFLoss`` on the deltas and the boxes
    decoded against the refined anchors) and the cascade's ``sr1_*``
    terms: losses at rtol 1e-4, each positive; every parameter's gradient
    within 1e-3 of its tensor's largest."""
    run = run_of(key)
    detector = run.port()
    losses = detector.loss_from_outputs(detector(run.port_images()),
                                        run.port_batch())
    assert sorted(losses) == sorted(run.j_losses)
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), run.j_losses[k], rtol=1e-4,
                                   err_msg=k)
        assert run.j_losses[k] > 0, k
    sum(losses.values()).backward()
    grads = dict(leaves(to_jax_layout(
        {n: p.grad for n, p in detector.named_parameters()})['params']))
    ref = dict(leaves(run.j_grads))
    assert sorted(grads) == sorted(ref)
    for name, r in ref.items():
        assert np.abs(r).max() > 0, name
        np.testing.assert_allclose(grads[name], r, rtol=0,
                                   atol=1e-3 * np.abs(r).max(), err_msg=name)


def test_cascade_forward_matches_jax():
    """``r3det_refine``: two refine stages, each on the previous one's
    rois; every map and roi within 1e-4 of its tensor's largest."""
    run = run_of('r3det_refine')
    detector = run.port()
    assert len(detector.refine_head) == 2
    with torch.no_grad():
        out = detector(run.port_images())
    assert sorted(run.j_losses) == sorted(
        f'{s}_loss_{t}' for s in ('s0', 'sr0', 'sr1') for t in ('cls',
                                                                  'bbox'))
    check_outputs(to_jax(out), run.j_out, 'r3det_refine')
