"""Port parity, the jy losses: VarifocalLoss and the three objectness
losses (``ObjectnessLoss2`` with ``ver`` 0 and 1, ``ObjectnessLoss3``, the
``ObjectnessLoss`` alias with ``ver=2``), their values and gradients at
every input against the JAX package's, on numpy-seeded logits; with
``ver != 0`` the objectness gate is detached. Tolerances at the test."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orientedobjectdetection_tpu.models.losses import common as j_losses
from orientedobjectdetection_torch.models.losses import common as p_losses

torch.set_num_threads(1)


LOSSES = {
    'varifocal': (dict(), False),
    'varifocal_plain': (dict(iou_weighted=False, alpha=0.5), False),
    'objectness2_ver0': (dict(ver=0, obj_loss_weight=0.5), True),
    'objectness2_ver1': (dict(ver=1), True),
    'objectness3': (dict(obj_loss_weight=2.0, loss_weight=0.5), True),
    'objectness_ver2': (dict(ver=2), True),
}
LOSS_TYPE = {'varifocal': 'VarifocalLoss', 'varifocal_plain': 'VarifocalLoss',
             'objectness2_ver0': 'ObjectnessLoss2',
             'objectness2_ver1': 'ObjectnessLoss2',
             'objectness3': 'ObjectnessLoss3',
             'objectness_ver2': 'ObjectnessLoss'}


@pytest.mark.parametrize('name', sorted(LOSSES))
def test_loss_and_gradients_match_jax(name):
    """Value within rtol 1e-6 and the gradients at every input within
    1e-6 of their largest; with ``ver != 0`` the objectness gets the
    objectness term's gradient alone (the gate is detached)."""
    kw, objectness = LOSSES[name]
    cls_name = LOSS_TYPE[name]
    jl, pl = getattr(j_losses, cls_name)(**kw), getattr(p_losses,
                                                        cls_name)(**kw)
    rng = np.random.default_rng(len(name))
    pred = rng.normal(0, 2, (2, 30, 5)).astype(np.float32)
    weight = rng.uniform(0, 1, (2, 30)).astype(np.float32)
    if objectness:
        obj = rng.normal(0, 2, (2, 30, 1)).astype(np.float32)
        labels = rng.integers(0, 6, (2, 30)).astype(np.int32)

        def jfn(o, p):
            return jl(o, p, jnp.asarray(labels), 5,
                      weight=jnp.asarray(weight), avg_factor=7.0)

        args = (obj, pred)
        targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
        got = pl(*targs, torch.from_numpy(labels).long(), 5,
                 weight=torch.from_numpy(weight), avg_factor=7.0)
    else:
        target = np.where(rng.uniform(0, 1, (2, 30, 5)) < 0.2,
                          rng.uniform(0, 1, (2, 30, 5)), 0).astype(np.float32)

        def jfn(p):
            return jl(p, jnp.asarray(target), weight=jnp.asarray(weight),
                      avg_factor=7.0)

        args = (pred,)
        targs = [torch.from_numpy(pred).requires_grad_(True)]
        got = pl(targs[0], torch.from_numpy(target),
                 weight=torch.from_numpy(weight), avg_factor=7.0)
    ref = jfn(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-6)
    got.backward()
    grads = jax.grad(jfn, argnums=tuple(range(len(args))))(
        *(jnp.asarray(a) for a in args))
    for g, t in zip(grads, targs):
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=0,
                                   atol=1e-6 * max(np.abs(g).max(), 1e-8))
