"""Port parity, losses: ``FocalLoss``, ``L1Loss``, ``SmoothL1Loss`` and
``reduce_loss`` against the JAX package, values and input gradients, on the
same numpy inputs (rtol 1e-5 with an absolute floor of 1e-6 of the largest
entry: float32 element-wise math, sums in a different order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orientedobjectdetection_tpu.models.losses import common as j_common
from orientedobjectdetection_torch.models.losses import common
from orientedobjectdetection_torch.utils.registry import LOSSES

torch.set_num_threads(1)

B, N, C = 2, 50, 4


def close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-6 * max(np.abs(ref).max(), 1e-30))


def value_and_grad_both(t_loss, j_loss, pred, *args, **kw):
    """Loss value and d loss / d pred from the port and from JAX."""
    tp = torch.from_numpy(pred).requires_grad_()
    t_args = [torch.from_numpy(a) for a in args]
    t_kw = {k: torch.as_tensor(v) for k, v in kw.items()}
    val = t_loss(tp, *t_args, **t_kw)
    val.sum().backward()
    j_val, j_grad = jax.value_and_grad(
        lambda p: jnp.sum(j_loss(p, *args, **kw)))(jnp.asarray(pred))
    return (val.detach().numpy().sum(), tp.grad.numpy()), (j_val, j_grad)


def inputs(seed):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 3, (B, N, C)).astype(np.float32)
    labels = rng.integers(0, C + 1, (B, N)).astype(np.int32)   # C = bg
    weight = (rng.random((B, N)) > 0.2).astype(np.float32)
    return logits, labels, weight


@pytest.mark.parametrize('kw', [dict(), dict(gamma=1.5, alpha=0.4,
                                             loss_weight=2.0)])
@pytest.mark.parametrize('avg', [None, 7.0])
def test_focal_loss_matches_jax(kw, avg):
    logits, labels, weight = inputs(0)
    extra = {} if avg is None else dict(avg_factor=np.float32(avg))
    (v, g), (jv, jg) = value_and_grad_both(
        common.FocalLoss(**kw), j_common.FocalLoss(**kw), logits, labels,
        weight=weight, **extra)
    close(v, jv)
    close(g, jg)
    # the background label C selects no class column: an all-zero row
    x = torch.from_numpy(logits)
    bg = common.FocalLoss(reduction='sum')(x, torch.full((B, N), C))
    zeros = common.sigmoid_focal_loss(x, torch.zeros_like(x)).sum()
    close(bg.numpy(), zeros.numpy())


@pytest.mark.parametrize('name,kw', [('L1Loss', dict()),
                                     ('L1Loss', dict(loss_weight=0.5)),
                                     ('SmoothL1Loss', dict(beta=0.11)),
                                     ('SmoothL1Loss', dict(beta=1.0))])
@pytest.mark.parametrize('reduction', ['mean', 'sum'])
def test_regression_losses_match_jax(name, kw, reduction):
    rng = np.random.default_rng(1)
    pred = rng.normal(0, 1, (B, N, 5)).astype(np.float32)
    target = rng.normal(0, 1, (B, N, 5)).astype(np.float32)
    if name == 'SmoothL1Loss':
        # exact zeros only here: at |x| = 0 JAX's abs has derivative 1 and
        # PyTorch's 0, a point no training step reaches
        target[0, :5] = pred[0, :5]
    weight = (rng.random((B, N)) > 0.5).astype(np.float32)
    kw = dict(kw, reduction=reduction)
    (v, g), (jv, jg) = value_and_grad_both(
        LOSSES.build(dict(type=name, **kw)), getattr(j_common, name)(**kw),
        pred, target, weight=weight, avg_factor=np.float32(13.0))
    close(v, jv)
    close(g, jg)


@pytest.mark.parametrize('reduction', ['none', 'sum', 'mean'])
@pytest.mark.parametrize('with_weight', [False, True])
@pytest.mark.parametrize('avg', [None, 0.0, 5.0])
def test_reduce_loss_matches_jax(reduction, with_weight, avg):
    rng = np.random.default_rng(2)
    loss = rng.random((B, N)).astype(np.float32)
    weight = (rng.random((B, N)) > 0.5).astype(np.float32) \
        if with_weight else None
    got = common.reduce_loss(
        torch.from_numpy(loss),
        None if weight is None else torch.from_numpy(weight), reduction, avg)
    ref = j_common.reduce_loss(jnp.asarray(loss), weight, reduction, avg)
    close(got.numpy(), ref)


def test_elementwise_pieces_match_jax():
    logits, labels, _ = inputs(3)
    logits[0, 0] = [-90.0, 90.0, 0.0, 30.0]        # stable at the extremes
    onehot = (labels[..., None] == np.arange(C)).astype(np.float32)
    close(common.sigmoid_focal_loss(torch.from_numpy(logits),
                                    torch.from_numpy(onehot)).numpy(),
          j_common.sigmoid_focal_loss(jnp.asarray(logits), onehot))
    d = np.linspace(-2, 2, 41, dtype=np.float32)
    close(common.smooth_l1_loss(torch.from_numpy(d), torch.zeros(41),
                                beta=0.5).numpy(),
          j_common.smooth_l1_loss(jnp.asarray(d), jnp.zeros(41), beta=0.5))
    wrapped = common.weighted_loss(common.smooth_l1_loss)
    j_wrapped = j_common.weighted_loss(j_common.smooth_l1_loss)
    close(wrapped(torch.from_numpy(d), torch.zeros(41), avg_factor=3.0,
                  beta=0.5).numpy(),
          j_wrapped(jnp.asarray(d), jnp.zeros(41), avg_factor=3.0, beta=0.5))
