"""Port parity, the box losses of the single-stage recipes: every
``GDLoss`` type x representation x ``fun``, ``GDLoss_v1``, ``KFLoss``,
``RotatedIoULoss``, the differentiable rotated IoU, ``SmoothFocalLoss``,
``IoULoss`` and ``GIoULoss``, against the JAX package on numpy-seeded boxes.

Values at rtol 1e-5 (float32, the same element-wise formulas); gradients
against ``jax.grad`` at rtol 1e-4 with an absolute floor of 1e-6 of each
tensor's largest entry."""

import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orientedobjectdetection_tpu.models.losses import common as j_common
from orientedobjectdetection_tpu.models.losses import \
    gaussian_dist_loss as j_gd
from orientedobjectdetection_tpu.models.losses import kf_iou_loss as j_kf
from orientedobjectdetection_tpu.models.losses import \
    rotated_iou_loss as j_riou
from orientedobjectdetection_tpu.ops.iou import \
    diff_iou_rotated_2d as j_diff_iou
from orientedobjectdetection_torch.models.losses import (
    GDLoss, GDLoss_v1, GIoULoss, IoULoss, KFLoss, RotatedIoULoss,
    SmoothFocalLoss)
from orientedobjectdetection_torch.ops.iou import diff_iou_rotated_2d

torch.set_num_threads(1)

N = 48


def seeded(*parts):
    """A numpy generator seeded by the test's parameters."""
    return np.random.default_rng(zlib.crc32(repr(parts).encode()))


def boxes(rng, n=N, center=64.0):
    """(n, 5) float32 ``(x, y, w, h, a)``."""
    return np.stack([rng.uniform(center - 30, center + 30, n),
                     rng.uniform(center - 30, center + 30, n),
                     rng.uniform(4, 60, n), rng.uniform(4, 60, n),
                     rng.uniform(-1.5, 1.5, n)], -1).astype(np.float32)


def pearson_boxes(rng, n=N):
    """(n, 5) float32 ``(x, y, std_x, std_y, pearson)``."""
    return np.stack([rng.uniform(30, 90, n), rng.uniform(30, 90, n),
                     rng.uniform(2, 30, n), rng.uniform(2, 30, n),
                     rng.uniform(-0.9, 0.9, n)], -1).astype(np.float32)


def near(rng, target, spread=4.0):
    """Predictions near their targets: a loss with a useful gradient."""
    p = target.copy()
    p[:, :2] += rng.normal(0, spread, (len(p), 2))
    p[:, 2:4] *= rng.uniform(0.7, 1.4, (len(p), 2))
    p[:, 4] += rng.normal(0, 0.2, len(p))
    return p.astype(np.float32)


def check(torch_fn, jax_fn, *arrays, grad_of=0):
    """The same loss in both packages: the value, and the gradient with
    respect to ``arrays[grad_of]``."""
    t_args = [torch.from_numpy(a) for a in arrays]
    t_args[grad_of].requires_grad_(True)
    got = torch_fn(*t_args)
    got.backward()
    j_args = [jnp.asarray(a) for a in arrays]

    def f(x):
        args = list(j_args)
        args[grad_of] = x
        return jax_fn(*args)

    ref, ref_grad = jax.value_and_grad(f)(j_args[grad_of])
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    ref_grad = np.asarray(ref_grad)
    assert np.abs(ref_grad).max() > 0
    np.testing.assert_allclose(t_args[grad_of].grad.numpy(), ref_grad,
                               rtol=1e-4,
                               atol=1e-6 * np.abs(ref_grad).max())


def weights(rng):
    return (rng.random(N) < 0.7).astype(np.float32)


@pytest.mark.parametrize('fun', ['log1p', 'none', 'sqrt'])
@pytest.mark.parametrize('representation', ['xy_wh_r', 'xy_stddev_pearson'])
@pytest.mark.parametrize('loss_type',
                         ['gwd', 'kld', 'jd', 'kld_symmax', 'kld_symmin'])
def test_gdloss_matches_jax(loss_type, representation, fun):
    rng = seeded(loss_type, representation, fun)
    make = boxes if representation == 'xy_wh_r' else pearson_boxes
    target = make(rng)
    pred = near(rng, target)
    if representation == 'xy_stddev_pearson':
        pred[:, 4] = np.clip(pred[:, 4], -0.95, 0.95)
    w = weights(rng)
    kw = dict(loss_type=loss_type, representation=representation, fun=fun,
              tau=1.0 if fun == 'log1p' else 0.0, loss_weight=2.0)
    port, ref = GDLoss(**kw), j_gd.GDLoss(**kw)
    check(lambda p, t, ww: port(p, t, weight=ww, avg_factor=7.0),
          lambda p, t, ww: ref(p, t, weight=ww, avg_factor=7.0),
          pred, target, w)


@pytest.mark.parametrize('option', [True, False])
@pytest.mark.parametrize('fun', ['log1p', 'none', 'sqrt'])
@pytest.mark.parametrize('loss_type', ['gwd', 'kld', 'bcd'])
def test_gdloss_v1_matches_jax(loss_type, fun, option):
    """``option``: ``normalize`` for GWD, ``sqrt`` for KLD and BCD."""
    rng = seeded(loss_type, fun, option)
    target = boxes(rng)
    pred = near(rng, target)
    w = weights(rng)
    key = 'normalize' if loss_type == 'gwd' else 'sqrt'
    kw = dict(loss_type=loss_type, fun=fun, tau=1.0, loss_weight=1.5,
              **{key: option})
    port, ref = GDLoss_v1(**kw), j_gd.GDLoss_v1(**kw)
    check(lambda p, t, ww: port(p, t, weight=ww, avg_factor=5.0),
          lambda p, t, ww: ref(p, t, weight=ww, avg_factor=5.0),
          pred, target, w)


@pytest.mark.parametrize('fun', ['none', 'ln', 'exp'])
def test_kfloss_matches_jax(fun):
    """Deltas for the centre term, decoded boxes for the covariances."""
    rng = seeded('kf', fun)
    target_boxes = boxes(rng)
    pred_boxes = near(rng, target_boxes)
    deltas_t = rng.normal(0, 0.3, (N, 5)).astype(np.float32)
    deltas_p = (deltas_t + rng.normal(0, 0.2, (N, 5))).astype(np.float32)
    w = weights(rng)
    port, ref = KFLoss(fun=fun, loss_weight=5.0), j_kf.KFLoss(
        fun=fun, loss_weight=5.0)
    for grad_of in (0, 2):
        check(lambda p, t, pd, td, ww: port(p, t, weight=ww, avg_factor=9.0,
                                            pred_decode=pd,
                                            targets_decode=td),
              lambda p, t, pd, td, ww: ref(p, t, weight=ww, avg_factor=9.0,
                                           pred_decode=pd,
                                           targets_decode=td),
              deltas_p, deltas_t, pred_boxes, target_boxes, w,
              grad_of=grad_of)


@pytest.mark.parametrize('mode', ['linear', 'square', 'log'])
def test_rotated_iou_loss_matches_jax(mode):
    rng = seeded('riou', mode)
    target = boxes(rng)
    pred = near(rng, target)
    w = weights(rng)
    port, ref = RotatedIoULoss(mode=mode), j_riou.RotatedIoULoss(mode=mode)
    check(lambda p, t, ww: port(p, t, weight=ww, avg_factor=11.0),
          lambda p, t, ww: ref(p, t, weight=ww, avg_factor=11.0),
          pred, target, w)
    assert RotatedIoULoss(linear=True, mode=mode).mode == 'linear'


def _pairs(kind, rng):
    """Aligned box pairs: identical, disjoint, or the first inside the
    second, with random angles."""
    a = boxes(rng, 16)
    b = a.copy()
    if kind == 'disjoint':
        b[:, 0] += 200.0
    elif kind == 'contained':
        a[:, 2:4] *= 0.3
        a[:, :2] += rng.uniform(-2, 2, (16, 2))
    return a, b


@pytest.mark.parametrize('kind', ['identical', 'disjoint', 'contained',
                                  'overlapping'])
def test_diff_iou_rotated_2d_matches_jax(kind):
    rng = seeded('diff_iou', kind)
    if kind == 'overlapping':
        b = boxes(rng, 16)
        a = near(rng, b)
    else:
        a, b = _pairs(kind, rng)
    got = diff_iou_rotated_2d(torch.from_numpy(a), torch.from_numpy(b))
    ref = np.asarray(j_diff_iou(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    expect = {'identical': 1.0, 'disjoint': 0.0}
    if kind in expect:
        np.testing.assert_allclose(got.numpy(), expect[kind], atol=1e-5)
    if kind == 'contained':
        area = a[:, 2] * a[:, 3] / (b[:, 2] * b[:, 3])
        np.testing.assert_allclose(got.numpy(), area, rtol=1e-4)
    if kind != 'disjoint':            # disjoint boxes: a zero gradient
        w = rng.random(16).astype(np.float32)
        check(lambda p, t, ww: (diff_iou_rotated_2d(p, t) * ww).sum(),
              lambda p, t, ww: (j_diff_iou(p, t) * ww).sum(), a, b, w)


def test_diff_iou_gradient_at_a_zero_height_box():
    """A known deviation (ROADMAP C): at a box of exactly zero height the
    IoU's gradient with respect to that height is a tie between coincident
    edges, which the two packages split differently (0.0034 in JAX,
    0.0071 in the port, for this pair). The value, the other components,
    and the gradient at heights of 1e-6 and 1e-4 agree."""
    p = np.array([[36.427013, 44.88941, 1.9732101, 0.0, 1.1231879]],
                 np.float32)
    t = np.array([[32.028065, 38.134705, 31.232018, 13.746226, 1.4430534]],
                 np.float32)

    def grads(pred):
        x = torch.from_numpy(pred).requires_grad_(True)
        diff_iou_rotated_2d(x, torch.from_numpy(t)).sum().backward()
        ref = jax.grad(lambda a: j_diff_iou(a, jnp.asarray(t)).sum())(
            jnp.asarray(pred))
        return x.grad.numpy()[0], np.asarray(ref)[0]

    for h in (1e-6, 1e-4):
        q = p.copy()
        q[0, 3] = h
        got, ref = grads(q)
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-9)
    got, ref = grads(p)
    np.testing.assert_allclose(np.delete(got, 3), np.delete(ref, 3),
                               atol=1e-8)
    assert abs(got[3] - ref[3]) > 1e-3          # the recorded deviation


def test_smooth_focal_loss_matches_jax():
    rng = seeded('smooth_focal')
    logits = rng.normal(0, 2, (N, 36)).astype(np.float32)
    soft = np.exp(-rng.uniform(0, 6, (N, 36)) ** 2 / 8).astype(np.float32)
    w = weights(rng)
    port = SmoothFocalLoss(gamma=2.0, alpha=0.25, loss_weight=0.8)
    ref = j_common.SmoothFocalLoss(gamma=2.0, alpha=0.25, loss_weight=0.8)
    check(lambda p, t, ww: port(p, t, weight=ww, avg_factor=3.0),
          lambda p, t, ww: ref(p, t, weight=ww, avg_factor=3.0),
          logits, soft, w)


@pytest.mark.parametrize('name', ['iou_linear', 'iou_square', 'iou_log',
                                  'giou'])
def test_axis_aligned_iou_losses_match_jax(name):
    rng = seeded('hbb', name)
    target = boxes(rng)
    target[:, 4] = 0.0
    pred = near(rng, target)
    pred[:, 4] = 0.0
    w = weights(rng)
    if name == 'giou':
        port, ref = GIoULoss(loss_weight=1.5), j_common.GIoULoss(
            loss_weight=1.5)
    else:
        mode = name.split('_')[1]
        port, ref = IoULoss(mode=mode), j_common.IoULoss(mode=mode)
    check(lambda p, t, ww: port(p, t, weight=ww, avg_factor=4.0),
          lambda p, t, ww: ref(p, t, weight=ww, avg_factor=4.0),
          pred, target, w)
