"""Gaussian-distribution box losses, the GWD / KLD / JD / BCD families
(counterpart of ``orientedobjectdetection_tpu/models/losses/
gaussian_dist_loss.py``; reference ``losses/gaussian_dist_loss.py`` and
``gaussian_dist_loss_v1.py``).

A rotated box becomes a 2-D Gaussian, mu = (x, y) and
Sigma = R diag((w/2)^2, (h/2)^2) R^T, and the loss is a closed-form
distance between two of them. Every 2x2 determinant, inverse and trace is
written out element-wise, as in the JAX package, so the two agree to float
rounding.
"""

from __future__ import annotations

import torch

from ...utils.registry import LOSSES
from .common import reduce_loss


def _sigma(s11, s12, s22, lead):
    return torch.stack([s11, s12, s12, s22], -1).reshape(lead + (2, 2))


def xy_wh_r_2_xy_sigma(xywhr):
    """(..., 5) -> mu (..., 2), Sigma (..., 2, 2); w and h clamped to
    [1e-7, 1e7]."""
    wh = xywhr[..., 2:4].clamp(1e-7, 1e7)
    r = xywhr[..., 4]
    cos_r, sin_r = torch.cos(r), torch.sin(r)
    a = (0.5 * wh[..., 0]) ** 2
    b = (0.5 * wh[..., 1]) ** 2
    return xywhr[..., :2], _sigma(a * cos_r ** 2 + b * sin_r ** 2,
                                  (a - b) * sin_r * cos_r,
                                  a * sin_r ** 2 + b * cos_r ** 2,
                                  xywhr.shape[:-1])


def xy_stddev_pearson_2_xy_sigma(xysp):
    """(..., 5) ``(x, y, std_x, std_y, pearson)`` -> mu, Sigma; the
    correlation clamped to (-1, 1) by 1e-7."""
    stddev = xysp[..., 2:4]
    pearson = xysp[..., 4].clamp(1e-7 - 1, 1 - 1e-7)
    covar = pearson * stddev[..., 0] * stddev[..., 1]
    var = stddev ** 2
    return xysp[..., :2], _sigma(var[..., 0], covar, var[..., 1],
                                 xysp.shape[:-1])


def _det2(s):
    return s[..., 0, 0] * s[..., 1, 1] - s[..., 0, 1] * s[..., 1, 0]


def _trace2(s):
    return s[..., 0, 0] + s[..., 1, 1]


def _trace_prod2(a, b):
    """Tr(A @ B) of (..., 2, 2) matrices."""
    return (a[..., 0, 0] * b[..., 0, 0] + a[..., 0, 1] * b[..., 1, 0] +
            a[..., 1, 0] * b[..., 0, 1] + a[..., 1, 1] * b[..., 1, 1])


def postprocess(distance, fun: str = 'log1p', tau: float = 1.0):
    """Distance -> loss: ``log1p``, ``sqrt`` (of the distance clamped at
    1e-7) or ``none``, then ``1 - 1 / (tau + d)`` when ``tau >= 1``."""
    if fun == 'log1p':
        distance = torch.log1p(distance)
    elif fun == 'sqrt':
        distance = torch.sqrt(distance.clamp(min=1e-7))
    elif fun != 'none':
        raise ValueError(f'fun {fun!r}')
    if tau >= 1.0:
        return 1 - 1 / (tau + distance)
    return distance


def gwd(pred, target, alpha: float = 1.0, normalize: bool = True):
    """Square root of the Gaussian Wasserstein distance, with the 2x2
    identity Tr(Z^1/2) = sqrt(Tr(Sp St) + 2 sqrt(det Sp det St))."""
    xy_p, sp = pred
    xy_t, st = target
    xy_d = ((xy_p - xy_t) ** 2).sum(-1)
    t_det_sqrt = torch.sqrt((_det2(sp) * _det2(st)).clamp(min=1e-7))
    whr_d = _trace2(sp) + _trace2(st) - 2 * torch.sqrt(
        (_trace_prod2(sp, st) + 2 * t_det_sqrt).clamp(min=1e-7))
    dis = torch.sqrt((xy_d + alpha * alpha * whr_d).clamp(min=1e-7))
    if normalize:
        dis = dis / (2 * torch.sqrt(torch.sqrt(
            t_det_sqrt.clamp(min=1e-7))).clamp(min=1e-7))
    return dis


def kld(pred, target, alpha: float = 1.0, sqrt: bool = True):
    """KL divergence between the two Gaussians, with the inverse of the
    prediction's covariance."""
    xy_p, sp = pred
    xy_t, st = target
    det_p = _det2(sp)
    inv00 = sp[..., 1, 1] / det_p
    inv01 = -sp[..., 0, 1] / det_p
    inv10 = -sp[..., 1, 0] / det_p
    inv11 = sp[..., 0, 0] / det_p
    dx = xy_p[..., 0] - xy_t[..., 0]
    dy = xy_p[..., 1] - xy_t[..., 1]
    xy_d = 0.5 * (dx * (inv00 * dx + inv01 * dy) +
                  dy * (inv10 * dx + inv11 * dy))
    tr = inv00 * st[..., 0, 0] + inv01 * st[..., 1, 0] + \
        inv10 * st[..., 0, 1] + inv11 * st[..., 1, 1]
    whr_d = 0.5 * tr + 0.5 * (torch.log(det_p) - torch.log(_det2(st))) - 1
    dis = xy_d / (alpha * alpha) + whr_d
    if sqrt:
        dis = torch.sqrt(dis.clamp(min=1e-7))
    return dis


def bcd(pred, target, alpha: float = 1.0, sqrt: bool = True):
    """Bhattacharyya distance between the two Gaussians."""
    xy_p, sp = pred
    xy_t, st = target
    sm = 0.5 * (sp + st)
    det_m = _det2(sm)
    inv00 = sm[..., 1, 1] / det_m
    inv01 = -sm[..., 0, 1] / det_m
    inv11 = sm[..., 0, 0] / det_m
    dx = xy_p[..., 0] - xy_t[..., 0]
    dy = xy_p[..., 1] - xy_t[..., 1]
    xy_d = 0.125 * (dx * (inv00 * dx + inv01 * dy) +
                    dy * (inv01 * dx + inv11 * dy))
    whr_d = 0.5 * torch.log(det_m / torch.sqrt(
        (_det2(sp) * _det2(st)).clamp(min=1e-7)))
    dis = alpha * alpha * xy_d + whr_d
    if sqrt:
        dis = torch.sqrt(dis.clamp(min=1e-7))
    return dis


_PREPROCESS = {'xy_wh_r': xy_wh_r_2_xy_sigma,
               'xy_stddev_pearson': xy_stddev_pearson_2_xy_sigma}


@LOSSES.register_module()
class GDLoss:
    """Gaussian-distance loss (reference ``gaussian_dist_loss.py:312-408``):
    ``loss_type`` ``gwd``, ``kld``, ``jd`` (the mean of both KLDs),
    ``kld_symmax`` or ``kld_symmin``; ``sqrt`` (default true) and
    ``normalize`` (GWD, default true) come as keyword options."""

    def __init__(self, loss_type: str, representation: str = 'xy_wh_r',
                 fun: str = 'log1p', tau: float = 0.0, alpha: float = 1.0,
                 reduction: str = 'mean', loss_weight: float = 1.0,
                 **kwargs):
        if loss_type not in ('gwd', 'kld', 'jd', 'kld_symmax', 'kld_symmin'):
            raise ValueError(f'loss_type {loss_type!r}')
        if fun not in ('log1p', 'none', 'sqrt'):
            raise ValueError(f'fun {fun!r}')
        self.loss_type = loss_type
        self.preprocess = _PREPROCESS[representation]
        self.fun = fun
        self.tau = tau
        self.alpha = alpha
        self.reduction = reduction
        self.loss_weight = loss_weight
        self.kwargs = kwargs

    def _distance(self, p, t):
        if self.loss_type == 'gwd':
            return gwd(p, t, self.alpha, self.kwargs.get('normalize', True))
        sqrt = self.kwargs.get('sqrt', True)
        if self.loss_type == 'kld':
            return kld(p, t, self.alpha, sqrt)
        if self.loss_type == 'jd':
            d = 0.5 * (kld(p, t, self.alpha, False) +
                       kld(t, p, self.alpha, False))
            return torch.sqrt(d.clamp(min=1e-7)) if sqrt else d
        kpt = kld(p, t, self.alpha, sqrt)
        ktp = kld(t, p, self.alpha, sqrt)
        if self.loss_type == 'kld_symmax':
            return torch.maximum(kpt, ktp)
        return torch.minimum(kpt, ktp)

    def __call__(self, pred, target, weight=None, avg_factor=None):
        if weight is not None and weight.dim() == pred.dim():
            weight = weight.mean(-1)
        loss = postprocess(self._distance(self.preprocess(pred),
                                          self.preprocess(target)),
                           self.fun, self.tau)
        return self.loss_weight * reduce_loss(loss, weight, self.reduction,
                                              avg_factor)


@LOSSES.register_module()
class GDLoss_v1:
    """The first Gaussian-distance set (reference
    ``gaussian_dist_loss_v1.py``): ``gwd``, ``kld`` or ``bcd`` on the
    ``xy_wh_r`` representation."""

    _DISTANCE = {'gwd': gwd, 'kld': kld, 'bcd': bcd}

    def __init__(self, loss_type: str, fun: str = 'log1p', tau: float = 0.0,
                 alpha: float = 1.0, reduction: str = 'mean',
                 loss_weight: float = 1.0, **kwargs):
        if loss_type not in self._DISTANCE:
            raise ValueError(f'loss_type {loss_type!r}')
        if fun not in ('log1p', 'none', 'sqrt'):
            raise ValueError(f'fun {fun!r}')
        self.loss_type = loss_type
        self.fun = fun
        self.tau = tau
        self.alpha = alpha
        self.reduction = reduction
        self.loss_weight = loss_weight
        self.kwargs = kwargs

    def __call__(self, pred, target, weight=None, avg_factor=None):
        if weight is not None and weight.dim() == pred.dim():
            weight = weight.mean(-1)
        option = self.kwargs.get('normalize' if self.loss_type == 'gwd'
                                 else 'sqrt', True)
        d = self._DISTANCE[self.loss_type](xy_wh_r_2_xy_sigma(pred),
                                           xy_wh_r_2_xy_sigma(target),
                                           self.alpha, option)
        return self.loss_weight * reduce_loss(
            postprocess(d, self.fun, self.tau), weight, self.reduction,
            avg_factor)
