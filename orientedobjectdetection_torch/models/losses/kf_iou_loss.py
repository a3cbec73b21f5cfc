"""Kalman-filter IoU loss (counterpart of
``orientedobjectdetection_tpu/models/losses/kf_iou_loss.py``; reference
``losses/kf_iou_loss.py:38-161``).

The overlap of two Gaussians is the volume of their Kalman-fused
covariance, Sigma = Sp - Sp (Sp + St)^-1 Sp, and
KFIoU = V(Sigma) / (V(Sp) + V(St) - V(Sigma)). The centre term is a smooth
L1 on the encoded deltas; the covariances come from the decoded boxes
(``pred_decode`` / ``targets_decode``), which the KFIoU head passes.
"""

from __future__ import annotations

import torch

from ...utils.registry import LOSSES
from .common import reduce_loss
from .gaussian_dist_loss import _det2, xy_wh_r_2_xy_sigma


def kfiou_loss(pred, target, pred_decode, targets_decode, fun=None,
               beta: float = 1.0 / 9.0, eps: float = 1e-6):
    """Per-box loss, (..., 5) each -> (...)."""
    _, sp = xy_wh_r_2_xy_sigma(pred_decode)
    _, st = xy_wh_r_2_xy_sigma(targets_decode)
    diff = (pred[..., :2] - target[..., :2]).abs()
    xy_loss = torch.where(diff < beta, 0.5 * diff * diff / beta,
                          diff - 0.5 * beta).sum(-1)
    vb_p = 4 * torch.sqrt(_det2(sp).clamp(min=0))
    vb_t = 4 * torch.sqrt(_det2(st).clamp(min=0))
    s = sp + st
    det_s = _det2(s)
    i00 = s[..., 1, 1] / det_s
    i01 = -s[..., 0, 1] / det_s
    i11 = s[..., 0, 0] / det_s
    p00, p01, p11 = sp[..., 0, 0], sp[..., 0, 1], sp[..., 1, 1]
    k00 = p00 * i00 + p01 * i01           # K = Sp (Sp + St)^-1
    k01 = p00 * i01 + p01 * i11
    k10 = p01 * i00 + p11 * i01
    k11 = p01 * i01 + p11 * i11
    s00 = p00 - (k00 * p00 + k01 * p01)   # Sigma = Sp - K Sp
    s01 = p01 - (k00 * p01 + k01 * p11)
    s10 = p01 - (k10 * p00 + k11 * p01)
    s11 = p11 - (k10 * p01 + k11 * p11)
    vb = 4 * torch.sqrt((s00 * s11 - s01 * s10).clamp(min=0))
    vb = torch.where(torch.isnan(vb), vb.new_zeros(()), vb)
    kfiou = vb / (vb_p + vb_t - vb + eps)
    if fun == 'ln':
        kf = -torch.log(kfiou + eps)
    elif fun == 'exp':
        kf = torch.exp(1 - kfiou) - 1
    else:
        kf = 1 - kfiou
    return (xy_loss + kf).clamp(min=0)


@LOSSES.register_module()
class KFLoss:
    """``fun``: ``none`` (1 - KFIoU), ``ln`` (-log KFIoU) or ``exp``
    (exp(1 - KFIoU) - 1)."""

    def __init__(self, fun: str = 'none', reduction: str = 'mean',
                 loss_weight: float = 1.0, **kwargs):
        if fun not in ('none', 'ln', 'exp'):
            raise ValueError(f'fun {fun!r}')
        self.fun = fun
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 pred_decode=None, targets_decode=None):
        if weight is not None and weight.dim() == pred.dim():
            weight = weight.mean(-1)
        loss = kfiou_loss(pred, target, pred_decode, targets_decode,
                          self.fun)
        return self.loss_weight * reduce_loss(loss, weight, self.reduction,
                                              avg_factor)
