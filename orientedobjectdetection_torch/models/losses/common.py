"""Classification and regression losses with masked reductions
(counterpart of ``orientedobjectdetection_tpu/models/losses/common.py``).

Every loss takes an optional element-wise ``weight`` and an ``avg_factor``
(mmdet's convention): ``loss = sum(loss * weight) / avg_factor``. With
padded, masked batches the weights carry the masking, so no loss indexes
by a boolean mask and none waits for the host.
"""

from __future__ import annotations

import torch

from ...utils.registry import LOSSES


def reduce_loss(loss, weight=None, reduction: str = 'mean',
                avg_factor=None):
    if weight is not None:
        loss = loss * weight
    if reduction == 'none':
        return loss
    if reduction == 'sum':
        return loss.sum()
    if avg_factor is not None:
        return loss.sum() / torch.clamp(torch.as_tensor(
            avg_factor, dtype=loss.dtype, device=loss.device), min=1e-6)
    if weight is not None:
        return loss.sum() / weight.sum().clamp(min=1e-6)
    return loss.mean()


def weighted_loss(fn):
    """Wrap an element-wise ``fn(pred, target)`` with weight and
    reduction."""
    def wrapper(pred, target, weight=None, reduction='mean',
                avg_factor=None, **kwargs):
        return reduce_loss(fn(pred, target, **kwargs), weight, reduction,
                           avg_factor)
    return wrapper


def sigmoid_ce(logits, labels):
    """Numerically stable sigmoid cross entropy,
    ``max(x, 0) - x * t + log1p(exp(-|x|))``."""
    return torch.clamp(logits, min=0) - logits * labels + \
        torch.log1p(torch.exp(-logits.abs()))


def sigmoid_focal_loss(logits, targets_onehot, gamma: float = 2.0,
                       alpha: float = 0.25):
    """Element-wise sigmoid focal loss: logits (..., C) against
    targets_onehot (..., C) in [0, 1]."""
    p = torch.sigmoid(logits)
    ce = sigmoid_ce(logits, targets_onehot)
    p_t = p * targets_onehot + (1 - p) * (1 - targets_onehot)
    alpha_t = alpha * targets_onehot + (1 - alpha) * (1 - targets_onehot)
    return alpha_t * ((1 - p_t) ** gamma) * ce


def smooth_l1_loss(pred, target, beta: float = 1.0):
    diff = pred - target
    adiff = diff.abs()
    return torch.where(adiff < beta, 0.5 * diff * diff / beta,
                       adiff - 0.5 * beta)


def _one_hot(target, classes: int, dtype):
    """``jax.nn.one_hot``: a label outside [0, classes) is an all-zero row
    (background for the sigmoid form)."""
    return (target[..., None] == torch.arange(
        classes, device=target.device)).to(dtype)


def _per_box_weight(weight, loss):
    if weight is not None and weight.dim() < loss.dim():
        weight = weight[..., None]
    return weight


@LOSSES.register_module()
class FocalLoss:
    """mmdet-compatible sigmoid focal loss over integer labels: ``target``
    is (...,) int with ``num_classes`` meaning background (an all-zero
    one-hot row). Sums over classes before the per-prior weight."""

    def __init__(self, use_sigmoid: bool = True, gamma: float = 2.0,
                 alpha: float = 0.25, reduction: str = 'mean',
                 loss_weight: float = 1.0, activated: bool = False):
        if not use_sigmoid:
            raise ValueError('FocalLoss supports use_sigmoid=True only')
        self.gamma = gamma
        self.alpha = alpha
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        onehot = _one_hot(target, pred.shape[-1], pred.dtype)
        loss = sigmoid_focal_loss(pred, onehot, self.gamma,
                                  self.alpha).sum(-1)
        return self.loss_weight * reduce_loss(loss, weight, self.reduction,
                                              avg_factor)


@LOSSES.register_module()
class L1Loss:
    def __init__(self, reduction: str = 'mean', loss_weight: float = 1.0):
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        loss = (pred - target).abs()
        return self.loss_weight * reduce_loss(
            loss, _per_box_weight(weight, loss), self.reduction, avg_factor)


@LOSSES.register_module()
class SmoothL1Loss:
    def __init__(self, beta: float = 1.0, reduction: str = 'mean',
                 loss_weight: float = 1.0):
        self.beta = beta
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        loss = smooth_l1_loss(pred, target, self.beta)
        return self.loss_weight * reduce_loss(
            loss, _per_box_weight(weight, loss), self.reduction, avg_factor)


@LOSSES.register_module()
class CrossEntropyLoss:
    """Softmax or sigmoid cross entropy over integer labels
    (mmdet-compatible). Softmax: ``pred (..., C)`` logits and ``target
    (...)`` labels in [0, C). Sigmoid: ``target`` is either labels, one-hot
    encoded over C (C itself is background), or already (..., C) like
    ``pred``; the loss sums over C. ``use_mask`` is accepted and unused, as
    in the JAX package."""

    def __init__(self, use_sigmoid: bool = False, use_mask: bool = False,
                 reduction: str = 'mean', loss_weight: float = 1.0):
        self.use_sigmoid = use_sigmoid
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        if self.use_sigmoid:
            if target.dim() == pred.dim() - 1:
                target = _one_hot(target, pred.shape[-1], pred.dtype)
            loss = sigmoid_ce(pred, target).sum(-1)
        else:
            logp = torch.log_softmax(pred, -1)
            loss = -(_one_hot(target, pred.shape[-1], pred.dtype)
                     * logp).sum(-1)
        return self.loss_weight * reduce_loss(loss, weight, self.reduction,
                                              avg_factor)


@LOSSES.register_module()
class SmoothFocalLoss:
    """Sigmoid focal loss against soft labels in [0, 1] (the CSL angle
    branch's smoothed bins; reference ``losses/smooth_focal_loss.py``),
    summed over the bins before the per-prior weight."""

    def __init__(self, gamma: float = 2.0, alpha: float = 0.25,
                 reduction: str = 'mean', loss_weight: float = 1.0):
        self.gamma = gamma
        self.alpha = alpha
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        loss = sigmoid_focal_loss(pred, target, self.gamma,
                                  self.alpha).sum(-1)
        return self.loss_weight * reduce_loss(loss, weight, self.reduction,
                                              avg_factor)


def _xyxy(boxes):
    """(..., 5) ``(cx, cy, w, h, a)`` -> (..., 4) axis-aligned corners,
    the angle ignored."""
    half = boxes[..., 2:4] / 2
    return torch.cat([boxes[..., :2] - half, boxes[..., :2] + half], -1)


def _hbb_inter_union(pred, target, eps: float):
    p, t = _xyxy(pred), _xyxy(target)
    wh = (torch.minimum(p[..., 2:], t[..., 2:])
          - torch.maximum(p[..., :2], t[..., :2])).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = pred[..., 2] * pred[..., 3] + target[..., 2] * target[..., 3] \
        - inter
    return p, t, inter, union


def _box_weight(weight, pred):
    """A per-coordinate weight (one more dim than the per-box loss) is
    averaged over its last dim."""
    if weight is not None and weight.dim() > pred.dim() - 1:
        weight = weight.mean(-1)
    return weight


def _iou_mode_loss(ious, mode: str):
    if mode == 'linear':
        return 1 - ious
    if mode == 'square':
        return 1 - ious ** 2
    return -torch.log(ious)


@LOSSES.register_module()
class IoULoss:
    """Axis-aligned IoU loss over ``(cx, cy, w, h, 0)`` boxes (the
    separate-angle FCOS recipes' horizontal boxes in the point frame):
    ``'linear'`` 1 - IoU, ``'square'`` 1 - IoU^2 or ``'log'`` -log IoU,
    the IoU clipped to [eps, 1]."""

    def __init__(self, linear: bool = False, eps: float = 1e-6,
                 reduction: str = 'mean', loss_weight: float = 1.0,
                 mode: str = 'log'):
        self.mode = 'linear' if linear else mode
        self.eps = eps
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        _, _, inter, union = _hbb_inter_union(pred, target, self.eps)
        ious = (inter / union.clamp(min=self.eps)).clamp(self.eps, 1.0)
        return self.loss_weight * reduce_loss(
            _iou_mode_loss(ious, self.mode), _box_weight(weight, pred),
            self.reduction, avg_factor)


@LOSSES.register_module()
class GIoULoss:
    """Axis-aligned GIoU loss over ``(cx, cy, w, h, 0)`` boxes (mmdet's
    GIoULoss; ``configs/rotated_fcos/rotated_fcos_sep_angle_*.py``)."""

    def __init__(self, eps: float = 1e-6, reduction: str = 'mean',
                 loss_weight: float = 1.0):
        self.eps = eps
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        p, t, inter, union = _hbb_inter_union(pred, target, self.eps)
        union = union.clamp(min=self.eps)
        ewh = (torch.maximum(p[..., 2:], t[..., 2:])
               - torch.minimum(p[..., :2], t[..., :2])).clamp(min=0)
        enclose = (ewh[..., 0] * ewh[..., 1]).clamp(min=self.eps)
        giou = inter / union - (enclose - union) / enclose
        return self.loss_weight * reduce_loss(
            1 - giou, _box_weight(weight, pred), self.reduction, avg_factor)
