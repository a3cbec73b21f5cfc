"""Rotated IoU loss (counterpart of
``orientedobjectdetection_tpu/models/losses/rotated_iou_loss.py``; reference
``losses/rotated_iou_loss.py:17-139``) on the port's differentiable
aligned rotated IoU, :func:`...ops.iou.diff_iou_rotated_2d`."""

from __future__ import annotations

from ...ops.iou import diff_iou_rotated_2d
from ...utils.registry import LOSSES
from .common import _box_weight, _iou_mode_loss, reduce_loss


@LOSSES.register_module()
class RotatedIoULoss:
    """``'linear'`` 1 - IoU, ``'square'`` 1 - IoU^2 or ``'log'`` -log IoU
    (``linear=True`` picks ``'linear'``), the IoU clipped to [eps, 1]."""

    def __init__(self, linear: bool = False, eps: float = 1e-6,
                 reduction: str = 'mean', loss_weight: float = 1.0,
                 mode: str = 'log'):
        if mode not in ('linear', 'square', 'log'):
            raise ValueError(f'mode {mode!r}')
        self.mode = 'linear' if linear else mode
        self.eps = eps
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        ious = diff_iou_rotated_2d(pred, target).clamp(self.eps, 1.0)
        return self.loss_weight * reduce_loss(
            _iou_mode_loss(ious, self.mode), _box_weight(weight, pred),
            self.reduction, avg_factor)
