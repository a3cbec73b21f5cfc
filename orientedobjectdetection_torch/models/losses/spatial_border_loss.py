"""Spatial border loss, Oriented RepPoints (counterpart of
``orientedobjectdetection_tpu/models/losses/spatial_border_loss.py``;
reference ``losses/spatial_border_loss.py``): each learned point outside
its assigned gt polygon costs its distance to the polygon's centre.

Each point set is tested against its own polygon only
(``ops.points.points_in_own_polygon``): the JAX package writes the test as
the diagonal of an (N, N) matrix, which XLA fuses away and eager PyTorch
would not (N is every location of the batch)."""

from __future__ import annotations

import torch

from ...ops.points import _sum, points_in_own_polygon
from ...utils.registry import LOSSES
from .common import reduce_loss


@LOSSES.register_module()
class SpatialBorderLoss:
    def __init__(self, reduction: str = 'mean', loss_weight: float = 1.0):
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pts, gt_polys, weight=None, avg_factor=None):
        """pts (N, 2 P); gt_polys (N, 8)."""
        p = pts.reshape(pts.shape[0], -1, 2)
        ctr_x = _sum(gt_polys[:, 0::2]) / 4
        ctr_y = _sum(gt_polys[:, 1::2]) / 4
        inside = points_in_own_polygon(p, gt_polys[:, None, :])  # (N, P)
        d2 = (p[..., 0] - ctr_x[:, None]) ** 2 + \
            (p[..., 1] - ctr_y[:, None]) ** 2
        # a point exactly at the centre: distance 0 with gradient 0 (the
        # square root's is infinite there, and times a zero weight or the
        # inside mask it made the whole step's gradient NaN)
        away = d2 > 0
        d = torch.where(away, torch.sqrt(torch.where(away, d2, 1.0)), 0.0)
        loss = torch.where(inside, 0.0, d).sum(-1)
        return self.loss_weight * reduce_loss(loss, weight, self.reduction,
                                              avg_factor)
