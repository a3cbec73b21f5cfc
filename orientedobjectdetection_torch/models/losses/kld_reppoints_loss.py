"""KLD loss of point sets, G-RepPoints (counterpart of
``orientedobjectdetection_tpu/models/losses/kld_reppoints_loss.py``;
reference ``losses/kld_reppoints_loss.py``): a one-component Gaussian is
fitted to each predicted point set (:func:`...core.gmm.gmm_fit`, two EM
steps), its KL divergence to the gt polygon's Gaussian (the L = 3
convention of ``ops.boxes.gt2gaussian_poly``) is taken, and the loss is
``1 - 1 / (2 + sqrt(KL))``."""

from __future__ import annotations

import torch

from ...core.gmm import gmm_fit
from ...ops.boxes import gt2gaussian_poly
from ...utils.registry import LOSSES
from .common import reduce_loss


def kld_fitted_to_gt(pts, gt_polys, eps: float = 1e-6):
    """KL(fitted point-set Gaussian || gt Gaussian) per row: pts (N, 2 P),
    gt_polys (N, 8) -> (N,). ``0.5 (d' St^-1 d + tr(St^-1 Sp) + log det St /
    det Sp) - 1``, each determinant held at least 1e-12."""
    p = pts.reshape(pts.shape[0], -1, 2)
    _, mu_p, cov_p = gmm_fit(p, n_components=1, n_iter=2, eps=eps)
    mu_p, sigma_p = mu_p[:, 0], cov_p[:, 0]
    mu_t, sigma_t = gt2gaussian_poly(gt_polys)
    floor = sigma_p.new_full((), 1e-12)
    det_t = torch.maximum(sigma_t[:, 0, 0] * sigma_t[:, 1, 1] -
                          sigma_t[:, 0, 1] * sigma_t[:, 1, 0], floor)
    det_p = torch.maximum(sigma_p[:, 0, 0] * sigma_p[:, 1, 1] -
                          sigma_p[:, 0, 1] * sigma_p[:, 1, 0], floor)
    inv00 = sigma_t[:, 1, 1] / det_t
    inv01 = -sigma_t[:, 0, 1] / det_t
    inv11 = sigma_t[:, 0, 0] / det_t
    dx = mu_p[:, 0] - mu_t[:, 0]
    dy = mu_p[:, 1] - mu_t[:, 1]
    term1 = dx * (inv00 * dx + inv01 * dy) + dy * (inv01 * dx + inv11 * dy)
    tr = inv00 * sigma_p[:, 0, 0] + 2 * inv01 * sigma_p[:, 0, 1] + \
        inv11 * sigma_p[:, 1, 1]
    return 0.5 * (term1 + tr + torch.log(det_t / det_p)) - 1.0


@LOSSES.register_module()
class KLDRepPointsLoss:
    def __init__(self, eps: float = 1e-6, reduction: str = 'mean',
                 loss_weight: float = 1.0):
        self.eps = eps
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pts, gt_polys, weight=None, avg_factor=None):
        """pts (N, 2 P); gt_polys (N, 8)."""
        kld = kld_fitted_to_gt(pts, gt_polys, self.eps)
        kld = torch.maximum(kld, kld.new_full((), self.eps))
        loss = 1.0 - 1.0 / (2.0 + torch.sqrt(kld))
        return self.loss_weight * reduce_loss(loss, weight, self.reduction,
                                              avg_factor)
