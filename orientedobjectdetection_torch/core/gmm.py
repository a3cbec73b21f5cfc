"""Batched EM Gaussian mixture over 2-D point sets (counterpart of
``orientedobjectdetection_tpu/core/gmm.py``; reference
``core/bbox/utils/gmm.py``), with a fixed iteration count and no
convergence test, so a call never waits for the host.

The sums over a set's few points run in index order (``ops.points._sum``):
the fit does not depend on the device or on the batch it is part of."""

from __future__ import annotations

import numpy as np
import torch

from ..ops.points import _sum


def _det2(s):
    return s[..., 0, 0] * s[..., 1, 1] - s[..., 0, 1] * s[..., 1, 0]


def gmm_fit(points: torch.Tensor, n_components: int = 2, n_iter: int = 10,
            eps: float = 1e-6):
    """EM fit over (..., N, 2) point sets.

    Initialisation: the means are the points at ``linspace(0, N - 1, K)``
    (truncated), the weights uniform, each covariance the diagonal of the
    set's variance (over N) plus ``eps``. Each of the ``n_iter`` steps
    takes responsibilities from the Gaussians' log densities (softmax over
    the components), then the weights ``nk / N``, the means and the
    covariances (plus ``eps * I``), with ``nk`` the responsibilities'
    sums plus ``eps``.

    Returns (weights (..., K), means (..., K, 2), covs (..., K, 2, 2))."""
    n = points.shape[-2]
    k = n_components
    lead = points.shape[:-2]
    # the starting points by position (a list index would be a tensor copied
    # from the host, which waits for the device)
    idx = np.linspace(0, n - 1, k).astype(np.int32).tolist()
    mu = torch.stack([points[..., i, :] for i in idx], -2)  # (..., K, 2)
    w = points.new_full(lead + (k,), 1.0 / k)
    mean = _sum(points, -2) / n
    var0 = _sum((points - mean[..., None, :]) ** 2, -2) / n + eps
    zero = torch.zeros_like(var0[..., 0])
    cov = torch.stack([var0[..., 0], zero, zero, var0[..., 1]], -1)
    cov = cov.reshape(lead + (1, 2, 2)).expand(lead + (k, 2, 2))
    eye = torch.eye(2, dtype=points.dtype, device=points.device)
    for _ in range(n_iter):
        d = points[..., :, None, :] - mu[..., None, :, :]   # (..., N, K, 2)
        det = torch.maximum(_det2(cov), cov.new_full((), eps))  # (..., K)
        i00 = cov[..., 1, 1] / det
        i01 = -cov[..., 0, 1] / det
        i11 = cov[..., 0, 0] / det
        quad = (d[..., 0] ** 2 * i00[..., None, :] +
                2 * d[..., 0] * d[..., 1] * i01[..., None, :] +
                d[..., 1] ** 2 * i11[..., None, :])
        logp = -0.5 * quad - 0.5 * torch.log(det)[..., None, :] + \
            torch.log(torch.maximum(w, w.new_full((), eps)))[..., None, :]
        r = torch.softmax(logp, dim=-1)                     # (..., N, K)
        nk = _sum(r, -2) + eps                              # (..., K)
        w = nk / n
        mu = _sum(r[..., None] * points[..., :, None, :], -3) / nk[..., None]
        d2 = points[..., :, None, :] - mu[..., None, :, :]  # (..., N, K, 2)
        outer = d2[..., :, None] * d2[..., None, :]         # (..., N, K, 2, 2)
        cov = _sum(r[..., None, None] * outer, -4) / nk[..., None, None] + \
            eps * eye
    return w, mu, cov
