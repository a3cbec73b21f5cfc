"""RoIAlignRotated over an FPN pyramid, gather formulation (counterpart of
``orientedobjectdetection_tpu/ops/roi_align_rotated.py``; reference
``mmcv.ops.RoIAlignRotated`` routed per level by
``roi_extractors/rotate_single_level_roi_extractor.py:14-167``).

All pyramid levels are flattened into one ``(B, sum_l H_l*W_l, C)`` buffer;
each RoI's level selects a row offset and a width, the rotated sample grid
is computed for every RoI at once, and four ``gather``s read the bilinear
corners. Differentiable with respect to the features by autograd; the
plain version of the CUDA kernel in :mod:`.roi_align_kernels`.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def level_of_rois(rois: torch.Tensor, num_levels: int,
                  finest_scale: float = 56.0) -> torch.Tensor:
    """FPN level per RoI, (B, R) int64:
    ``floor(log2(sqrt(w * h) / finest_scale + 1e-6))`` clamped to the
    pyramid (reference ``rotate_single_level_roi_extractor.py:68-88``)."""
    scale = torch.sqrt((rois[..., 2] * rois[..., 3]).clamp(min=1e-12))
    lvl = torch.floor(torch.log2(scale / finest_scale + 1e-6))
    return lvl.clamp(0, num_levels - 1).long()


def roi_align_rotated(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                      out_size: Tuple[int, int] = (7, 7),
                      spatial_scales: Sequence[float] = (1 / 8, 1 / 16,
                                                         1 / 32, 1 / 64),
                      sampling_ratio: int = 2,
                      finest_scale: float = 56.0,
                      clockwise: bool = False) -> torch.Tensor:
    """Rotated RoIAlign across pyramid levels.

    Args:
        feats: per-level (B, H_l, W_l, C) channels-last, strides =
            1 / spatial_scales.
        rois: (B, R, 5) [cx, cy, w, h, theta] in image coordinates.
        out_size: (out_h, out_w) bins.
        sampling_ratio: s -> s*s sample points per bin.
        clockwise: mmcv's flag; negates theta.

    Returns:
        (B, R, out_h, out_w, C) in the features' dtype. Gathered values are
        upcast to float32, weighted and averaged in float32, and cast back
        once at the end. A corner outside its level contributes 0 (masked,
        not clamped, as mmcv); RoIs with ``w <= 1e-3`` or ``h <= 1e-3`` give
        exact zeros.
    """
    b, c = feats[0].shape[0], feats[0].shape[-1]
    out_h, out_w = out_size
    s = sampling_ratio
    dev = rois.device
    rois = rois.float()

    flat = torch.cat([f.reshape(b, -1, c) for f in feats], 1)
    sizes = [f.shape[1] * f.shape[2] for f in feats]
    offsets = torch.tensor([sum(sizes[:i]) for i in range(len(feats))],
                           device=dev)
    widths = torch.tensor([f.shape[2] for f in feats], device=dev)
    heights = torch.tensor([f.shape[1] for f in feats], device=dev)
    scales = torch.tensor([float(sc) for sc in spatial_scales],
                          dtype=torch.float32, device=dev)

    lvl = level_of_rois(rois, len(feats), finest_scale)        # (B, R)
    roi_scale = scales[lvl][..., None]                         # (B, R, 1)
    roi_off = offsets[lvl][..., None]
    W = widths[lvl][..., None]
    H = heights[lvl][..., None]

    # sample grid in RoI-local coordinates: (k + 0.5) / (bins * s) - 0.5
    gy = (torch.arange(out_h * s, dtype=torch.float32, device=dev) + 0.5) \
        / (out_h * s) - 0.5
    gx = (torch.arange(out_w * s, dtype=torch.float32, device=dev) + 0.5) \
        / (out_w * s) - 0.5
    gyy, gxx = torch.meshgrid(gy, gx, indexing='ij')           # (oh*s, ow*s)
    gxx, gyy = gxx.reshape(-1), gyy.reshape(-1)                # (P,)
    P = gxx.shape[0]

    cx, cy, w, h, a = (rois[..., i, None] for i in range(5))   # (B, R, 1)
    if clockwise:
        a = -a
    cos_a, sin_a = torch.cos(a), torch.sin(a)
    lx = gxx * w                                               # (B, R, P)
    ly = gyy * h
    px = cx + lx * cos_a - ly * sin_a
    py = cy + lx * sin_a + ly * cos_a
    # feature coordinates of the RoI's level (aligned: -0.5)
    fx = px * roi_scale - 0.5
    fy = py * roi_scale - 0.5

    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    wx1, wy1 = fx - x0, fy - y0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    x0i, y0i = x0.long(), y0.long()
    r = rois.shape[1]

    def corner(xi, yi, wgt):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = roi_off + torch.minimum(yi.clamp(min=0), H - 1) * W + \
            torch.minimum(xi.clamp(min=0), W - 1)              # (B, R, P)
        vals = flat.gather(1, idx.reshape(b, r * P, 1).expand(-1, -1, c))
        return vals.reshape(b, r, P, c).float() * (wgt * inb)[..., None]

    out = corner(x0i, y0i, wx0 * wy0)
    out = out + corner(x0i + 1, y0i, wx1 * wy0)
    out = out + corner(x0i, y0i + 1, wx0 * wy1)
    out = out + corner(x0i + 1, y0i + 1, wx1 * wy1)            # (B, R, P, C)

    out = out.reshape(b, r, out_h, s, out_w, s, c).mean(dim=(3, 5))
    valid = (rois[..., 2] > 1e-3) & (rois[..., 3] > 1e-3)
    out = out * valid[..., None, None, None]
    return out.to(feats[0].dtype)
