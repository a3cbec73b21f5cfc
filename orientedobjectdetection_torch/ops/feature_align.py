"""Feature alignment for the refine detectors (counterpart of
``orientedobjectdetection_tpu/ops/feature_align.py``): R3Det's
FeatureRefineModule re-samples each location's feature at its refined box
(reference ``models/detectors/utils.py:136-206``), and S2ANet's AlignConv
samples the 3x3 grid of each location's anchor, rotated with it, before a
dense projection (``detectors/utils.py:40-133``). Both offsets are
analytic functions of the boxes, so both reduce to bilinear sampling at
box-derived points: four gathers and a weighted sum, plain PyTorch, whose
gradient reaches the features only (the boxes are detached upstream).

Features are NCHW. A sample at ``(px, py)`` in feature-map cells reads the
four cells around it (floor corners); a corner outside the map contributes
0, and the indices are clipped before the gather, as in the JAX package.
The weighted sum is float32 whatever the features' dtype (the JAX package's
promotion of bfloat16 values by float32 weights).
"""

from __future__ import annotations

import torch


def bilinear_sample(feat: torch.Tensor, px: torch.Tensor,
                    py: torch.Tensor) -> torch.Tensor:
    """Sample ``feat`` (B, C, H, W) at fractional cell coordinates ``px``,
    ``py`` (B, N) -> float32 (B, C, N)."""
    b, c, h, w = feat.shape
    flat = feat.reshape(b, c, h * w)
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    wx1 = px - x0
    wy1 = py - y0
    out = None
    for dx, dy, wgt in ((0, 0, (1 - wx1) * (1 - wy1)),
                        (1, 0, wx1 * (1 - wy1)),
                        (0, 1, (1 - wx1) * wy1),
                        (1, 1, wx1 * wy1)):
        xi = x0 + dx
        yi = y0 + dy
        inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
        vals = flat.gather(2, idx[:, None, :].expand(b, c, -1))
        term = vals * (wgt * inb)[:, None, :]
        out = term if out is None else out + term
    return out


def rotated_feature_align(feat: torch.Tensor, rois: torch.Tensor,
                          spatial_scale: float,
                          points: int = 1) -> torch.Tensor:
    """Each location's feature re-sampled at its refined roi: the centre
    (``points=1``), or the centre and the four inner quadrant points of the
    rotated box averaged (``points=5``).

    Args:
        feat: (B, C, H, W).
        rois: (B, H*W, 5) boxes in image coordinates, one a location, in
            row-major location order.
        spatial_scale: image -> feature-map coordinates (1 / stride).
    Returns: float32 (B, C, H, W).
    """
    b, c, h, w = feat.shape
    cx, cy, bw, bh, a = rois.unbind(-1)
    cos_a, sin_a = torch.cos(a), torch.sin(a)
    if points == 1:
        offsets = [(0.0, 0.0)]
    else:
        offsets = [(0.0, 0.0), (-0.25, -0.25), (0.25, -0.25),
                   (-0.25, 0.25), (0.25, 0.25)]
    acc = 0.0
    for ox, oy in offsets:
        lx = ox * bw
        ly = oy * bh
        px = (cx + lx * cos_a - ly * sin_a) * spatial_scale
        py = (cy + lx * sin_a + ly * cos_a) * spatial_scale
        acc = acc + bilinear_sample(feat, px, py)
    return (acc / len(offsets)).reshape(b, c, h, w)


def _grid(kernel: int, device) -> tuple:
    """Tap offsets (gx, gy), each (k*k,), tap ``t = (dy + k//2) * k +
    (dx + k//2)`` (``meshgrid(idx, idx, 'ij')`` flattened)."""
    idx = torch.arange(-(kernel // 2), kernel // 2 + 1, dtype=torch.float32,
                       device=device)
    gy, gx = torch.meshgrid(idx, idx, indexing='ij')
    return gx.reshape(-1), gy.reshape(-1)


def align_conv_sample(feat: torch.Tensor, anchors: torch.Tensor,
                      stride: float, kernel: int = 3) -> torch.Tensor:
    """The ``kernel`` x ``kernel`` rotated grid of each location's anchor
    (reference AlignConv offsets, ``detectors/utils.py:41-79``): tap
    ``(dx, dy)`` at ``(cx / stride, cy / stride) + R(a) (dx w, dy h) /
    stride / k``, no half-cell shift.

    Args:
        feat: (B, C, H, W); anchors: (B, H*W, 5) in image coordinates.
    Returns: float32 taps (B, C, k*k, H, W); tap ``t`` meets the weight
    ``[:, :, t // k, t % k]`` of the aligned convolution.
    """
    b, c, h, w = feat.shape
    k = kernel
    gx, gy = _grid(k, feat.device)
    cx, cy, bw, bh, a = anchors.unbind(-1)              # (B, HW)
    cos_a, sin_a = torch.cos(a)[:, None], torch.sin(a)[:, None]
    dx = (bw / stride / k)[:, None, :] * gx[None, :, None]   # (B, kk, HW)
    dy = (bh / stride / k)[:, None, :] * gy[None, :, None]
    px = (cx / stride)[:, None, :] + dx * cos_a - dy * sin_a
    py = (cy / stride)[:, None, :] + dx * sin_a + dy * cos_a
    samples = bilinear_sample(feat, px.reshape(b, -1), py.reshape(b, -1))
    return samples.reshape(b, c, k * k, h, w)


def deform_conv_sample(feat: torch.Tensor, offsets: torch.Tensor,
                       kernel: int = 3) -> torch.Tensor:
    """Deformable-convolution sampling with learned offsets (the point-set
    heads' ``DeformConv2d``): tap ``t`` of location ``(y, x)`` at ``(x +
    dx_t + off_x, y + dy_t + off_y)``.

    Args:
        feat: (B, C, H, W).
        offsets: (B, 2*k*k, H, W) in cells, channel ``2t`` the y offset of
            tap ``t`` and ``2t + 1`` its x offset (mmcv's DCN order).
    Returns: float32 taps (B, C, k*k, H, W).
    """
    b, c, h, w = feat.shape
    k = kernel
    gx, gy = _grid(k, feat.device)
    off = offsets.reshape(b, k * k, 2, h, w)
    ys = torch.arange(h, dtype=torch.float32, device=feat.device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=feat.device)[None, :]
    py = ys[None, None] + gy[None, :, None, None] + off[:, :, 0]
    px = xs[None, None] + gx[None, :, None, None] + off[:, :, 1]
    samples = bilinear_sample(feat, px.reshape(b, -1), py.reshape(b, -1))
    return samples.reshape(b, c, k * k, h, w)
