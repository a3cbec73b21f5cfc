"""jy research modules (counterpart of
``orientedobjectdetection_tpu/models/backbones/jy_modules.py``; reference
``backbones/modules/``):

- :func:`rotation_interp_matrix`: the 9 x 9 operator that rotates a 3x3
  kernel by theta, by bilinear interpolation on the unit tap grid;
- :class:`RountingFunction` (the reference's spelling): per-sample
  (alpha, theta) of ``kernel_number`` kernel experts;
- :class:`AdaptiveRotatedConv2d`: the experts rotated by theta and mixed by
  alpha per sample (``einsum('bk,bkpq,qkio->bpio')``), then one grouped
  convolution with ``groups=B`` over the batch folded into channels;
- :class:`MSARCModule`: ARC branches (each the same undilated ARC, as in
  the JAX package) averaged, then channel and spatial attention;
- :class:`RotationallyDeformableConvolution` and
  :class:`DAttentionBaseline`, over :func:`..ops.feature_align.
  bilinear_sample`.

Maps are NCHW; the dense projections take channels-last rows as the JAX
package's do, and module and parameter names are the JAX package's
(``routing.fc1``, ``arc_d1.kernel``, ``ch_fc``, ``sp_conv``...).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from ...ops.feature_align import bilinear_sample
from ..blocks import gelu

_TAPS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


def rotation_interp_matrix(thetas: torch.Tensor) -> torch.Tensor:
    """(...,) thetas -> (..., 9, 9): entry ``[p, q]`` is the weight of tap
    ``q`` of the original 3x3 kernel in tap ``p`` of the kernel rotated by
    theta. Tap ``p`` (offset ``(dy, dx)``) reads at ``R(-theta) (dy, dx)``,
    bilinearly over the grid; mass outside the grid is dropped."""
    offs = torch.tensor(_TAPS, dtype=torch.float32, device=thetas.device)
    cos_t = torch.cos(thetas)[..., None]
    sin_t = torch.sin(thetas)[..., None]
    sy = offs[:, 0] * cos_t - offs[:, 1] * sin_t          # (..., 9)
    sx = offs[:, 0] * sin_t + offs[:, 1] * cos_t
    w = []
    for qy, qx in _TAPS:
        wy = (1 - (sy - qy).abs()).clamp(min=0)
        wx = (1 - (sx - qx).abs()).clamp(min=0)
        w.append(wy * wx)
    return torch.stack(w, -1)


class RountingFunction(nn.Module):
    """Global average pool -> ``fc1`` (ReLU) -> ``fc_alpha`` (sigmoid) and
    ``fc_theta``: per-sample (alphas, thetas), each (B, kernel_number)."""

    def __init__(self, cin: int, kernel_number: int = 4):
        super().__init__()
        hidden = max(cin // 4, 16)
        self.fc1 = nn.Linear(cin, hidden)
        self.fc_alpha = nn.Linear(hidden, kernel_number)
        self.fc_theta = nn.Linear(hidden, kernel_number)

    def forward(self, x):
        h = F.relu(self.fc1(x.mean((2, 3))))
        return torch.sigmoid(self.fc_alpha(h)), self.fc_theta(h)


class AdaptiveRotatedConv2d(nn.Module):
    """``kernel_number`` 3x3 experts ``kernel`` (n, 9, cin, cout), float32,
    He-normal; per sample ``W_b = sum_k alpha_bk rot(theta_bk) W_k`` in
    float32 (outside autocast), then a padded 3x3 convolution of each sample with its own
    kernel in the input's dtype: one grouped convolution, ``groups=B``."""

    def __init__(self, cin: int, cout: int, kernel_number: int = 4,
                 stride: int = 1):
        super().__init__()
        self.stride = stride
        self.kernel = nn.Parameter(torch.empty(kernel_number, 9, cin, cout))
        self.routing = RountingFunction(cin, kernel_number)
        self.init_seeded(torch.default_generator)

    @torch.no_grad()
    def init_seeded(self, gen: torch.Generator) -> None:
        """He-normal experts from ``gen``, flax's ``he_normal`` scale: the
        fan-in is every axis but the output's, ``n * 9 * cin``."""
        self.kernel.copy_(torch.randn(self.kernel.shape, generator=gen)
                          * math.sqrt(2.0 / self.kernel[..., 0].numel()))

    def forward(self, x):
        b, cin, h, w = x.shape
        alphas, thetas = self.routing(x)
        with torch.autocast(x.device.type, enabled=False):
            rot = rotation_interp_matrix(thetas.float())    # (B, n, 9, 9)
            mixed = torch.einsum('bk,bkpq,qkio->bpio', alphas.float(), rot,
                                 self.kernel.float().permute(1, 0, 2, 3))
        cout = mixed.shape[-1]
        weight = mixed.reshape(b, 3, 3, cin, cout).permute(0, 4, 3, 1, 2)
        out = F.conv2d(x.reshape(1, b * cin, h, w),
                       weight.reshape(b * cout, cin, 3, 3).to(x.dtype),
                       stride=self.stride, padding=1, groups=b)
        return out.reshape(b, cout, out.shape[-2], out.shape[-1])


class RotationallyDeformableConvolution(nn.Module):
    """Per location a radial scale ``softplus(pred_0)`` and an angle
    ``pred_1`` from a 3x3 ``offset_pred``; the ``k x k`` taps scaled and
    rotated by them are sampled bilinearly and projected by ``proj`` (a
    dense layer over the taps, tap-major)."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3):
        super().__init__()
        self.kernel_size = kernel_size
        self.offset_pred = nn.Conv2d(cin, 2, 3, padding=1)
        self.proj = nn.Linear(kernel_size * kernel_size * cin, cout)

    def forward(self, x):
        b, c, h, w = x.shape
        k = self.kernel_size
        pred = self.offset_pred(x).permute(0, 2, 3, 1)      # (B, H, W, 2)
        dist = F.softplus(pred[..., 0:1])
        ang = pred[..., 1:2]
        base = torch.arange(-(k // 2), k // 2 + 1, dtype=torch.float32,
                            device=x.device)
        gy, gx = torch.meshgrid(base, base, indexing='ij')
        gy, gx = gy.reshape(-1), gx.reshape(-1)
        cos_a, sin_a = torch.cos(ang), torch.sin(ang)
        ry = dist * (gy * cos_a - gx * sin_a)                # (B, H, W, kk)
        rx = dist * (gy * sin_a + gx * cos_a)
        ys = torch.arange(h, dtype=torch.float32,
                          device=x.device)[None, :, None, None]
        xs = torch.arange(w, dtype=torch.float32,
                          device=x.device)[None, None, :, None]
        taps = bilinear_sample(x, (xs + rx).reshape(b, -1),
                               (ys + ry).reshape(b, -1))     # (B, C, N)
        taps = taps.transpose(1, 2).reshape(b, h, w, k * k * c)
        return self.proj(taps.to(x.dtype)).permute(0, 3, 1, 2)


class MSARCModule(nn.Module):
    """Multi-scale adaptive-rotated-conv attention: one ARC branch per
    entry of ``dilations`` (each undilated, as in the JAX package: the
    names ``arc_d{d}`` keep the dilations), their mean, a channel gate
    (sigmoid of a 1x1 conv of the pooled map) and a spatial gate (sigmoid of
    a 7x7 conv of the channel mean and max), in a ``yolov8.msarc``
    profiler range."""

    def __init__(self, cin: int, cout: int,
                 dilations: Sequence[int] = (1, 2, 3),
                 kernel_number: int = 4, chattn: bool = True,
                 spattn: bool = True):
        super().__init__()
        self.dilations = tuple(dilations)
        for d in self.dilations:
            self.add_module(f'arc_d{d}', AdaptiveRotatedConv2d(
                cin, cout, kernel_number))
        self.ch_fc = nn.Conv2d(cout, cout, 1) if chattn else None
        self.sp_conv = nn.Conv2d(2, 1, 7, padding=3) if spattn else None

    def forward(self, x):
        with record_function('yolov8.msarc'):
            out = None
            for d in self.dilations:
                br = getattr(self, f'arc_d{d}')(x)
                out = br if out is None else out + br
            out = out / len(self.dilations)
            if self.ch_fc is not None:
                out = out * torch.sigmoid(self.ch_fc(out.mean(
                    (2, 3), keepdim=True)))
            if self.sp_conv is not None:
                s = torch.cat([out.mean(1, keepdim=True),
                               out.amax(1, keepdim=True)], 1)
                out = out * torch.sigmoid(self.sp_conv(s))
            return out


class DAttentionBaseline(nn.Module):
    """Deformable attention (DAT): queries ``proj_q``; a reference grid at
    ``stride``, shifted by ``tanh(offset_conv(gelu(avg_pool(q)))) *
    offset_range_factor * stride``; the input sampled there, projected to
    keys and values; ``num_heads``-head attention; ``proj_out`` back to the
    input's width."""

    def __init__(self, cin: int, dim: int = 256, num_heads: int = 8,
                 n_groups: int = 4, stride: int = 8,
                 offset_range_factor: float = 2.0):
        super().__init__()
        self.dim, self.num_heads, self.stride = dim, num_heads, stride
        self.offset_range_factor = offset_range_factor
        self.proj_q = nn.Linear(cin, dim)
        self.offset_conv = nn.Conv2d(dim, 2, 3, padding=1)
        self.proj_k = nn.Linear(cin, dim)
        self.proj_v = nn.Linear(cin, dim)
        self.proj_out = nn.Linear(dim, cin)

    def forward(self, x):
        b, c, h, w = x.shape
        s = self.stride
        q = self.proj_q(x.permute(0, 2, 3, 1))              # (B, H, W, dim)
        rh, rw = h // s, w // s
        ref_y = (torch.arange(rh, device=x.device) + 0.5) * s
        ref_x = (torch.arange(rw, device=x.device) + 0.5) * s
        ry, rx = torch.meshgrid(ref_y, ref_x, indexing='ij')
        qp = F.avg_pool2d(q.permute(0, 3, 1, 2), s, s)
        off = self.offset_conv(gelu(qp)).permute(0, 2, 3, 1)
        off = torch.tanh(off) * self.offset_range_factor * s
        py = (ry[None] + off[..., 0]).reshape(b, -1)
        px = (rx[None] + off[..., 1]).reshape(b, -1)
        sampled = bilinear_sample(x, px, py).transpose(1, 2).to(x.dtype)
        k = self.proj_k(sampled)
        v = self.proj_v(sampled)
        d = self.dim // self.num_heads
        qf = q.reshape(b, h * w, self.num_heads, d)
        kf = k.reshape(b, -1, self.num_heads, d)
        vf = v.reshape(b, -1, self.num_heads, d)
        attn = torch.einsum('bqhd,bkhd->bhqk', qf, kf) / math.sqrt(d)
        attn = attn.softmax(-1)
        out = torch.einsum('bhqk,bkhd->bqhd', attn, vf).reshape(
            b, h, w, self.dim)
        return self.proj_out(out).permute(0, 3, 1, 2)
