"""Shared building blocks (counterpart of
``orientedobjectdetection_tpu/models/blocks.py``), and the flax defaults
that the transformer and ConvNeXt backbones take from the JAX package:
LayerNorm with epsilon 1e-6, computed in float32; the tanh approximation of
GELU; and ``'SAME'`` padding of a strided convolution."""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn


class ConvModule(nn.Module):
    """mmcv's ConvModule without a norm: holds ``conv`` (so checkpoints
    name it ``<parent>.conv.weight``), optionally followed by ReLU."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int = 0, relu: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride=stride, padding=padding)
        self.relu = relu

    def forward(self, x):
        x = self.conv(x)
        return F.relu(x) if self.relu else x


class LayerNorm(nn.LayerNorm):
    """flax's ``nn.LayerNorm`` over the last axis: epsilon 1e-6 (torch's
    default is 1e-5), statistics and affine in float32, the result in the
    input's dtype."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-6)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


class LayerNorm2d(LayerNorm):
    """:class:`LayerNorm` over the channels of an NCHW map (mmcls's
    ``LayerNorm2d``); returns NCHW in the input's memory format."""

    def forward(self, x):
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def gelu(x):
    """flax's ``nn.gelu``: the tanh approximation (0.841192 at 1, where
    the exact GELU gives 0.841345)."""
    return F.gelu(x, approximate='tanh')


def same_padding(size: int, kernel: int, stride: int) -> tuple:
    """XLA's ``'SAME'`` padding of one axis: ``ceil(size / stride)``
    outputs, the extra row split with the larger half after."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """A convolution with flax's default ``'SAME'`` padding: a 4x4 stride-4
    patch embedding or a 2x2 stride-2 downsample of a side that the stride
    does not divide pads it with zeros (before the conv, as XLA does)."""

    def forward(self, x):
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        top, bottom = same_padding(x.shape[-2], kh, sh)
        left, right = same_padding(x.shape[-1], kw, sw)
        if top or bottom or left or right:
            x = F.pad(x, (left, right, top, bottom))
        return super().forward(x)
