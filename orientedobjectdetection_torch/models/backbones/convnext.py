"""ConvNeXt backbone (counterpart of
``orientedobjectdetection_tpu/models/backbones/convnext.py``; the reference
takes mmcls's ConvNeXt through the registry alias).

Module and parameter names are mmcls's: ``downsample_layers.0`` is the stem
(a 4x4 stride-4 conv, then LayerNorm), ``downsample_layers.{i}`` the
downsample before stage i (LayerNorm, then a 2x2 stride-2 conv),
``stages.{i}.{j}`` the blocks (``depthwise_conv``, ``norm``,
``pointwise_conv1``, ``pointwise_conv2``, ``gamma``) and ``norm{i}`` the
out-norms. A block runs a 7x7 depthwise conv, LayerNorm, Linear 4C, GELU,
Linear C, the layer scale and the residual. The maps are kept in the
channels-last memory format, so that each block's turn from the depthwise
conv (NCHW) to the pointwise layers (over the last axis) is a view, not a
copy.

The flax defaults hold (``models/blocks.py``): LayerNorm epsilon 1e-6, the
tanh GELU, and ``'SAME'`` padding of the stem and the downsamples.
``drop_path_rate`` and ``gap_before_final_norm`` are read and not used, as
in the JAX package: stochastic depth is the identity at inference, and the
JAX package trains without it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ...utils.registry import BACKBONES
from ..blocks import LayerNorm, LayerNorm2d, SameConv2d, gelu

ARCHS = {
    'tiny': dict(depths=(3, 3, 9, 3), dims=(96, 192, 384, 768)),
    'small': dict(depths=(3, 3, 27, 3), dims=(96, 192, 384, 768)),
    'base': dict(depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024)),
    'large': dict(depths=(3, 3, 27, 3), dims=(192, 384, 768, 1536)),
}


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, layer_scale_init: float = 1e-6):
        super().__init__()
        self.depthwise_conv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = LayerNorm(dim)
        self.pointwise_conv1 = nn.Linear(dim, 4 * dim)
        self.pointwise_conv2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init))

    def forward(self, x):
        y = self.depthwise_conv(x).permute(0, 2, 3, 1)
        y = self.pointwise_conv2(gelu(self.pointwise_conv1(self.norm(y))))
        return x + (y * self.gamma.to(y.dtype)).permute(0, 3, 1, 2)


@BACKBONES.register_module()
class ConvNeXt(nn.Module):
    """Input NCHW; returns the ``out_indices`` stages' normed outputs, NCHW
    (contiguous). ``frozen_stages`` and ``init_cfg`` are accepted for the
    reference configs: the optimizer's stage freezing matches none of
    ConvNeXt's names, as in the JAX package."""

    def __init__(self, arch: str = 'tiny',
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 frozen_stages: int = -1, drop_path_rate: float = 0.0,
                 layer_scale_init_value: float = 1e-6,
                 gap_before_final_norm: bool = False,
                 init_cfg: Optional[dict] = None, in_channels: int = 3):
        super().__init__()
        spec = ARCHS[arch]
        depths, dims = spec['depths'], spec['dims']
        self.frozen_stages = frozen_stages
        self.out_indices = tuple(out_indices)
        self.downsample_layers = nn.ModuleList([nn.Sequential(
            SameConv2d(in_channels, dims[0], 4, 4), LayerNorm2d(dims[0]))])
        for i in range(1, len(dims)):
            self.downsample_layers.append(nn.Sequential(
                LayerNorm2d(dims[i - 1]),
                SameConv2d(dims[i - 1], dims[i], 2, 2)))
        self.stages = nn.ModuleList(
            nn.Sequential(*[ConvNeXtBlock(dim, layer_scale_init_value)
                            for _ in range(depth)])
            for depth, dim in zip(depths, dims))
        for i in self.out_indices:
            self.add_module(f'norm{i}', LayerNorm2d(dims[i]))

    def forward(self, x):
        outs = []
        for i, stage in enumerate(self.stages):
            x = self.downsample_layers[i](x).contiguous(
                memory_format=torch.channels_last)
            x = stage(x)
            if i in self.out_indices:
                outs.append(getattr(self, f'norm{i}')(x).contiguous())
        return tuple(outs)
