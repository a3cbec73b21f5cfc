"""ResNet backbone with frozen BatchNorm (counterpart of
``orientedobjectdetection_tpu/models/backbones/resnet.py``).

Module and parameter names are mmdet's (``conv1``, ``bn1``,
``layer1.0.conv1``, ``layer1.0.downsample.0``...), so an mmrotate
checkpoint's ``backbone.*`` entries load unchanged. The stem is a plain
7x7/2 convolution: the JAX package's ``TiledStemConv`` computes the same
function and exists only for the TPU's matrix unit.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.registry import BACKBONES


class FrozenBatchNorm(nn.Module):
    """BatchNorm with frozen statistics: a per-channel affine computed in
    float32 and applied in the input's dtype (the reference's
    ``norm_eval=True`` BN). The statistics are buffers and never change;
    ``weight`` and ``bias`` are parameters and train outside the frozen
    stages, as the JAX package's ``scale`` / ``bias`` do.
    ``num_batches_tracked`` in a checkpoint is accepted and ignored."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer('running_mean', torch.zeros(num_features))
        self.register_buffer('running_var', torch.ones(num_features))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + 'num_batches_tracked', None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight / torch.sqrt(self.running_var + self.eps)
        bias = self.bias - self.running_mean * scale
        return (x * scale.to(x.dtype)[:, None, None]
                + bias.to(x.dtype)[:, None, None])


def _conv(cin, cout, k, stride=1, padding=0, dilation=1):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding,
                     dilation=dilation, bias=False)


class Bottleneck(nn.Module):
    """1x1 -> 3x3(stride) -> 1x1 with identity or projection shortcut
    (mmdet 'pytorch' style: the stride is on the 3x3)."""
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3, stride, dilation, dilation)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = FrozenBatchNorm(planes * 4)
        self.downsample = nn.Sequential(
            _conv(inplanes, planes * 4, 1, stride),
            FrozenBatchNorm(planes * 4)) if downsample else None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride, 1)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3, 1, 1)
        self.bn2 = FrozenBatchNorm(planes)
        self.downsample = nn.Sequential(
            _conv(inplanes, planes, 1, stride),
            FrozenBatchNorm(planes)) if downsample else None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


ARCH_SETTINGS = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (Bottleneck, (3, 4, 6, 3)),
    101: (Bottleneck, (3, 4, 23, 3)),
    152: (Bottleneck, (3, 8, 36, 3)),
}


@BACKBONES.register_module()
class ResNet(nn.Module):
    """mmdet-config-compatible ResNet with frozen BN statistics
    (``norm_eval=True``, the setting of every ResNet detection config).

    ``frozen_stages`` is kept for the optimizer
    (``parallel/train_state.py:frozen_mask`` freezes the stem and that many
    stages); ``norm_eval=False`` (live BN) is not ported and raises.
    ``norm_cfg``, ``style``, ``zero_init_residual`` and ``init_cfg`` are
    accepted for the reference configs and unused. Input NCHW; returns the
    ``out_indices`` stage outputs, NCHW."""

    def __init__(self, depth: int = 50, num_stages: int = 4,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 strides: Sequence[int] = (1, 2, 2, 2),
                 dilations: Sequence[int] = (1, 1, 1, 1),
                 frozen_stages: int = -1, norm_cfg: Optional[dict] = None,
                 norm_eval: bool = True, style: str = 'pytorch',
                 zero_init_residual: bool = False,
                 init_cfg: Optional[dict] = None, in_channels: int = 3):
        super().__init__()
        if not norm_eval:
            raise NotImplementedError('norm_eval=False (live BatchNorm) is '
                                      'not ported')
        block, stage_blocks = ARCH_SETTINGS[depth]
        self.frozen_stages = frozen_stages
        self.out_indices = tuple(out_indices)
        self.num_stages = num_stages
        self.conv1 = _conv(in_channels, 64, 7, 2, 3)
        self.bn1 = FrozenBatchNorm(64)
        inplanes, planes = 64, 64
        for i in range(num_stages):
            blocks = []
            for j in range(stage_blocks[i]):
                stride = strides[i] if j == 0 else 1
                need_ds = j == 0 and (stride != 1 or
                                      inplanes != planes * block.expansion)
                blocks.append(block(inplanes, planes, stride, dilations[i],
                                    need_ds))
                inplanes = planes * block.expansion
            self.add_module(f'layer{i + 1}', nn.Sequential(*blocks))
            planes *= 2

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        outs = []
        for i in range(self.num_stages):
            x = getattr(self, f'layer{i + 1}')(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)
