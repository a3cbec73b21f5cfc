"""Rotation-equivariant ResNet and FPN of ReDet (counterpart of
``orientedobjectdetection_tpu/models/backbones/re_resnet.py``; reference
``backbones/re_resnet.py`` and ``necks/re_fpn.py``, which build on e2cnn).

A C8-regular feature carries 8 orientation channels per base channel,
orientation-minor (channel ``base * 8 + o``). A group convolution applies 8
rotated copies of one learned filter, each copy also rolling the input's
orientation channels (:class:`ORConv2d`): 3x3 copies rotate their taps by
the ring permutation (or sample the steerable basis with ``conv_basis=
'steerable'``), 1x1 copies only roll. The copies are rebuilt from the tied
parameter on every call, so a train step updates the tied parameter.

Module names are mmrotate's (``conv1``, ``bn1``, ``layer{s}.{j}.conv{1,2,3}``
/ ``bn{1,2,3}`` / ``downsample.{0,1}``; ``lateral_convs.{i}.conv``,
``fpn_convs.{i}.conv``); the tensors are the JAX package's tied ones
(base taps or steerable coefficients), not e2cnn's expanded ``.filter``.
BatchNorm is frozen, per channel (base x 8), as the JAX package's is.

Depth 18 is not a BasicBlock ResNet: the JAX package builds it as one
bottleneck per stage with the depth-50 channels (the tiny-synth config).
The stem is a lifting 3x3 stride-2 ORConv (1 input orientation, 8 base
channels), BN, ReLU and a 3x3 stride-2 max pool.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.registry import BACKBONES, NECKS
from ..utils_rotation import ORConv2d
from .resnet import FrozenBatchNorm

NUM_ORIENTATIONS = 8


class ReConv(ORConv2d):
    """A C8 group convolution over regular features: ``in_base x 8``
    channels in, ``out_base x 8`` out, 1x1 or 3x3 (padding 1), the stride
    inside the convolution. ``bias`` (``use_bias``) is one per field,
    repeated over its 8 orientations (e2cnn's equivariant bias; the
    reference ReFPN's convolutions carry it)."""

    def __init__(self, in_base: int, out_base: int, kernel_size: int = 1,
                 stride: int = 1, use_bias: bool = False,
                 steerable: bool = False):
        super().__init__(in_base, out_base, NUM_ORIENTATIONS,
                         NUM_ORIENTATIONS, kernel_size=kernel_size,
                         stride=stride, use_bias=False, steerable=steerable)
        self.bias = nn.Parameter(torch.zeros(out_base)) if use_bias \
            else None

    def forward(self, x):
        bias = None if self.bias is None else \
            self.bias.repeat_interleave(self.num_orientations)
        return F.conv2d(x, self.rotated_weight(), bias, self.stride,
                        self.kernel_size // 2)


class ReBottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 group convolutions with frozen BN, and a
    1x1 group-convolution projection where the shape changes."""

    def __init__(self, in_base: int, base: int, stride: int = 1,
                 downsample: bool = False, steerable: bool = False):
        super().__init__()
        n = NUM_ORIENTATIONS
        self.conv1 = ReConv(in_base, base, 1)
        self.bn1 = FrozenBatchNorm(base * n)
        self.conv2 = ReConv(base, base, 3, stride, steerable=steerable)
        self.bn2 = FrozenBatchNorm(base * n)
        self.conv3 = ReConv(base, base * 4, 1)
        self.bn3 = FrozenBatchNorm(base * 4 * n)
        self.downsample = nn.Sequential(
            ReConv(in_base, base * 4, 1, stride),
            FrozenBatchNorm(base * 4 * n)) if downsample else None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


@BACKBONES.register_module()
class ReResNet(nn.Module):
    """C8-equivariant ResNet: input NCHW images, outputs the
    ``out_indices`` stages (256, 512, 1024, 2048 channels: 32 ... 256 base
    fields x 8), NCHW.

    ``frozen_stages`` is kept for the optimizer; as in the JAX package it
    freezes the stages ``layer1 .. layer{frozen_stages}`` and not the stem
    (``freeze_stem``): the JAX names of the stem (``stem_lift``,
    ``stem_bn``) are not among the names its optimizer freezes, where the
    reference mmrotate freezes the stem too. ``norm_cfg``, ``style``,
    ``zero_init_residual`` and ``init_cfg`` are accepted and unused;
    ``norm_eval`` is accepted and not read (the train step sets the BN
    mode, as for ``ResNet``)."""
    freeze_stem = False

    def __init__(self, depth: int = 50, num_stages: int = 4,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 strides: Sequence[int] = (1, 2, 2, 2),
                 frozen_stages: int = -1, norm_cfg: Optional[dict] = None,
                 norm_eval: bool = True, style: str = 'pytorch',
                 zero_init_residual: bool = False,
                 conv_basis: str = 'permutation',
                 init_cfg: Optional[dict] = None, in_channels: int = 3):
        super().__init__()
        if conv_basis not in ('permutation', 'steerable'):
            raise ValueError(f'conv_basis={conv_basis!r}')
        steerable = conv_basis == 'steerable'
        stage_blocks = {18: (1, 1, 1, 1), 50: (3, 4, 6, 3),
                        101: (3, 4, 23, 3)}[depth]
        self.frozen_stages = frozen_stages
        self.out_indices = tuple(out_indices)
        self.num_stages = num_stages
        self.conv1 = ORConv2d(in_channels, 8, 1, NUM_ORIENTATIONS,
                              steerable=steerable, stride=2, use_bias=False)
        self.bn1 = FrozenBatchNorm(8 * NUM_ORIENTATIONS)
        in_base, base = 8, 8
        for i in range(num_stages):
            blocks = []
            for j in range(stage_blocks[i]):
                stride = strides[i] if j == 0 else 1
                need_ds = j == 0 and (stride != 1 or in_base != base * 4)
                blocks.append(ReBottleneck(in_base, base, stride, need_ds,
                                           steerable))
                in_base = base * 4
            self.add_module(f'layer{i + 1}', nn.Sequential(*blocks))
            base *= 2

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        outs = []
        for i in range(self.num_stages):
            x = getattr(self, f'layer{i + 1}')(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)


class _Conv(nn.Module):
    """Holds ``conv`` so that the names are mmrotate's
    ``lateral_convs.{i}.conv``."""

    def __init__(self, conv: nn.Module):
        super().__init__()
        self.conv = conv

    def forward(self, x):
        return self.conv(x)


@NECKS.register_module()
class ReFPN(nn.Module):
    """Equivariant FPN (reference ``necks/re_fpn.py``): 1x1 group-conv
    laterals, the nearest top-down path, 3x3 group-conv outputs, all
    C8-regular with a per-field bias; the extra levels are every second
    row and column of the level before (``add_extra_convs`` is read and
    only False is built, as in the JAX package)."""

    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 5,
                 start_level: int = 0, add_extra_convs=False,
                 conv_basis: str = 'permutation',
                 init_cfg: Optional[dict] = None):
        super().__init__()
        n = NUM_ORIENTATIONS
        self.start_level = start_level
        self.num_outs = num_outs
        used = list(in_channels)[start_level:]
        out_base = out_channels // n
        self.lateral_convs = nn.ModuleList(
            _Conv(ReConv(c // n, out_base, 1, use_bias=True)) for c in used)
        self.fpn_convs = nn.ModuleList(
            _Conv(ReConv(out_base, out_base, 3, use_bias=True,
                         steerable=conv_basis == 'steerable'))
            for _ in used)

    def forward(self, inputs):
        from ..necks.fpn import upsample_nearest
        used = list(inputs[self.start_level:])
        laterals = [conv(x) for conv, x in zip(self.lateral_convs, used)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + upsample_nearest(
                laterals[i], laterals[i - 1].shape[-2:])
        outs = [conv(lat) for conv, lat in zip(self.fpn_convs, laterals)]
        while len(outs) < self.num_outs:
            outs.append(outs[-1][:, :, ::2, ::2])
        return tuple(outs)


def orientation_shift(theta: torch.Tensor,
                      num_orientations: int = NUM_ORIENTATIONS):
    """The RoI's orientation bin: ``round(theta / (2 pi / n)) % n``, a
    float32 division, rounding half to even and the remainder's sign that
    of the divisor, as the JAX package's ``jnp.round`` and ``%``."""
    step = 2 * math.pi / num_orientations
    return torch.remainder(torch.round(theta.float() / step).long(),
                           num_orientations)


def ri_roll(pooled: torch.Tensor, rois: torch.Tensor,
            num_orientations: int = NUM_ORIENTATIONS) -> torch.Tensor:
    """The rotation-invariant alignment of pooled RoI features (JAX
    ``ri_roi_align_rotated`` after its RoIAlign): pooled (B, R, h, w, C)
    orientation-minor, rois (B, R, 5) -> each RoI's orientation channels
    rolled by its bin, ``out[..., b, o] = in[..., b, (o - shift) % n]``
    (a gather over channels, plain PyTorch)."""
    b, r, h, w, c = pooled.shape
    shift = orientation_shift(rois[..., 4], num_orientations)  # (B, R)
    index = torch.remainder(
        torch.arange(num_orientations, device=pooled.device) -
        shift[..., None], num_orientations)                    # (B, R, n)
    ori = pooled.reshape(b, r, h, w, c // num_orientations,
                         num_orientations)
    index = index[:, :, None, None, None, :].expand(ori.shape)
    return ori.gather(-1, index).reshape(b, r, h, w, c)
