"""Orientation-sensitive convolution for S2ANet's ODM head (counterpart of
the part of ``orientedobjectdetection_tpu/models/utils_rotation.py`` that
S2ANet uses: ``_rotation_perms``, ``ORConv2d`` with the ring permutation,
and ``rotation_invariant_pooling``; reference ``models/utils/orconv.py``
and ``ripool.py``).

mmcv's active rotating filter is a fixed permutation of each filter's 3x3
taps, one ring step a 45-degree rotation, plus a roll of the input
orientation channels when the input carries orientations: one gather over
the weight, then one ordinary convolution. Channels are orientation-minor
on both sides: channel ``base * num_orientations + o``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# the 3x3 taps of the ring in clockwise order (indices into the flattened
# kernel); rotating a filter by 45 degrees shifts the ring by one
_RING = np.array([0, 1, 2, 5, 8, 7, 6, 3])
_CENTER = 4


def _rotation_perms(num_orientations: int = 8) -> np.ndarray:
    """(num_orientations, 9) tap permutations: ``perm[k][i]`` is the source
    tap of output tap ``i`` after a rotation by ``k`` ring steps of
    ``8 / num_orientations``."""
    if 8 % num_orientations:
        raise ValueError(f'num_orientations must divide 8, got '
                         f'{num_orientations}')
    step = 8 // num_orientations
    perms = np.empty((num_orientations, 9), np.int64)
    for k in range(num_orientations):
        perms[k, _CENTER] = _CENTER
        for i in range(8):
            perms[k, _RING[i]] = _RING[(i - k * step) % 8]
    return perms


class ORConv2d(nn.Module):
    """Each learned 3x3 filter applied in ``num_orientations`` rotated
    copies: ``out_channels * num_orientations`` output channels. With
    ``in_orientations > 1`` the input carries orientations
    (``in_channels * in_orientations`` channels) and copy ``o`` also rolls
    them by ``o * in_orientations / num_orientations``.

    3x3 filters, stride 1, padding 1, with a bias. ``weight`` keeps
    mmcv's layout ``(out_channels, in_channels, in_orientations, 3, 3)``;
    ``bias`` has ``out_channels * num_orientations`` entries. ``interp``
    and ``steerable`` (the JAX package's bilinear and steerable rotations,
    ReDet's) are ROADMAP A.9."""

    def __init__(self, in_channels: int, out_channels: int,
                 in_orientations: int = 1, num_orientations: int = 8,
                 interp: bool = False, steerable: bool = False):
        super().__init__()
        if interp or steerable:
            raise NotImplementedError('ORConv2d interp / steerable '
                                      '(ReDet) is ROADMAP A.9')
        if in_orientations > 1 and in_orientations % num_orientations:
            raise ValueError('num_orientations must divide in_orientations')
        self.num_orientations = num_orientations
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels, in_orientations, 3, 3))
        self.bias = nn.Parameter(torch.zeros(out_channels * num_orientations))
        nn.init.normal_(self.weight, 0.0, math.sqrt(
            2.0 / self.weight[0].numel()))
        # copy o, output tap p, input orientation i reads the weight's tap
        # taps[o, p] and orientation orients[o, i] (torch.roll's shift)
        perms = torch.from_numpy(_rotation_perms(num_orientations))
        shift = in_orientations // num_orientations \
            if in_orientations > 1 else 0
        i = torch.arange(in_orientations)
        orients = torch.stack([(i - o * shift) % in_orientations
                               for o in range(num_orientations)])
        self.register_buffer('taps', perms, persistent=False)
        self.register_buffer('orients', orients, persistent=False)

    def rotated_weight(self) -> torch.Tensor:
        """The ordinary convolution's weight ``(out * num_or, in * in_or,
        3, 3)``, both channel axes orientation-minor."""
        out_c, in_c, in_or = self.weight.shape[:3]
        w = self.weight.reshape(out_c, in_c, in_or, 9)
        # (out, in, num_or, in_or, 9) -> (out, num_or, in, in_or, 9)
        copies = w[:, :, self.orients[:, :, None], self.taps[:, None, :]]
        return copies.transpose(1, 2).reshape(
            out_c * self.num_orientations, in_c * in_or, 3, 3)

    def forward(self, x):
        return F.conv2d(x, self.rotated_weight(), self.bias, padding=1)


def rotation_invariant_pooling(x: torch.Tensor,
                               num_orientations: int = 8) -> torch.Tensor:
    """The maximum over each base channel's orientations (reference
    ``ripool.py:18-23``): (B, C, H, W) orientation-minor -> (B, C /
    num_orientations, H, W)."""
    b, c, h, w = x.shape
    return x.reshape(b, c // num_orientations, num_orientations, h,
                     w).amax(2)
