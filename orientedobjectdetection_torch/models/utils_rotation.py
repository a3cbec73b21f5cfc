"""Orientation-sensitive convolution (counterpart of
``orientedobjectdetection_tpu/models/utils_rotation.py``; reference
``models/utils/orconv.py`` and ``ripool.py``): ``_rotation_perms``,
``c8_steerable_basis``, ``rotation_interp_matrix`` (the JAX package's
``backbones/jy_modules.py`` helper), ``ORConv2d`` and
``rotation_invariant_pooling``.

mmcv's active rotating filter is a fixed permutation of each filter's 3x3
taps, one ring step a 45-degree rotation, plus a roll of the input
orientation channels when the input carries orientations: one gather over
the weight, then one ordinary convolution. Channels are orientation-minor
on both sides: channel ``base * num_orientations + o``. ReDet's
convolutions rotate the taps with the bilinear operator (``interp``) or
sample a steerable basis (``steerable``) instead; S2ANet's ODM keeps the
permutation.
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


def c8_steerable_basis(num_orientations: int = 8) -> np.ndarray:
    """The sampled steerable basis of the JAX package (e2cnn's ``R2Conv``
    scheme, reference ``models/utils/enn.py:37-161``): Gaussian rings
    ``r0 in {0, 1, sqrt(2)}`` (sigma 0.6) times ``cos / sin(k phi)`` for
    ``k <= 4`` (no ``sin(4 phi)``, which samples to 0 on the 3x3 taps),
    each function sampled on the 3x3 grid rotated by ``o * 360 /
    num_orientations`` degrees and L2-normalized at rotation 0.

    Returns (num_orientations, 9, 17) float32, taps row-major."""
    rows, cols = np.divmod(np.arange(9), 3)
    dy = rows - 1.0
    dx = cols - 1.0
    r = np.sqrt(dx * dx + dy * dy)
    phi = np.arctan2(dy, dx)
    sigma = 0.6
    specs = [(0.0, 0, False)]                  # (r0, k, use_sin)
    for r0 in (1.0, np.sqrt(2.0)):
        for k in range(0, 5):
            specs.append((r0, k, False))
            if 1 <= k <= 3:
                specs.append((r0, k, True))
    step = 2 * np.pi / num_orientations
    basis = np.zeros((num_orientations, 9, len(specs)), np.float32)
    norms = np.ones(len(specs), np.float32)
    for b, (r0, k, use_sin) in enumerate(specs):
        radial = np.exp(-(r - r0) ** 2 / (2 * sigma * sigma))
        if k > 0:
            # an angular profile is continuous at the origin only if it
            # vanishes there
            radial = radial * (r > 1e-6)
        for o in range(num_orientations):
            ang = k * (phi - o * step)
            angular = np.sin(ang) if use_sin else np.cos(ang)
            basis[o, :, b] = radial * angular
        norms[b] = max(np.linalg.norm(basis[0, :, b]), 1e-6)
    basis /= norms[None, None, :]
    return basis


def rotation_interp_matrix(thetas: torch.Tensor) -> torch.Tensor:
    """(...,) float32 angles -> (..., 9, 9) operators that rotate a 3x3
    kernel by theta with bilinear interpolation on the tap grid (JAX
    ``backbones/jy_modules.py:rotation_interp_matrix``): output tap ``p``
    reads ``R(-theta) v_p`` of the original kernel, mass outside the grid
    dropped; ``M[..., p, q]`` is source tap ``q``'s weight."""
    offs = torch.tensor([(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)],
                        dtype=torch.float32, device=thetas.device)
    cos_t = torch.cos(thetas)[..., None]
    sin_t = torch.sin(thetas)[..., None]
    sy = offs[:, 0] * cos_t - offs[:, 1] * sin_t            # (..., 9)
    sx = offs[:, 0] * sin_t + offs[:, 1] * cos_t
    w = [(1 - (sy - qy).abs()).clamp(min=0) *
         (1 - (sx - qx).abs()).clamp(min=0) for qy, qx in offs.tolist()]
    return torch.stack(w, -1)


class ORConv2d(nn.Module):
    """Each learned filter applied in ``num_orientations`` rotated copies:
    ``out_channels * num_orientations`` output channels. With
    ``in_orientations > 1`` the input carries orientations
    (``in_channels * in_orientations`` channels) and copy ``o`` also rolls
    them by ``o * in_orientations / num_orientations``.

    ``kernel_size`` 3 (padding 1) or 1 (no tap to rotate: ReDet's 1x1
    group convolutions), ``stride`` inside the convolution. ``weight``
    keeps mmcv's layout ``(out_channels, in_channels, in_orientations, k,
    k)``; ``bias`` (``use_bias``) has ``out_channels * num_orientations``
    entries. The copies' taps: the ring permutation by default;
    ``interp``, the bilinear rotation operator
    (:func:`rotation_interp_matrix`); ``steerable``, samples of the rotated
    basis (:func:`c8_steerable_basis`) whose coefficients ``coeff``
    ``(out_channels, in_channels, in_orientations, 17)`` are then the free
    parameter in place of ``weight``. The rotated weight is rebuilt from
    the free parameter on every call, so training updates it."""

    def __init__(self, in_channels: int, out_channels: int,
                 in_orientations: int = 1, num_orientations: int = 8,
                 interp: bool = False, steerable: bool = False,
                 kernel_size: int = 3, stride: int = 1,
                 use_bias: bool = True):
        super().__init__()
        if in_orientations > 1 and in_orientations % num_orientations:
            raise ValueError('num_orientations must divide in_orientations')
        if kernel_size not in (1, 3):
            raise ValueError(f'kernel_size must be 1 or 3, got {kernel_size}')
        if kernel_size == 1 and (interp or steerable):
            raise ValueError('a 1x1 filter has no taps to rotate')
        self.num_orientations = num_orientations
        self.kernel_size = kernel_size
        self.stride = stride
        self.steerable = steerable
        taps = kernel_size * kernel_size
        if steerable:
            ops = torch.from_numpy(c8_steerable_basis(num_orientations))
            self.coeff = nn.Parameter(torch.empty(
                out_channels, in_channels, in_orientations, ops.shape[-1]))
            free = self.coeff
        else:
            self.weight = nn.Parameter(torch.empty(
                out_channels, in_channels, in_orientations, kernel_size,
                kernel_size))
            free = self.weight
            angles = torch.arange(num_orientations) * (
                (8 // num_orientations) * math.pi / 4)
            ops = rotation_interp_matrix(angles.float()) if interp else None
        self.bias = nn.Parameter(torch.zeros(
            out_channels * num_orientations)) if use_bias else None
        nn.init.normal_(free, 0.0, math.sqrt(
            2.0 / (in_channels * in_orientations * taps)))
        # copy o, output tap p, input orientation i reads the weight's tap
        # taps[o, p] and orientation orients[o, i] (torch.roll's shift);
        # tap_ops[o] maps the free taps (or coefficients) to copy o's taps
        perms = torch.from_numpy(_rotation_perms(num_orientations)) \
            if kernel_size == 3 else torch.zeros(num_orientations, 1,
                                                  dtype=torch.int64)
        shift = in_orientations // num_orientations \
            if in_orientations > 1 else 0
        i = torch.arange(in_orientations)
        orients = torch.stack([(i - o * shift) % in_orientations
                               for o in range(num_orientations)])
        self.register_buffer('taps', perms, persistent=False)
        self.register_buffer('orients', orients, persistent=False)
        self.register_buffer('tap_ops', ops, persistent=False)

    def rotated_weight(self) -> torch.Tensor:
        """The ordinary convolution's weight ``(out * num_or, in * in_or, k,
        k)``, both channel axes orientation-minor."""
        k = self.kernel_size
        free = self.coeff if self.steerable else self.weight
        out_c, in_c, in_or = free.shape[:3]
        if self.tap_ops is None:
            w = free.reshape(out_c, in_c, in_or, k * k)
            # (out, in, num_or, in_or, k*k) -> (out, num_or, in, in_or, k*k)
            copies = w[:, :, self.orients[:, :, None], self.taps[:, None, :]]
            copies = copies.transpose(1, 2)
        else:
            # (num_or, out, in, in_or, 9): copy o's taps, then its roll
            tapped = torch.einsum('opq,nijq->onijp',
                                  self.tap_ops.to(free.dtype),
                                  free.reshape(out_c, in_c, in_or, -1))
            index = self.orients[:, None, None, :, None].expand(
                tapped.shape)
            copies = tapped.gather(3, index).transpose(0, 1)
        return copies.reshape(out_c * self.num_orientations, in_c * in_or,
                              k, k)

    def forward(self, x):
        return F.conv2d(x, self.rotated_weight(), self.bias, self.stride,
                        self.kernel_size // 2)


def rotation_invariant_pooling(x: torch.Tensor,
                               num_orientations: int = 8) -> torch.Tensor:
    """The maximum over each base channel's orientations (reference
    ``ripool.py:18-23``): (B, C, H, W) orientation-minor -> (B, C /
    num_orientations, H, W)."""
    b, c, h, w = x.shape
    return x.reshape(b, c // num_orientations, num_orientations, h,
                     w).amax(2)
