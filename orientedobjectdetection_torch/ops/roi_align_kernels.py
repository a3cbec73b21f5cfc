"""The port's CUDA kernel for RoIAlignRotated over an FPN pyramid, beside
its plain PyTorch version (counterpart of
``orientedobjectdetection_tpu/ops/roi_align_pallas.py``).

:func:`roi_align_rotated_pyramid` (``csrc/roi_align_rotated.cu``, for
``roi_align_rotated_pallas``) takes channels-last pyramid levels
``(B, H_l, W_l, C)`` and RoIs ``(B, R, 5)`` and returns the pooled
``(B, R, 7, 7, C)`` features in the features' dtype, without a gradient.
The kernel reads the cells it needs directly, so every RoI geometry takes
the same path: there is no window and no fallback for large RoIs.

The kernel has two paths with the same arithmetic (:func:`vector_path`
says which a call takes): lanes that own 16 bytes of channels when ``C`` is
a multiple of 8 (bfloat16) or 4 (float32) and every level is 16-byte
aligned, one channel per lane otherwise.

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel,
one launch for the whole batch, or raises. Neither has a gradient: both
raise for features that require one while autograd is recording, and the
differentiable formulation is :func:`.roi_align_rotated.roi_align_rotated`.
The wrapper counts its launches in ``roi_align_rotated_pyramid.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from .roi_align_rotated import level_of_rois, roi_align_rotated

KERNEL = 'roi_align_rotated'
MAX_LEVELS = 4
# the plain version pools at most this many RoIs of an image at once, so
# its (B, block, 196, C) float32 intermediates stay bounded
PLAIN_ROI_BLOCK = 128


def _check(feats, rois, out_size, spatial_scales, sampling_ratio):
    if tuple(out_size) != (7, 7) or sampling_ratio not in (1, 2):
        raise ValueError(f'the kernel is specialized to 7x7 bins with '
                         f'sampling_ratio 1 or 2, got '
                         f'out_size={tuple(out_size)} '
                         f'sampling_ratio={sampling_ratio}')
    if not 1 <= len(feats) <= MAX_LEVELS or \
            len(feats) != len(spatial_scales):
        raise ValueError(f'{len(feats)} levels and {len(spatial_scales)} '
                         f'spatial scales; need equal counts of 1 to '
                         f'{MAX_LEVELS}')
    if rois.dim() != 3 or rois.shape[-1] != 5:
        raise ValueError(f'rois must be (B, R, 5), got {tuple(rois.shape)}')
    if rois.dtype != torch.float32 or not rois.is_contiguous():
        raise ValueError('rois must be contiguous float32')
    first = feats[0]
    if first.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'features must be float32 or bfloat16, got '
                         f'{first.dtype}')
    for i, f in enumerate(feats):
        if f.dim() != 4 or f.shape[0] != rois.shape[0] or \
                f.shape[-1] != first.shape[-1]:
            raise ValueError(f'level {i} must be (B={rois.shape[0]}, H, W, '
                             f'C={first.shape[-1]}), got {tuple(f.shape)}')
        if f.dtype != first.dtype or not f.is_contiguous():
            raise ValueError(f'level {i} must be contiguous '
                             f'{first.dtype}')
        if f.device != rois.device:
            raise ValueError('features and rois are on different devices')
    if torch.is_grad_enabled() and any(f.requires_grad for f in feats):
        raise ValueError(
            'features require a gradient and this function carries none: '
            'call it under torch.no_grad(), or use '
            'ops.roi_align_rotated.roi_align_rotated to differentiate')


def vector_path(feats: Sequence[torch.Tensor]) -> bool:
    """Whether the kernel takes its 16-byte path for these levels: the
    channels fill whole 16-byte vectors and every level starts on a 16-byte
    boundary (the output, from ``torch.empty``, always does). Otherwise it
    takes the scalar path, one channel per lane."""
    elt = feats[0].element_size()
    return (feats[0].shape[-1] * elt) % 16 == 0 and \
        all(f.data_ptr() % 16 == 0 for f in feats)


def roi_align_rotated_pyramid_plain(
        feats: Sequence[torch.Tensor], rois: torch.Tensor,
        out_size: Tuple[int, int] = (7, 7),
        spatial_scales: Sequence[float] = (1 / 4, 1 / 8, 1 / 16, 1 / 32),
        sampling_ratio: int = 2, finest_scale: float = 56.0,
        clockwise: bool = False,
        roi_block: int = PLAIN_ROI_BLOCK) -> torch.Tensor:
    """Plain version of the kernel: the gather formulation,
    :func:`.roi_align_rotated.roi_align_rotated`, without a gradient, over
    blocks of ``roi_block`` RoIs per image. Same values as the unblocked
    call."""
    _check(feats, rois, out_size, spatial_scales, sampling_ratio)
    with torch.no_grad():
        parts = [roi_align_rotated(feats, rois[:, r:r + roi_block], out_size,
                                   spatial_scales, sampling_ratio,
                                   finest_scale, clockwise)
                 for r in range(0, max(rois.shape[1], 1), roi_block)]
        return torch.cat(parts, 1)


def roi_align_rotated_pyramid(
        feats: Sequence[torch.Tensor], rois: torch.Tensor,
        out_size: Tuple[int, int] = (7, 7),
        spatial_scales: Sequence[float] = (1 / 4, 1 / 8, 1 / 16, 1 / 32),
        sampling_ratio: int = 2, finest_scale: float = 56.0,
        clockwise: bool = False) -> torch.Tensor:
    """RoIAlignRotated, 7x7 bins with 2x2 samples (1 with
    ``sampling_ratio=1``), no gradient.

    ``feats``: up to four levels ``(B, H_l, W_l, C)``, channels-last,
    contiguous, float32 or bfloat16; ``rois (B, R, 5)`` float32
    ``[cx, cy, w, h, theta]`` in image coordinates; ``spatial_scales``: one
    per level. Returns ``(B, R, 7, 7, C)`` in the features' dtype;
    accumulation is float32. Raises for any other ``out_size`` or
    ``sampling_ratio``."""
    _check(feats, rois, out_size, spatial_scales, sampling_ratio)
    if rois.device.type == 'cpu':
        return roi_align_rotated_pyramid_plain(
            feats, rois, out_size, spatial_scales, sampling_ratio,
            finest_scale, clockwise)
    if rois.device.type != 'cuda':
        raise ValueError(f'no kernel for device {rois.device}')
    from ..utils.cuda_build import build
    fn = build([KERNEL])[KERNEL].lib.roi_align_rotated
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] + \
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    b, r = rois.shape[:2]
    c = feats[0].shape[-1]
    n = len(feats)
    if b > 65535:
        raise ValueError(f'batch {b} exceeds the grid limit 65535')
    for f in feats:
        # the kernel's corner offsets within one image's level are 32-bit
        if (f.shape[1] + 2) * (f.shape[2] + 2) * c >= 2 ** 31 - 1:
            raise ValueError(f'level {tuple(f.shape)} is too large for the '
                             f'kernel\'s 32-bit offsets')
    # the level comes from the function the plain version uses, so the card's
    # log2 cannot route a RoI differently
    levels = level_of_rois(rois, n, finest_scale).to(torch.int32).contiguous()
    out = torch.empty((b, r, 7, 7, c), dtype=feats[0].dtype,
                      device=rois.device)
    if out.numel():
        ptrs = (ctypes.c_void_p * n)(*[f.data_ptr() for f in feats])
        hs = (ctypes.c_int * n)(*[f.shape[1] for f in feats])
        ws = (ctypes.c_int * n)(*[f.shape[2] for f in feats])
        scales = (ctypes.c_float * n)(*[float(s) for s in spatial_scales])
        with torch.cuda.device(rois.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(ptrs, hs, ws, scales, n, rois.data_ptr(),
                     levels.data_ptr(), out.data_ptr(), b, r, c,
                     int(feats[0].dtype == torch.bfloat16),
                     int(vector_path(feats)), int(clockwise),
                     int(sampling_ratio), stream)
        if err != 0:
            raise RuntimeError(
                f'roi_align_rotated launch failed: CUDA error {err}')
        roi_align_rotated_pyramid.launches += 1
    return out


roi_align_rotated_pyramid.launches = 0
