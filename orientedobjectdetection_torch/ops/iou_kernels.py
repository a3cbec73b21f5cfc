"""The port's CUDA kernels for rotated IoU, each beside its plain PyTorch
version (counterparts of ``orientedobjectdetection_tpu/ops/iou_pallas.py``).

:func:`nms_pair_mask` (``csrc/nms_pair_mask.cu``, for
``nms_pair_mask_pallas``) takes score-sorted, class-major boxes
``(B, N, 5)`` and returns the ``(B, N, N)`` uint8 mask ``IoU(i, j) > thr``
for ``i < j`` of the same class.

:func:`box_iou_rotated_matrix` (``csrc/box_iou_rotated.cu``, for
``box_iou_rotated_pallas``) returns the full IoU or IoF matrix of two box
sets, without a gradient: the label assigner's matrix of a few gt boxes per
image against every anchor.

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel,
one launch for the whole batch, or raises. Each wrapper counts its launches
in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .iou import box_iou_rotated

KERNEL = 'nms_pair_mask'
MATRIX_KERNEL = 'box_iou_rotated'
# the plain matrix evaluates at most this many pairs at once
PLAIN_PAIRS = 1 << 20


def _check(boxes: torch.Tensor, class_ids: Optional[torch.Tensor]):
    if boxes.dim() != 3 or boxes.shape[-1] != 5:
        raise ValueError(f'boxes must be (B, N, 5), got {tuple(boxes.shape)}')
    if boxes.dtype != torch.float32 or not boxes.is_contiguous():
        raise ValueError('boxes must be contiguous float32')
    if class_ids is not None:
        if class_ids.shape != boxes.shape[:2]:
            raise ValueError(f'class_ids must be {tuple(boxes.shape[:2])}, '
                             f'got {tuple(class_ids.shape)}')
        if class_ids.dtype != torch.int32 or not class_ids.is_contiguous():
            raise ValueError('class_ids must be contiguous int32')
        if class_ids.device != boxes.device:
            raise ValueError('boxes and class_ids are on different devices')


def pair_iou(boxes: torch.Tensor, block: int = 128) -> torch.Tensor:
    """(B, N, 5) -> (B, N, N) float32 rotated IoU of every pair, in row
    blocks so the clip intermediates stay at (B, block, N, 4, 4)."""
    return torch.cat([box_iou_rotated(boxes[:, r:r + block], boxes)
                      for r in range(0, boxes.shape[1], block)], 1)


def nms_pair_mask_plain(boxes: torch.Tensor, iou_thr: float,
                        class_ids: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Plain version of the kernel: ``box_iou_rotated > thr``, then the
    same-class and strict-upper-triangle masks (the JAX package's
    ``ops/nms.py:_upper_pair_mask`` jnp path)."""
    _check(boxes, class_ids)
    n = boxes.shape[1]
    mask = pair_iou(boxes) > iou_thr
    if class_ids is not None:
        mask &= class_ids[:, :, None] == class_ids[:, None, :]
    idx = torch.arange(n, device=boxes.device)
    mask &= idx[:, None] < idx[None, :]
    return mask.to(torch.uint8)


def nms_pair_mask(boxes: torch.Tensor, iou_thr: float,
                  class_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, N, 5) score-sorted boxes -> (B, N, N) uint8 strict-upper mask.

    ``class_ids`` ((B, N) int32, optional) makes suppression intra-class;
    with class-major order the kernel also skips cross-class tiles. Without
    it every pair counts as the same class."""
    _check(boxes, class_ids)
    if boxes.device.type == 'cpu':
        return nms_pair_mask_plain(boxes, iou_thr, class_ids)
    if boxes.device.type != 'cuda':
        raise ValueError(f'no kernel for device {boxes.device}')
    from ..utils.cuda_build import build
    fn = build([KERNEL])[KERNEL].lib.nms_pair_mask
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    b, n = boxes.shape[:2]
    if b > 65535:
        raise ValueError(f'batch {b} exceeds the grid limit 65535')
    if class_ids is None:
        class_ids = torch.zeros((b, n), dtype=torch.int32,
                                device=boxes.device)
    out = torch.empty((b, n, n), dtype=torch.uint8, device=boxes.device)
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(boxes.data_ptr(), class_ids.data_ptr(), out.data_ptr(),
                 b, n, float(iou_thr), stream)
    if err != 0:
        raise RuntimeError(f'nms_pair_mask launch failed: CUDA error {err}')
    nms_pair_mask.launches += 1
    return out


nms_pair_mask.launches = 0


def _check_matrix(boxes1: torch.Tensor, boxes2: torch.Tensor, mode: str):
    if mode not in ('iou', 'iof'):
        raise ValueError(f'mode must be iou or iof, got {mode!r}')
    for name, b in (('boxes1', boxes1), ('boxes2', boxes2)):
        if b.dim() not in (2, 3) or b.shape[-1] != 5:
            raise ValueError(f'{name} must be (N, 5) or (B, N, 5), got '
                             f'{tuple(b.shape)}')
        if b.dtype != torch.float32 or not b.is_contiguous():
            raise ValueError(f'{name} must be contiguous float32')
    if boxes1.device != boxes2.device:
        raise ValueError('boxes1 and boxes2 are on different devices')
    if boxes1.dim() == 3 and boxes2.dim() == 3 and \
            boxes1.shape[0] != boxes2.shape[0]:
        raise ValueError(f'batch sizes differ: {boxes1.shape[0]} and '
                         f'{boxes2.shape[0]}')


def box_iou_rotated_matrix_plain(boxes1: torch.Tensor, boxes2: torch.Tensor,
                                 mode: str = 'iou',
                                 max_pairs: int = PLAIN_PAIRS
                                 ) -> torch.Tensor:
    """Plain version of the kernel: :func:`box_iou_rotated` over blocks of
    the longer set, so the ``(..., 4, 4)`` clip intermediates stay bounded
    by ``max_pairs`` pairs at a time. Same values as the unblocked call.

    ``boxes1 (N, 5)`` or ``(B, N, 5)``, ``boxes2 (M, 5)`` or ``(B, M, 5)``
    -> ``(N, M)``, or ``(B, N, M)`` when either is batched."""
    _check_matrix(boxes1, boxes2, mode)
    n, m = boxes1.shape[-2], boxes2.shape[-2]
    batch = max(b.shape[0] if b.dim() == 3 else 1 for b in (boxes1, boxes2))
    if n == 0 or m == 0:
        return box_iou_rotated(boxes1, boxes2, mode)
    block = max(1, max_pairs // (batch * min(n, m)))
    if m >= n:
        parts = [box_iou_rotated(boxes1, boxes2[..., c:c + block, :], mode)
                 for c in range(0, m, block)]
        return torch.cat(parts, -1)
    parts = [box_iou_rotated(boxes1[..., r:r + block, :], boxes2, mode)
             for r in range(0, n, block)]
    return torch.cat(parts, -2)


def box_iou_rotated_matrix(boxes1: torch.Tensor, boxes2: torch.Tensor,
                           mode: str = 'iou') -> torch.Tensor:
    """Rotated IoU (or IoF, over the FIRST set's area) of every pair, no
    gradient.

    ``boxes1 (N, 5)`` or ``(B, N, 5)``, ``boxes2 (M, 5)`` or ``(B, M, 5)``
    -> ``(N, M)``, or ``(B, N, M)`` when either is batched; an unbatched set
    is shared by the batch. The kernel keeps the shorter set in shared
    memory and stores along the longer one; when that is ``boxes1`` the
    result is a transposed view of the ``(B, M, N)`` buffer it wrote."""
    _check_matrix(boxes1, boxes2, mode)
    if boxes1.device.type == 'cpu':
        return box_iou_rotated_matrix_plain(boxes1, boxes2, mode)
    if boxes1.device.type != 'cuda':
        raise ValueError(f'no kernel for device {boxes1.device}')
    from ..utils.cuda_build import build
    fn = build([MATRIX_KERNEL])[MATRIX_KERNEL].lib.box_iou_rotated
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    batched = boxes1.dim() == 3 or boxes2.dim() == 3
    batch = max(b.shape[0] if b.dim() == 3 else 1 for b in (boxes1, boxes2))
    rows_first = boxes1.shape[-2] <= boxes2.shape[-2]
    rows, cols = (boxes1, boxes2) if rows_first else (boxes2, boxes1)
    g, n = rows.shape[-2], cols.shape[-2]
    if batch > 65535 or -(-g // 32) > 65535:
        raise ValueError(f'batch {batch} or {g} rows exceed the grid limit')
    out = torch.empty((batch, g, n), dtype=torch.float32,
                      device=boxes1.device)
    if out.numel():
        with torch.cuda.device(boxes1.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(rows.data_ptr(), cols.data_ptr(), out.data_ptr(), batch,
                     g, n, int(rows.dim() == 3), int(cols.dim() == 3),
                     int(mode == 'iof'), int(rows_first), stream)
        if err != 0:
            raise RuntimeError(
                f'box_iou_rotated launch failed: CUDA error {err}')
        box_iou_rotated_matrix.launches += 1
    if not rows_first:
        out = out.transpose(1, 2)
    return out if batched else out[0]


box_iou_rotated_matrix.launches = 0
