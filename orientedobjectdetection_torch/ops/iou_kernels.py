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
# the plain matrix evaluates at most this many pairs at once, the plain
# pair mask this many rows
PLAIN_PAIRS = 1 << 20
PLAIN_ROWS = 128
# the C entry points' argument types: three pointers, ints and a float,
# then the stream
PAIR_MASK_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                          ctypes.c_float, ctypes.c_void_p]
MATRIX_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_FUNCTIONS = {}


def kernel_function(name: str, argtypes: list):
    """The C entry point ``name`` of ``csrc/<name>.cu``: built, loaded and
    given its argument types at the first call, then kept."""
    fn = _FUNCTIONS.get(name)
    if fn is None:
        from ..utils.cuda_build import build
        fn = getattr(build([name])[name].lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FUNCTIONS[name] = fn
    return fn


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


def pairs_in_reach(boxes1: torch.Tensor, boxes2: torch.Tensor
                   ) -> torch.Tensor:
    """Plain twin of the exact reject in the pair-mask kernel
    (``csrc/nms_pair_mask.cu``), the definition its tests hold it to:
    ``(..., N, M)`` bool, False for a pair whose IoU cannot exceed 0.

    A pair is out of reach when its centres lie farther apart on either
    axis than the sum of the boxes' ``(w + h) / 2`` (each at least the
    box's circumradius, so the boxes cannot meet; the IoU-matrix kernel's
    test), or when either box has an area ``w * h`` that is not positive
    (the physical bound ``min(inter, min(area1, area2))`` then caps the
    intersection at 0 or below). The same float32 operations as the
    kernel, so the two agree bit for bit."""
    w1, h1 = boxes1[..., 2], boxes1[..., 3]
    w2, h2 = boxes2[..., 2], boxes2[..., 3]
    r1 = (0.5 * (w1 + h1))[..., :, None]
    r2 = (0.5 * (w2 + h2))[..., None, :]
    dx = (boxes1[..., 0][..., :, None] - boxes2[..., 0][..., None, :]).abs()
    dy = (boxes1[..., 1][..., :, None] - boxes2[..., 1][..., None, :]).abs()
    reach = r1 + r2
    return (dx <= reach) & (dy <= reach) & \
        ((w1 * h1) > 0)[..., :, None] & ((w2 * h2) > 0)[..., None, :]


def nms_pair_mask_plain(boxes: torch.Tensor, iou_thr: float,
                        class_ids: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Plain version of the kernel: ``box_iou_rotated > thr``, then the
    same-class and strict-upper-triangle masks (the JAX package's
    ``ops/nms.py:_upper_pair_mask`` jnp path). Rows go in blocks of
    ``PLAIN_ROWS`` against the columns from the block's first row on,
    written into the output, so no ``(B, N, N)`` float array is made (a
    merge's N reaches tens of thousands)."""
    _check(boxes, class_ids)
    b, n = boxes.shape[:2]
    out = torch.zeros((b, n, n), dtype=torch.uint8, device=boxes.device)
    idx = torch.arange(n, device=boxes.device)
    for r in range(0, n, PLAIN_ROWS):
        rows = slice(r, r + PLAIN_ROWS)
        mask = box_iou_rotated(boxes[:, rows], boxes[:, r:]) > iou_thr
        if class_ids is not None:
            mask &= class_ids[:, rows, None] == class_ids[:, None, r:]
        mask &= idx[rows, None] < idx[None, r:]
        out[:, rows, r:] = mask
    return out


def nms_pair_mask(boxes: torch.Tensor, iou_thr: float,
                  class_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, N, 5) score-sorted boxes -> (B, N, N) uint8 strict-upper mask.

    ``class_ids`` ((B, N) int32, optional) makes suppression intra-class;
    with class-major order the kernel also skips cross-class tiles. Without
    it every pair counts as the same class. The kernel runs the clip math
    only on same-class pairs that :func:`pairs_in_reach` keeps."""
    _check(boxes, class_ids)
    if boxes.device.type == 'cpu':
        return nms_pair_mask_plain(boxes, iou_thr, class_ids)
    if boxes.device.type != 'cuda':
        raise ValueError(f'no kernel for device {boxes.device}')
    fn = kernel_function(KERNEL, PAIR_MASK_ARGS)
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


def matrix_layout(boxes1: torch.Tensor, boxes2: torch.Tensor, mode: str
                  ) -> tuple:
    """How the kernel takes one call: the shorter set are its rows (kept
    in shared memory), the longer its columns (along which it stores).
    Returns (rows, cols, flags), flags being the C entry point's ints
    ``(batch, g, n, rows_batched, cols_batched, iof, rows_first)``; the
    kernel writes a ``(batch, g, n)`` buffer."""
    batch = max(b.shape[0] if b.dim() == 3 else 1 for b in (boxes1, boxes2))
    rows_first = boxes1.shape[-2] <= boxes2.shape[-2]
    rows, cols = (boxes1, boxes2) if rows_first else (boxes2, boxes1)
    g, n = rows.shape[-2], cols.shape[-2]
    return rows, cols, (batch, g, n, int(rows.dim() == 3),
                        int(cols.dim() == 3), int(mode == 'iof'),
                        int(rows_first))


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
    fn = kernel_function(MATRIX_KERNEL, MATRIX_ARGS)
    rows, cols, flags = matrix_layout(boxes1, boxes2, mode)
    rows_first = flags[-1]
    out = torch.empty(flags[:3], dtype=torch.float32, device=boxes1.device)
    if out.numel():
        with torch.cuda.device(boxes1.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(rows.data_ptr(), cols.data_ptr(), out.data_ptr(), *flags,
                     stream)
        if err != 0:
            raise RuntimeError(
                f'box_iou_rotated launch failed: CUDA error {err}')
        box_iou_rotated_matrix.launches += 1
    if not rows_first:
        out = out.transpose(1, 2)
    return out if boxes1.dim() == 3 or boxes2.dim() == 3 else out[0]


box_iou_rotated_matrix.launches = 0
