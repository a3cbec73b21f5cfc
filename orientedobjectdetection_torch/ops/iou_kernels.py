"""NMS pair mask: the CUDA kernel ``csrc/nms_pair_mask.cu`` and its plain
PyTorch version (counterpart of
``orientedobjectdetection_tpu/ops/iou_pallas.py:nms_pair_mask_pallas``).

:func:`nms_pair_mask` takes score-sorted, class-major boxes ``(B, N, 5)``
and returns the ``(B, N, N)`` uint8 mask ``IoU(i, j) > thr`` for ``i < j``
of the same class. A CPU tensor goes to :func:`nms_pair_mask_plain`; a CUDA
tensor launches the kernel, one launch for the whole batch, or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .iou import box_iou_rotated

KERNEL = 'nms_pair_mask'


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
