"""Rotated-box IoU, plain PyTorch (counterpart of
``orientedobjectdetection_tpu/ops/iou.py:box_iou_rotated``).

Same formulation as the JAX package, so the two agree to float rounding:
the intersection of two convex polygons is bounded by the sub-segments of
each polygon's edges that lie inside the other, and by Green's theorem its
area is ``1/2 * sum cross(start, end)`` over those segments, whatever their
order. Each of the 8 edges is clipped against the other box's 4 half-planes
in closed form (Liang-Barsky): fixed shapes, no sort, differentiable.

This is also the plain version of the CUDA kernels (:mod:`.iou_kernels`:
the NMS pair mask and the assignment IoU matrix), which evaluate the same
per-pair arithmetic.
"""

from __future__ import annotations

import torch

from .boxes import obb2poly


def _cross2(a, b):
    """z-component of the 2-D cross product, (..., 2) x (..., 2) -> (...)."""
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def _box_corners(boxes):
    """(..., 5) -> (..., 4, 2) corners (TL, TR, BR, BL in box frame)."""
    return obb2poly(boxes).reshape(boxes.shape[:-1] + (4, 2))


def _edge_contributions(corners_a, corners_b):
    """Sum of cross(start, end) over the sub-segments of A's edges that lie
    inside B (both (..., 4, 2), counter-clockwise)."""
    a = corners_a
    d = torch.roll(corners_a, -1, dims=-2) - a          # A edge vectors
    vb = corners_b
    eb = torch.roll(corners_b, -1, dims=-2) - vb        # B edge vectors
    # Inside B: cross(eb_k, q - vb_k) >= 0 for all k. For p(t) = a + t d:
    #   f_k(t) = cross(eb_k, a - vb_k) + t * cross(eb_k, d) >= 0
    a_e = a[..., :, None, :]                            # (..., 4A, 1, 2)
    d_e = d[..., :, None, :]
    vb_e = vb[..., None, :, :]                          # (..., 1, 4B, 2)
    eb_e = eb[..., None, :, :]
    num = _cross2(eb_e, a_e - vb_e)                     # (..., 4A, 4B)
    den = _cross2(eb_e, d_e)

    t_at = -num / torch.where(den.abs() > 1e-12, den, den.new_tensor(1e-12))
    # den > 0 -> lower bound; den < 0 -> upper bound;
    # den ~ 0 and num < 0 -> the edge lies outside this half-plane.
    big = 1e9
    lower = torch.where(den > 1e-12, t_at, t_at.new_tensor(-big))
    upper = torch.where(den < -1e-12, t_at, t_at.new_tensor(big))
    parallel_out = (den.abs() <= 1e-12) & (num < 0)
    lower = torch.where(parallel_out, lower.new_tensor(big), lower)

    t0 = torch.clamp(lower.amax(-1), min=0.0)          # (..., 4A)
    t1 = torch.clamp(upper.amin(-1), max=1.0)
    p0 = a + t0[..., None] * d
    p1 = a + t1[..., None] * d
    contrib = torch.where(t1 > t0, _cross2(p0, p1), t0.new_tensor(0.0))
    return contrib.sum(-1)


def _intersect_area_rel(rel1, ctr1, rel2, ctr2):
    """Intersection area from per-box corners relative to each box center
    (computed once per box by the caller, so the sincos is O(N + M)).

    Each pair is evaluated in a frame centered on the pair midpoint, which
    removes float32 cancellation when boxes are small next to their image
    coordinates."""
    u = 0.5 * (ctr1 - ctr2)
    c1 = rel1 + u[..., None, :]
    c2 = rel2 - u[..., None, :]
    area2 = _edge_contributions(c1, c2) + _edge_contributions(c2, c1)
    return torch.clamp(0.5 * area2, min=0.0)


def box_area(boxes):
    return boxes[..., 2] * boxes[..., 3]


def box_iou_rotated(boxes1: torch.Tensor, boxes2: torch.Tensor,
                    mode: str = 'iou', aligned: bool = False,
                    eps: float = 1e-6) -> torch.Tensor:
    """Rotated IoU / IoF.

    Args:
        boxes1: (..., N, 5).
        boxes2: (..., M, 5).
        mode: 'iou' or 'iof' (intersection over the first set's area).
        aligned: if True, N == M and IoU is element-wise -> (..., N);
            otherwise the full (..., N, M) matrix.
    """
    if mode not in ('iou', 'iof'):
        raise ValueError(f'mode must be iou or iof, got {mode!r}')
    # Coincident edges traversed in the SAME direction (identical boxes)
    # would be counted by both passes; shrinking one operand by a relative
    # 1e-6 removes that tie at O(1e-6) relative area error.
    shrink = boxes2.new_tensor([1.0, 1.0, 1.0 - 1e-6, 1.0 - 1e-6, 1.0])
    b2s = boxes2 * shrink
    rel1 = _box_corners(torch.cat(
        [torch.zeros_like(boxes1[..., :2]), boxes1[..., 2:]], -1))
    rel2 = _box_corners(torch.cat(
        [torch.zeros_like(b2s[..., :2]), b2s[..., 2:]], -1))
    ctr1, ctr2 = boxes1[..., :2], boxes2[..., :2]
    area1, area2 = box_area(boxes1), box_area(boxes2)
    if not aligned:
        rel1, ctr1 = rel1[..., :, None, :, :], ctr1[..., :, None, :]
        rel2, ctr2 = rel2[..., None, :, :, :], ctr2[..., None, :, :]
        area1, area2 = area1[..., :, None], area2[..., None, :]
    inter = _intersect_area_rel(rel1, ctr1, rel2, ctr2)
    # physical bound (degenerate / parallel-edge numerical safety)
    inter = torch.minimum(inter, torch.minimum(area1, area2))
    denom = area1 + area2 - inter if mode == 'iou' else area1.expand_as(inter)
    return inter / torch.clamp(denom, min=eps)


def _clamp_wh(boxes: torch.Tensor) -> torch.Tensor:
    return torch.cat([boxes[..., :2], boxes[..., 2:4].clamp(min=1e-3),
                      boxes[..., 4:5]], -1)


def rbbox_overlaps(bboxes1: torch.Tensor, bboxes2: torch.Tensor,
                   mode: str = 'iou', is_aligned: bool = False,
                   plain: bool = False) -> torch.Tensor:
    """IoU calculator (reference
    ``core/bbox/iou_calculators/rotate_iou2d_calculator.py:8-89``): takes
    (..., 5) or (..., 6) boxes (a score column is dropped), clamps w/h to
    >= 1e-3, and gives zeros for an empty set.

    An unaligned matrix that needs no gradient, the label assigner's case,
    goes through :func:`.iou_kernels.box_iou_rotated_matrix`: the CUDA
    kernel for CUDA tensors of any size, its plain version for CPU tensors
    (``plain=True`` asks for the plain version on the card too: a reference
    run). Aligned pairs and inputs that require a gradient take the
    differentiable :func:`box_iou_rotated`, plain tensor code on any device."""
    if bboxes1.shape[-1] == 6:
        bboxes1 = bboxes1[..., :5]
    if bboxes2.shape[-1] == 6:
        bboxes2 = bboxes2[..., :5]
    if bboxes1.shape[-2] == 0 or bboxes2.shape[-2] == 0:
        if is_aligned:
            return bboxes1.new_zeros(bboxes1.shape[:-1])
        return bboxes1.new_zeros(bboxes1.shape[:-1] + (bboxes2.shape[-2],))
    clamped1, clamped2 = _clamp_wh(bboxes1), _clamp_wh(bboxes2)
    needs_grad = torch.is_grad_enabled() and (clamped1.requires_grad or
                                              clamped2.requires_grad)
    if is_aligned or needs_grad or max(clamped1.dim(), clamped2.dim()) > 3:
        return box_iou_rotated(clamped1, clamped2, mode=mode,
                               aligned=is_aligned)
    from .iou_kernels import (box_iou_rotated_matrix,
                              box_iou_rotated_matrix_plain)
    fn = box_iou_rotated_matrix_plain if plain else box_iou_rotated_matrix
    return fn(clamped1.float(), clamped2.float(), mode)
