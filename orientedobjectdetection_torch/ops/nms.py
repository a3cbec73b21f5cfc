"""Rotated NMS over fixed-size, padded, batched candidate lists
(counterpart of ``orientedobjectdetection_tpu/ops/nms.py``).

Same contract as the JAX package: padded candidates are masked, not
filtered; NMS returns a keep mask plus the score order; the multiclass
entry returns fixed-size ``(max_per_img, 6)`` detections padded with label
-1. What JAX does per image under ``vmap`` is a written-out leading batch
dimension here.

Ordering: stable, descending score, class-major when class ids are given,
lowest index first among ties (``torch.sort(..., stable=True)``).
Candidate top-k is the first k of that sort, which is ``lax.top_k``'s exact
set and order.
"""

from __future__ import annotations

from typing import Optional

import torch

from .iou_kernels import nms_pair_mask, nms_pair_mask_plain

NEG_INF = -1e10


def topk_candidates(scores: torch.Tensor, k: int):
    """Top-k along the last dim with the lowest index winning ties
    (``jax.lax.top_k``'s set and order). Returns (values, indices)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def argsort_desc(scores: torch.Tensor,
                 class_ids: Optional[torch.Tensor] = None):
    """Stable descending order of ``scores`` along the last dim, class-major
    (ascending class first) when ``class_ids`` is given. Returns
    (order, rank) with ``rank`` the inverse permutation."""
    order = torch.sort(scores, dim=-1, descending=True, stable=True)[1]
    if class_ids is not None:
        by_cls = torch.sort(class_ids.gather(-1, order), dim=-1,
                            stable=True)[1]
        order = order.gather(-1, by_cls)
    rank = torch.empty_like(order)
    rank.scatter_(-1, order, torch.arange(
        order.shape[-1], device=order.device).expand_as(order))
    return order, rank


def greedy_suppress(over: torch.Tensor) -> torch.Tensor:
    """Exact greedy NMS from a (B, N, N) strict-upper-triangular
    over-threshold mask of score-sorted boxes. Returns keep (B, N) bool.

    The greedy result is the unique fixpoint of
    ``keep[j] = not any(keep[i] and over[i, j] for i < j)``; the whole-vector
    update is iterated until it stops changing (each round fixes at least
    one more prefix index, so at most N rounds; a few in practice)."""
    over = over.bool()
    keep = torch.ones(over.shape[:2], dtype=torch.bool, device=over.device)
    for _ in range(over.shape[1]):
        new = ~(over & keep[:, :, None]).any(1)
        if torch.equal(new, keep):
            break
        keep = new
    return keep


def nms_rotated(boxes: torch.Tensor, scores: torch.Tensor,
                iou_threshold: float,
                valid_mask: Optional[torch.Tensor] = None,
                class_ids: Optional[torch.Tensor] = None,
                plain_pair_mask: bool = False):
    """Rotated NMS over padded candidates, batched.

    Args:
        boxes: (B, N, 5). scores: (B, N).
        valid_mask: optional (B, N) bool marking real candidates.
        class_ids: optional (B, N) int. Suppression becomes intra-class and
            the greedy pass visits candidates class-major; padded entries
            should carry a class above every real one.
        plain_pair_mask: build the pair mask with the plain PyTorch version
            instead of the CUDA kernel (a reference run on the card).

    Returns:
        keep: (B, N) bool, survivors in the original index order.
        order: (B, N) int64, indices by descending score (class-major when
            ``class_ids`` is given).
    """
    if valid_mask is not None:
        scores = torch.where(valid_mask, scores, scores.new_tensor(NEG_INF))
    order, rank = argsort_desc(scores, class_ids)
    sorted_boxes = boxes.gather(1, order[..., None].expand(-1, -1, 5))
    sorted_cls = None
    if class_ids is not None:
        sorted_cls = class_ids.gather(1, order).to(torch.int32).contiguous()
    pair_mask = nms_pair_mask_plain if plain_pair_mask else nms_pair_mask
    over = pair_mask(sorted_boxes.float().contiguous(), iou_threshold,
                     sorted_cls)
    keep_sorted = greedy_suppress(over)
    if valid_mask is not None:
        keep_sorted &= scores.gather(1, order) > NEG_INF / 2
    return keep_sorted.gather(1, rank), order


def multiclass_nms_rotated(multi_bboxes: torch.Tensor,
                           multi_scores: torch.Tensor,
                           score_thr: float, iou_thr: float,
                           max_per_img: int,
                           score_factors: Optional[torch.Tensor] = None,
                           max_candidates: int = 2000,
                           plain_pair_mask: bool = False):
    """Multi-class rotated NMS by the class-offset trick, batched.

    Static-shape form of the reference's
    ``core/post_processing/bbox_nms_rotated.py:6-92``: every (box, class)
    pair is a candidate; low scores are masked; the top ``max_candidates``
    go through one rotated NMS with boxes shifted per class so classes
    cannot overlap; the top ``max_per_img`` survivors come out padded.

    Args:
        multi_bboxes: (B, N, 5) or (B, N, C*5).
        multi_scores: (B, N, C + 1); the last column is background.
        score_factors: optional (B, N) multiplier.

    Returns:
        dets (B, max_per_img, 6) [cx, cy, w, h, a, score], zero-padded;
        labels (B, max_per_img) int64, padding -1; valid (B, max_per_img).
    """
    bsz, n = multi_scores.shape[:2]
    num_classes = multi_scores.shape[2] - 1
    if multi_bboxes.shape[-1] > 5:
        bboxes = multi_bboxes.reshape(bsz, n, num_classes, 5)
    else:
        bboxes = multi_bboxes[:, :, None, :].expand(bsz, n, num_classes, 5)
    scores = multi_scores[..., :-1]
    if score_factors is not None:
        scores = scores * score_factors[..., None]
    labels = torch.arange(num_classes, device=scores.device)
    labels = labels.expand(bsz, n, num_classes).reshape(bsz, -1)
    bboxes = bboxes.reshape(bsz, -1, 5)
    scores = scores.reshape(bsz, -1)

    scores = torch.where(scores > score_thr, scores,
                         scores.new_tensor(NEG_INF))
    k = min(max_candidates, scores.shape[1])
    top_scores, top_idx = topk_candidates(scores, k)
    top_boxes = bboxes.gather(1, top_idx[..., None].expand(-1, -1, 5))
    top_labels = labels.gather(1, top_idx)
    top_valid = top_scores > NEG_INF / 2

    # class-offset trick (reference bbox_nms_rotated.py:67-80)
    safe_boxes = torch.where(top_valid[..., None], top_boxes,
                             torch.zeros_like(top_boxes))
    extent = safe_boxes[..., :2].amax(-1) + safe_boxes[..., 2:4].amax(-1)
    max_coordinate = torch.where(top_valid, extent,
                                 extent.new_tensor(0.0)).amax(-1)
    offsets = top_labels.to(safe_boxes.dtype) * (max_coordinate[:, None] + 1)
    boxes_for_nms = torch.cat(
        [safe_boxes[..., :2] + offsets[..., None], safe_boxes[..., 2:]], -1)

    # padded candidates sort behind every real class, so the kernel's
    # class-range skip prunes their tiles too
    nms_cls = torch.where(top_valid, top_labels,
                          torch.full_like(top_labels, num_classes))
    keep, _ = nms_rotated(boxes_for_nms, top_scores, iou_thr,
                          valid_mask=top_valid, class_ids=nms_cls,
                          plain_pair_mask=plain_pair_mask)
    kept_scores = torch.where(keep & top_valid, top_scores,
                              top_scores.new_tensor(NEG_INF))

    if k < max_per_img:
        pad = max_per_img - k
        kept_scores = torch.nn.functional.pad(kept_scores, (0, pad),
                                              value=NEG_INF)
        top_boxes = torch.nn.functional.pad(top_boxes, (0, 0, 0, pad))
        top_labels = torch.nn.functional.pad(top_labels, (0, pad))
    out_idx = argsort_desc(kept_scores)[0][:, :max_per_img]
    out_scores = kept_scores.gather(1, out_idx)
    out_valid = out_scores > NEG_INF / 2
    out_boxes = top_boxes.gather(1, out_idx[..., None].expand(-1, -1, 5))
    out_boxes = torch.where(out_valid[..., None], out_boxes,
                            torch.zeros_like(out_boxes))
    out_scores = torch.where(out_valid, out_scores,
                             out_scores.new_tensor(0.0))
    dets = torch.cat([out_boxes, out_scores[..., None]], -1)
    out_labels = torch.where(out_valid, top_labels.gather(1, out_idx),
                             torch.full_like(out_idx, -1))
    return dets, out_labels, out_valid
