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

The host helpers (:func:`nms_rotated_np`, :func:`aug_multiclass_nms_rotated`)
take numpy arrays of any length and run :func:`nms_rotated` at ``B=1`` on
``device``: the card unless ``'cpu'`` is asked for. They need no shape
buckets (the JAX package pads to powers of two to reuse XLA programs).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
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


def hbb_overlaps(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Axis-aligned IoU matrix of ``(..., N, 4)`` x ``(..., M, 4)`` xyxy
    boxes -> ``(..., N, M)``."""
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:4], boxes2[..., None, :, 2:4])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    a1 = (boxes1[..., 2] - boxes1[..., 0]).clamp(min=0) * \
        (boxes1[..., 3] - boxes1[..., 1]).clamp(min=0)
    a2 = (boxes2[..., 2] - boxes2[..., 0]).clamp(min=0) * \
        (boxes2[..., 3] - boxes2[..., 1]).clamp(min=0)
    union = a1[..., :, None] + a2[..., None, :] - inter
    return inter / union.clamp(min=1e-6)


def hbb_pair_mask(boxes: torch.Tensor, iou_thr: float,
                  block: int = 512) -> torch.Tensor:
    """(B, N, 4) score-sorted xyxy boxes -> (B, N, N) bool strict-upper mask
    ``IoU(i, j) > thr`` for ``i < j``. Built in row blocks against the
    columns from the block's first row on, so the ``(B, block, N, 2)``
    temporaries stay bounded and the lower triangle is never evaluated."""
    bsz, n = boxes.shape[:2]
    mask = torch.zeros((bsz, n, n), dtype=torch.bool, device=boxes.device)
    idx = torch.arange(n, device=boxes.device)
    for r in range(0, n, block):
        over = hbb_overlaps(boxes[:, r:r + block], boxes[:, r:]) > iou_thr
        over &= idx[r:r + block, None] < idx[None, r:]
        mask[:, r:r + block, r:] = over
    return mask


def nms_hbb(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
            valid_mask: Optional[torch.Tensor] = None):
    """Axis-aligned NMS with :func:`nms_rotated`'s contract, for the RPN:
    boxes (B, N, 4) xyxy, scores (B, N) -> keep (B, N) bool in the original
    index order, and the score order (B, N)."""
    if valid_mask is not None:
        scores = torch.where(valid_mask, scores, scores.new_tensor(NEG_INF))
    order, rank = argsort_desc(scores)
    sorted_boxes = boxes.gather(1, order[..., None].expand(-1, -1, 4))
    keep_sorted = greedy_suppress(hbb_pair_mask(sorted_boxes, iou_threshold))
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


def batched_nms_hbb(boxes: torch.Tensor, scores: torch.Tensor,
                    labels: torch.Tensor, iou_thr: float,
                    valid_mask: Optional[torch.Tensor] = None):
    """Class-offset axis-aligned NMS: (B, N, 4) xyxy boxes, each label's
    boxes shifted by ``label * (max coordinate + 1)`` of its image so that
    labels cannot suppress each other (JAX ``ops/nms.py:batched_nms_hbb``,
    per image). Returns :func:`nms_hbb`'s (keep, order)."""
    if valid_mask is None:
        valid_mask = torch.ones_like(scores, dtype=torch.bool)
    safe_boxes = torch.where(valid_mask[..., None], boxes,
                             torch.zeros_like(boxes))
    max_coordinate = safe_boxes.amax(dim=(-2, -1), keepdim=True)
    offsets = labels.to(boxes.dtype)[..., None] * (max_coordinate + 1)
    return nms_hbb(safe_boxes + offsets, scores, iou_thr,
                   valid_mask=valid_mask)


def host_device(device, caller: str) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device raises RuntimeError
    when no card is present (the host helpers never fall back to the
    CPU)."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'{caller}: no CUDA device is available; pass '
                           f'device="cpu" to run on the CPU')
    return device


def nms_rotated_np(boxes, scores, iou_thr: float, device='cuda',
                   plain_pair_mask: bool = False) -> np.ndarray:
    """Rotated NMS of numpy ``(N, 5)`` boxes and ``(N,)`` scores. On the
    card, one :func:`nms_rotated` at ``B=1`` (one launch of the pair-mask
    kernel); on ``device='cpu'`` the native greedy NMS of
    ``csrc/rnms.cpp`` (``..native.nms_rotated``, JAX
    ``ops/nms.py:368-374``), or the plain PyTorch NMS with
    ``plain_pair_mask``. Returns the survivors' indices in descending
    score order, the lowest index first on a tie (JAX
    ``ops/nms.py:nms_rotated_np``)."""
    boxes = np.asarray(boxes, np.float32).reshape(-1, 5)
    scores = np.asarray(scores, np.float32).reshape(-1)
    if boxes.shape[0] == 0:
        return np.zeros((0,), np.int64)
    device = host_device(device, 'nms_rotated_np')
    if device.type == 'cpu' and not plain_pair_mask:
        from .. import native
        return native.nms_rotated(boxes, scores, iou_thr)
    keep, order = nms_rotated(torch.from_numpy(boxes).to(device)[None],
                              torch.from_numpy(scores).to(device)[None],
                              iou_thr, plain_pair_mask=plain_pair_mask)
    order = order[0]
    return order[keep[0][order]].cpu().numpy()


def aug_multiclass_nms_rotated(merged_bboxes, merged_labels,
                               num_classes: int, iou_thr: float = 0.1,
                               max_per_img: int = 2000, device='cuda',
                               plain_pair_mask: bool = False):
    """Per-class rotated NMS of detections already mapped to one frame
    (test-time augmentation; JAX ``ops/nms.py:aug_multiclass_nms_rotated``,
    reference ``bbox_nms_rotated.py:95-144``).

    ``merged_bboxes`` ``(N, 6)`` ``[cx, cy, w, h, a, score]``,
    ``merged_labels`` ``(N,)``. Returns numpy ``(dets (M, 6), labels
    (M,))``, by descending score, at most ``max_per_img``."""
    merged_bboxes = np.asarray(merged_bboxes, np.float32).reshape(-1, 6)
    merged_labels = np.asarray(merged_labels)
    out_d, out_l = [], []
    for c in range(num_classes):
        sel = merged_bboxes[merged_labels == c]
        if not len(sel):
            continue
        kept = nms_rotated_np(sel[:, :5], sel[:, 5], iou_thr, device,
                              plain_pair_mask)
        out_d.append(sel[kept])
        out_l.append(np.full(len(kept), c, np.int64))
    if not out_d:
        return np.zeros((0, 6), np.float32), np.zeros((0,), np.int64)
    dets = np.concatenate(out_d)
    labels = np.concatenate(out_l)
    rank = np.argsort(-dets[:, 5])[:max_per_img]
    return dets[rank], labels[rank]
