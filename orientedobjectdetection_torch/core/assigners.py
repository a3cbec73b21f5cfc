"""Label assignment, batched over images and padded (counterpart of
``orientedobjectdetection_tpu/core/assigners.py``: ``AssignResult`` and
``MaxIoUAssigner``).

The assigner takes a padded gt set per image (``gt_bboxes (B, G, 5)``,
``gt_labels (B, G)``, ``gt_mask (B, G)``) and the anchors shared by the
batch, and returns per-prior results of fixed shape. Everything stays on
the inputs' device with no data-dependent shape (no ``nonzero``, no boolean
indexing), so a train step never waits for the host. The whole batch is one
call: one IoU matrix ``(B, G, N)``, one kernel launch on the card.

Output convention (``AssignResult``), each ``(B, N)``:
    assigned_gt_inds: int64, index into the gt axis; -1 = negative,
        -2 = ignore (between the thresholds or inside an ignore region).
    max_overlaps: float32.
    labels: int64, class of the assigned gt; -1 where not positive.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops.boxes import obb2hbb
from ..ops.iou import rbbox_overlaps
from ..utils.registry import BBOX_ASSIGNERS

NEG = -1
IGNORE = -2


class AssignResult(NamedTuple):
    assigned_gt_inds: torch.Tensor   # >= 0 gt index, -1 negative, -2 ignore
    max_overlaps: torch.Tensor
    labels: torch.Tensor             # -1 if not positive


@BBOX_ASSIGNERS.register_module()
class MaxIoUAssigner:
    """Max-IoU assignment with mmdet's tie-breaking:

    1. a prior is negative if its max IoU < ``neg_iou_thr`` (or inside the
       ``(lo, hi)`` range when that is a pair), ignored if between the
       thresholds;
    2. a prior with max IoU >= ``pos_iou_thr`` is positive to its argmax gt
       (lowest index on a tie);
    3. ``match_low_quality``: each gt claims ALL priors whose IoU with it
       equals the gt's max IoU (``gt_max_assign_all``; else only the first
       such prior) if that max >= ``min_pos_iou``; the highest claiming gt
       index wins a prior, as gts applied in order with overwrite;
    4. ``ignore_iof_thr`` > 0 with ignore boxes: a prior whose IoF with a
       valid ignore box exceeds it is ignored.

    ``assign_by_circumhbbox``: assign on the gts' circumscribed horizontal
    boxes (an angle-version string). ``plain_iou`` computes the matrices
    with the plain PyTorch version on any device (a reference run on the
    card)."""

    def __init__(self,
                 pos_iou_thr: float,
                 neg_iou_thr,
                 min_pos_iou: float = 0.0,
                 gt_max_assign_all: bool = True,
                 ignore_iof_thr: float = -1,
                 match_low_quality: bool = True,
                 assign_by_circumhbbox: Optional[str] = None,
                 iou_calculator: Optional[dict] = None,
                 plain_iou: bool = False):
        self.pos_iou_thr = pos_iou_thr
        self.neg_iou_thr = neg_iou_thr
        self.min_pos_iou = min_pos_iou
        self.gt_max_assign_all = gt_max_assign_all
        self.ignore_iof_thr = ignore_iof_thr
        self.match_low_quality = match_low_quality
        self.assign_by_circumhbbox = assign_by_circumhbbox
        self.plain_iou = plain_iou

    @torch.no_grad()
    def __call__(self, priors, gt_bboxes, gt_labels, gt_mask,
                 gt_bboxes_ignore=None, gt_ignore_mask=None) -> AssignResult:
        """priors (N, 5); gt_bboxes (B, G, 5); gt_labels (B, G); gt_mask
        (B, G) bool; optional gt_bboxes_ignore (B, K, 5) with
        gt_ignore_mask (B, K). A single image may come without the batch
        axis and gets its results without it."""
        if gt_bboxes.dim() == 2:
            single = self(
                priors, gt_bboxes[None], gt_labels[None], gt_mask[None],
                None if gt_bboxes_ignore is None else gt_bboxes_ignore[None],
                None if gt_ignore_mask is None else gt_ignore_mask[None])
            return AssignResult(*(t[0] for t in single))

        gt_for_iou = gt_bboxes
        if self.assign_by_circumhbbox is not None:
            gt_for_iou = obb2hbb(gt_bboxes, self.assign_by_circumhbbox)
        overlaps = rbbox_overlaps(gt_for_iou, priors,
                                  plain=self.plain_iou)        # (B, G, N)
        # Padded gts contribute 0: with no valid gt every prior has max
        # overlap 0 and is a negative. In place: the matrix is ours.
        overlaps.masked_fill_(~gt_mask[:, :, None], 0.0)

        max_overlaps, argmax_overlaps = overlaps.max(dim=1)    # (B, N)
        if isinstance(self.neg_iou_thr, (tuple, list)):
            lo, hi = self.neg_iou_thr
            is_neg = (max_overlaps >= lo) & (max_overlaps < hi)
        else:
            is_neg = max_overlaps < self.neg_iou_thr
        is_pos = max_overlaps >= self.pos_iou_thr

        assigned = torch.full_like(argmax_overlaps, IGNORE)
        assigned = torch.where(is_neg, NEG, assigned)
        assigned = torch.where(is_pos, argmax_overlaps, assigned)

        if self.match_low_quality:
            # row maxima and the equality test come from the same matrix
            gt_max, best = overlaps.max(dim=2)                 # (B, G)
            may_claim = (gt_max >= self.min_pos_iou) & gt_mask
            if self.gt_max_assign_all:
                claim = (overlaps == gt_max[:, :, None]) & \
                    may_claim[:, :, None]                      # (B, G, N)
            else:
                claim = torch.zeros_like(overlaps, dtype=torch.bool)
                claim.scatter_(2, best[:, :, None], may_claim[:, :, None])
            # the last gt to claim a prior wins: highest claiming index
            gt_idx = torch.arange(overlaps.shape[1], dtype=torch.int32,
                                  device=overlaps.device)[None, :, None]
            claimed_idx = torch.where(claim, gt_idx, -1).amax(1).long()
            assigned = torch.where(claimed_idx >= 0, claimed_idx, assigned)

        if self.ignore_iof_thr > 0 and gt_bboxes_ignore is not None:
            iof = rbbox_overlaps(priors, gt_bboxes_ignore, mode='iof',
                                 plain=self.plain_iou)         # (B, N, K)
            iof = torch.where(gt_ignore_mask[:, None, :], iof, -1.0)
            ignore_hit = iof.amax(2) > self.ignore_iof_thr
            assigned = torch.where(ignore_hit, IGNORE, assigned)

        labels = torch.where(
            assigned >= 0,
            gt_labels.long().gather(1, assigned.clamp(min=0)), -1)
        return AssignResult(assigned, max_overlaps, labels)
