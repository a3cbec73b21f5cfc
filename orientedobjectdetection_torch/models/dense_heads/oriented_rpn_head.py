"""Oriented RPN head (counterpart of
``orientedobjectdetection_tpu/models/dense_heads/oriented_rpn_head.py``;
reference ``dense_heads/oriented_rpn_head.py:15-``, ``rotated_rpn_head.py``).

Horizontal anchors regress 6-parameter midpoint offsets; proposals are the
decoded rotated boxes, filtered by an axis-aligned NMS over their
circumscribed boxes. Batched with a leading dimension and static shapes:
proposals come out as a fixed ``(B, max_num, 5)`` zero-padded tensor with
scores and a validity mask.

Training targets come for the whole batch at once, under ``no_grad``: one
assignment of the padded gts' circumscribed boxes against the anchors (one
IoU matrix, one kernel launch on the card), sampling keyed by the gts
(``rng_from_gt``), and masks in place of index sets, so the loss waits for
no host round trip.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from ...core.anchors import cached
from ...core.assigners import (MaxIoUAssigner, random_sample_masks,
                               rng_from_gt)
from ...ops.boxes import hbb2obb, obb2hbb, obb2xyxy
from ...ops.nms import NEG_INF, nms_hbb, topk_candidates
from ...utils.registry import BBOX_CODERS, HEADS, LOSSES, PRIOR_GENERATORS


@HEADS.register_module()
class OrientedRPNHead(nn.Module):
    """``rpn_conv`` (3x3 + ReLU), then ``rpn_cls`` (A objectness logits) and
    ``rpn_reg`` (A*6 midpoint-offset deltas) per location, shared by the
    levels. ``train_cfg`` holds the ``assigner`` and ``sampler`` settings
    (defaults: IoU 0.7 / 0.3 / 0.3, 256 anchors at 0.5); the losses default
    to sigmoid cross entropy and smooth L1 with beta 1/9, as the JAX
    package's do."""

    default_nms_thr = 0.8

    def __init__(self, in_channels: int = 256, feat_channels: int = 256,
                 num_classes: int = 1,
                 anchor_generator: Optional[dict] = None,
                 bbox_coder: Optional[dict] = None,
                 loss_cls: Optional[dict] = None,
                 loss_bbox: Optional[dict] = None,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None,
                 version: str = 'le90',
                 init_cfg: Optional[dict] = None):
        super().__init__()
        self.version = version
        self.train_cfg = train_cfg or {}
        self.test_cfg = test_cfg or {}
        assigner = dict(self.train_cfg.get('assigner') or dict(
            pos_iou_thr=0.7, neg_iou_thr=0.3, min_pos_iou=0.3))
        assigner.pop('type', None)
        assigner.pop('iou_calculator', None)
        self.assigner = MaxIoUAssigner(**assigner)
        self.cls_loss = LOSSES.build(dict(loss_cls or dict(
            type='CrossEntropyLoss', use_sigmoid=True, loss_weight=1.0)))
        self.bbox_loss = LOSSES.build(dict(loss_bbox or dict(
            type='SmoothL1Loss', beta=1.0 / 9.0, loss_weight=1.0)))
        anchors = dict(anchor_generator or dict(
            scales=[8], ratios=[0.5, 1.0, 2.0], strides=[4, 8, 16, 32, 64]))
        anchors['type'] = 'RotatedAnchorGenerator'
        self.prior_generator = PRIOR_GENERATORS.build(anchors)
        self.coder = self.build_coder(bbox_coder)
        self.num_anchors = self.prior_generator.num_base_anchors[0]
        self.rpn_conv = nn.Conv2d(in_channels, feat_channels, 3, padding=1)
        self.rpn_cls = nn.Conv2d(feat_channels, self.num_anchors, 1)
        self.rpn_reg = nn.Conv2d(feat_channels,
                                 self.num_anchors * self.coder.encode_size, 1)
        self._anchor_cache: Dict[tuple, Sequence[torch.Tensor]] = {}

    def build_coder(self, bbox_coder: Optional[dict]):
        return BBOX_CODERS.build(dict(
            bbox_coder or dict(type='MidpointOffsetCoder',
                               angle_range=self.version)))

    def regression_targets(self, anchors_xyxy, matched):
        """Deltas of the anchors (N, 4) xyxy to their matched rotated gts
        (B, N, 5)."""
        return self.coder.encode(anchors_xyxy[None], matched)

    def keep_size(self, boxes, min_bbox_size: float):
        """The decoded candidates (B, K, 5) whose w and h reach
        ``min_bbox_size``."""
        return (boxes[..., 2] >= min_bbox_size) & \
            (boxes[..., 3] >= min_bbox_size)

    def candidate_hbbs(self, boxes):
        """The xyxy boxes the proposals' NMS compares."""
        return obb2xyxy(boxes, self.version)

    def forward(self, feats):
        """NCHW levels -> per-level (cls_scores (B, A, H, W),
        bbox_preds (B, A*E, H, W)), E the coder's ``encode_size``."""
        cls_scores, bbox_preds = [], []
        for x in feats:
            t = F.relu(self.rpn_conv(x))
            cls_scores.append(self.rpn_cls(t))
            bbox_preds.append(self.rpn_reg(t))
        return tuple(cls_scores), tuple(bbox_preds)

    def anchors(self, featmap_sizes, device) -> Sequence[torch.Tensor]:
        key = (tuple(tuple(s) for s in featmap_sizes), str(device))
        return cached(self._anchor_cache, key,
                      lambda: self.prior_generator.grid_priors(
                          featmap_sizes, device=device))

    def train_anchors(self, featmap_sizes, device):
        """The anchors of all levels as xyxy boxes (N, 4) and as the
        rotated boxes the assigner compares, ``hbb2obb`` of those (N, 5)."""
        key = (tuple(tuple(s) for s in featmap_sizes), str(device), 'train')

        def make():
            xyxy = obb2xyxy(torch.cat(list(self.anchors(featmap_sizes,
                                                        device)), 0),
                            self.version)
            return xyxy, hbb2obb(xyxy, self.version)

        return cached(self._anchor_cache, key, make)

    @torch.no_grad()
    def targets(self, anchors_xyxy, anchors_rot, gt_bboxes, gt_mask):
        """Padded gts (B, G, 5) / (B, G) -> per-anchor foreground (B, N),
        label weights (the sampled anchors), midpoint-offset targets
        (B, N, 6) and box weights (the sampled positives)."""
        gt_hbb = obb2hbb(gt_bboxes, self.version)
        assign = self.assigner(anchors_rot, gt_hbb,
                               torch.zeros_like(gt_mask, dtype=torch.long),
                               gt_mask)
        samp = self.train_cfg.get('sampler') or {}
        pos, neg = random_sample_masks(
            assign.assigned_gt_inds >= 0, assign.assigned_gt_inds == -1,
            int(samp.get('num', 256)), float(samp.get('pos_fraction', 0.5)),
            rng_from_gt(gt_bboxes),
            neg_pos_ub=int(samp.get('neg_pos_ub', -1)))
        safe = assign.assigned_gt_inds.clamp(min=0)
        matched = gt_bboxes.gather(1, safe[..., None].expand(-1, -1, 5))
        deltas = self.regression_targets(anchors_xyxy, matched)
        deltas = torch.where(pos[..., None], deltas, 0.0)
        return pos.float(), (pos | neg).float(), deltas, pos.float()

    def loss(self, outputs, gt_bboxes, gt_labels, gt_mask):
        """Batched loss: sigmoid objectness and midpoint-offset regression,
        both averaged over the sampled anchors of the batch (mmdet's RPN
        normalization). ``gt_labels`` is not read: objectness is
        class-agnostic. Returns ``dict(loss_rpn_cls, loss_rpn_bbox)``."""
        cls_scores, bbox_preds = outputs
        featmap_sizes = [tuple(s.shape[-2:]) for s in cls_scores]
        anchors_xyxy, anchors_rot = self.train_anchors(
            featmap_sizes, cls_scores[0].device)
        with record_function('two_stage.rpn_targets'):
            fg, label_weights, bbox_targets, bbox_weights = self.targets(
                anchors_xyxy, anchors_rot, gt_bboxes.float(), gt_mask)
        b = cls_scores[0].shape[0]
        # NCHW -> location-major, anchor a of a location at loc * A + a
        cls_flat = torch.cat([s.permute(0, 2, 3, 1).reshape(b, -1)
                              for s in cls_scores], 1).float()
        e = self.coder.encode_size
        box_flat = torch.cat([p.permute(0, 2, 3, 1).reshape(b, -1, e)
                              for p in bbox_preds], 1).float()
        num_samples = label_weights.sum().clamp(min=1.0)
        loss_cls = self.cls_loss(cls_flat[..., None], fg[..., None],
                                 weight=label_weights,
                                 avg_factor=num_samples)
        loss_bbox = self.bbox_loss(box_flat, bbox_targets,
                                   weight=bbox_weights,
                                   avg_factor=num_samples)
        return dict(loss_rpn_cls=loss_cls, loss_rpn_bbox=loss_bbox)

    def get_proposals(self, outputs, cfg=None, max_candidates: int = 4096):
        """Decode + HBB NMS: per level the top ``nms_pre`` anchors by
        objectness, decoded; a size filter; the top ``max_candidates`` of
        all levels through :func:`nms_hbb` on their circumscribed boxes;
        the top ``max_num`` survivors.

        Args:
            outputs: (cls_scores, bbox_preds), per-level NCHW maps.
        Returns:
            proposals (B, max_num, 5) float32, zero-padded; scores
            (B, max_num); valid (B, max_num) bool.
        """
        cls_scores, bbox_preds = outputs
        cfg = cfg if cfg is not None else self.test_cfg
        nms_pre = int(cfg.get('nms_pre', 2000))
        max_num = int(cfg.get('max_per_img', cfg.get('max_num', 2000)))
        nms_cfg = cfg.get('nms', {})
        iou_thr = float(nms_cfg.get('iou_thr', nms_cfg.get(
            'iou_threshold', self.default_nms_thr)))
        min_bbox_size = float(cfg.get('min_bbox_size', 0))

        featmap_sizes = [tuple(s.shape[-2:]) for s in cls_scores]
        level_anchors = self.anchors(featmap_sizes, cls_scores[0].device)
        e = self.coder.encode_size
        cand_boxes, cand_scores = [], []
        for logits, deltas, anchors in zip(cls_scores, bbox_preds,
                                           level_anchors):
            b = logits.shape[0]
            # NCHW -> (B, h*w*A): anchor a of a location at index loc*A + a
            scores = torch.sigmoid(
                logits.permute(0, 2, 3, 1).reshape(b, -1).float())
            deltas = deltas.permute(0, 2, 3, 1).reshape(b, -1, e).float()
            k = min(nms_pre, scores.shape[1])
            top_s, top_i = topk_candidates(scores, k)          # (B, k)
            anchors_xyxy = obb2xyxy(anchors[top_i], self.version)
            sel = deltas.gather(1, top_i[..., None].expand(-1, -1, e))
            cand_boxes.append(self.coder.decode(anchors_xyxy, sel))
            cand_scores.append(top_s)
        boxes = torch.cat(cand_boxes, 1)
        scores = torch.cat(cand_scores, 1)
        ok = self.keep_size(boxes, min_bbox_size)
        if ok is not None:
            scores = torch.where(ok, scores, scores.new_tensor(NEG_INF))
        # cap the NMS problem size
        k = min(max_candidates, scores.shape[1])
        top_s, top_i = topk_candidates(scores, k)
        d = boxes.shape[-1]
        top_b = boxes.gather(1, top_i[..., None].expand(-1, -1, d))
        valid = top_s > NEG_INF / 2
        hbbs = self.candidate_hbbs(top_b)
        hbbs = torch.where(valid[..., None], hbbs, torch.zeros_like(hbbs))
        keep, _ = nms_hbb(hbbs, top_s, iou_thr, valid_mask=valid)
        kept_scores = torch.where(keep, top_s, top_s.new_tensor(NEG_INF))
        if k < max_num:                      # keep the padded output shape
            kept_scores = F.pad(kept_scores, (0, max_num - k), value=NEG_INF)
            top_b = F.pad(top_b, (0, 0, 0, max_num - k))
        out_s, out_i = topk_candidates(kept_scores, max_num)
        out_valid = out_s > NEG_INF / 2
        out_b = top_b.gather(1, out_i[..., None].expand(-1, -1, d))
        out_b = torch.where(out_valid[..., None], out_b,
                            torch.zeros_like(out_b))
        out_s = torch.where(out_valid, out_s, torch.zeros_like(out_s))
        return out_b, out_s, out_valid
