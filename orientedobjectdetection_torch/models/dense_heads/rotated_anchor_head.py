"""Rotated RetinaNet head: towers, batched targets and loss, batched decode
(counterpart of
``orientedobjectdetection_tpu/models/dense_heads/rotated_anchor_head.py``:
``RotatedRetinaHead`` and ``AnchorHeadLogic``).

The towers run NCHW. At the loss and decode boundaries the maps are
permuted to the JAX package's channels-last order, channel ``a * C + c`` at
each location, so anchors ``(h*w, A)``, logits and deltas line up as they
do there.

Targets are computed for the whole batch at once on padded gt sets, under
``torch.no_grad()``, with masks in place of index sets: the loss has no
data-dependent shape and never waits for the host.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ...ops.nms import multiclass_nms_rotated, topk_candidates
from ...utils.registry import (BBOX_ASSIGNERS, BBOX_CODERS, HEADS, LOSSES,
                               PRIOR_GENERATORS)
from ..blocks import ConvModule


@HEADS.register_module()
class RotatedRetinaHead(nn.Module):
    """RetinaNet head: ``stacked_convs`` 3x3 convs per tower, then A*C
    class logits (``retina_cls``) and A*5 box deltas (``retina_reg``).

    ``loss_cls`` / ``loss_bbox`` and ``train_cfg['assigner']`` are built
    once, here; a head built without them serves but cannot compute a loss.
    ``assign_by_circumhbbox`` (an angle-version string) switches the
    assigner to the gts' circumscribed horizontal boxes, as the reference
    head option does (``rotated_anchor_head.py:231-239``)."""

    def __init__(self, num_classes: int = 15, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 anchor_generator: Optional[dict] = None,
                 bbox_coder: Optional[dict] = None,
                 loss_cls: Optional[dict] = None,
                 loss_bbox: Optional[dict] = None,
                 assign_by_circumhbbox: Optional[str] = None,
                 reg_decoded_bbox: bool = False,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None,
                 norm_cfg: Optional[dict] = None,
                 init_cfg: Optional[dict] = None):
        super().__init__()
        self.num_classes = num_classes
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg or {}
        self.reg_decoded_bbox = reg_decoded_bbox
        self.assign_by_circumhbbox = assign_by_circumhbbox
        self.cls_loss = LOSSES.build(dict(loss_cls)) if loss_cls else None
        self.bbox_loss = LOSSES.build(dict(loss_bbox)) if loss_bbox else None
        self.assigner = None
        if train_cfg and train_cfg.get('assigner'):
            assigner = dict(train_cfg['assigner'])
            if assign_by_circumhbbox is not None:
                assigner['assign_by_circumhbbox'] = assign_by_circumhbbox
            self.assigner = BBOX_ASSIGNERS.build(assigner)
        self.prior_generator = PRIOR_GENERATORS.build(dict(anchor_generator))
        self.coder = BBOX_CODERS.build(dict(bbox_coder))
        self.num_anchors = self.prior_generator.num_base_anchors[0]
        self.cls_convs = nn.ModuleList(
            ConvModule(in_channels if i == 0 else feat_channels,
                       feat_channels, 3, padding=1, relu=True)
            for i in range(stacked_convs))
        self.reg_convs = nn.ModuleList(
            ConvModule(in_channels if i == 0 else feat_channels,
                       feat_channels, 3, padding=1, relu=True)
            for i in range(stacked_convs))
        self.retina_cls = nn.Conv2d(feat_channels,
                                    self.num_anchors * num_classes, 3,
                                    padding=1)
        self.retina_reg = nn.Conv2d(feat_channels, self.num_anchors * 5, 3,
                                    padding=1)
        self._anchor_cache: Dict[tuple, Sequence[torch.Tensor]] = {}

    @property
    def cls_out_channels(self) -> int:
        return self.num_classes      # sigmoid classifier

    @torch.no_grad()
    def init_cls_prior(self):
        """Focal-loss prior bias on ``retina_cls``: every score starts near
        0.01."""
        self.retina_cls.bias.fill_(-math.log((1 - 0.01) / 0.01))

    def forward(self, feats):
        cls_scores, bbox_preds = [], []
        for x in feats:
            c = x
            for conv in self.cls_convs:
                c = conv(c)
            r = x
            for conv in self.reg_convs:
                r = conv(r)
            cls_scores.append(self.retina_cls(c))
            bbox_preds.append(self.retina_reg(r))
        return tuple(cls_scores), tuple(bbox_preds)

    def anchors(self, featmap_sizes, device) -> Sequence[torch.Tensor]:
        key = (tuple(tuple(s) for s in featmap_sizes), str(device))
        if key not in self._anchor_cache:
            self._anchor_cache[key] = self.prior_generator.grid_priors(
                featmap_sizes, device=device)
        return self._anchor_cache[key]

    def flat_anchors(self, featmap_sizes, device) -> torch.Tensor:
        """(N, 5) anchors concatenated over levels, the same for every
        image."""
        key = (tuple(tuple(s) for s in featmap_sizes), str(device), 'flat')
        if key not in self._anchor_cache:
            self._anchor_cache[key] = torch.cat(
                list(self.anchors(featmap_sizes, device)), 0)
        return self._anchor_cache[key]

    # ---- targets and loss (batched) -------------------------------------
    @torch.no_grad()
    def _targets(self, anchors, gt_bboxes, gt_labels, gt_mask,
                 gt_ignore=None, gt_ignore_mask=None):
        """anchors (N, 5) and padded gt (B, G, 5) / (B, G) / (B, G) ->
        per-anchor labels (B, N), label weights, box targets (B, N, E), box
        weights and the positive mask. ``gt_ignore`` / ``gt_ignore_mask``
        (padded ignore regions) reach the assigner when its
        ``ignore_iof_thr`` is set."""
        if gt_ignore is not None and self.assigner.ignore_iof_thr > 0:
            assign = self.assigner(anchors, gt_bboxes, gt_labels, gt_mask,
                                   gt_bboxes_ignore=gt_ignore,
                                   gt_ignore_mask=gt_ignore_mask)
        else:
            assign = self.assigner(anchors, gt_bboxes, gt_labels, gt_mask)
        pos = assign.assigned_gt_inds >= 0
        neg = assign.assigned_gt_inds == -1
        safe_idx = assign.assigned_gt_inds.clamp(min=0)
        matched_gt = gt_bboxes.gather(
            1, safe_idx[..., None].expand(-1, -1, gt_bboxes.shape[-1]))
        bbox_targets = self.coder.encode(anchors[None], matched_gt)
        bbox_targets = torch.where(pos[..., None], bbox_targets,
                                   bbox_targets.new_zeros(()))
        bbox_weights = pos.float()
        # positive -> gt label; everything else is background, num_classes
        labels = torch.where(pos, assign.labels, self.num_classes)
        label_weights = (pos | neg).float()
        return labels, label_weights, bbox_targets, bbox_weights, pos

    def _flatten_preds(self, cls_scores, bbox_preds):
        """Per-level NCHW maps -> float32 (B, N, C) and (B, N, E), in the
        anchors' order: location-major, channel ``a * C + c``."""
        b = cls_scores[0].shape[0]
        cls_flat = torch.cat([
            s.permute(0, 2, 3, 1).reshape(b, -1, self.cls_out_channels)
            for s in cls_scores], 1)
        box_flat = torch.cat([
            p.permute(0, 2, 3, 1).reshape(b, -1, self.coder.encode_size)
            for p in bbox_preds], 1)
        return cls_flat.float(), box_flat.float()

    def loss(self, outputs, gt_bboxes, gt_labels, gt_mask,
             gt_ignore=None, gt_ignore_mask=None):
        """Batched loss.

        Args:
            outputs: (cls_scores, bbox_preds), per-level NCHW maps.
            gt_bboxes (B, G, 5); gt_labels (B, G); gt_mask (B, G) bool.
            gt_ignore (B, K, 5) / gt_ignore_mask (B, K): optional padded
                ignore regions.
        Returns dict(loss_cls=..., loss_bbox=...) of float32 scalars.
        """
        if self.assigner is None or self.cls_loss is None or \
                self.bbox_loss is None:
            raise RuntimeError('the head was built without loss_cls, '
                               'loss_bbox or train_cfg.assigner')
        cls_scores, bbox_preds = outputs
        featmap_sizes = [tuple(s.shape[-2:]) for s in cls_scores]
        anchors = self.flat_anchors(featmap_sizes, cls_scores[0].device)
        labels, label_weights, bbox_targets, bbox_weights, pos = \
            self._targets(anchors, gt_bboxes.float(), gt_labels, gt_mask,
                          gt_ignore, gt_ignore_mask)
        cls_flat, box_flat = self._flatten_preds(cls_scores, bbox_preds)
        # batch-wide positive count, at least 1 (reference
        # rotated_anchor_head.py:455-459)
        num_pos = pos.sum().float().clamp(min=1.0)
        loss_cls = self.cls_loss(cls_flat, labels, weight=label_weights,
                                 avg_factor=num_pos)
        loss_bbox = self._reg_loss(anchors, box_flat, bbox_targets,
                                   bbox_weights, num_pos)
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox)

    def _reg_loss(self, anchors, box_flat, bbox_targets, bbox_weights,
                  num_pos):
        """Regression loss with mmdet's ``reg_decoded_bbox`` option: when
        set, predictions and targets are decoded first and the loss
        compares boxes instead of deltas."""
        if self.reg_decoded_bbox:
            decoded = self.coder.decode(anchors[None], box_flat)
            target_boxes = self.coder.decode(anchors[None], bbox_targets)
            return self.bbox_loss(decoded, target_boxes, weight=bbox_weights,
                                  avg_factor=num_pos)
        return self.bbox_loss(box_flat, bbox_targets, weight=bbox_weights,
                              avg_factor=num_pos)

    # ---- inference --------------------------------------------------------
    def candidates(self, outputs, img_shape=None, cfg=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per level, the top ``nms_pre`` anchors by max class logit,
        decoded (reference ``rotated_anchor_head.py:514-690``).

        Args:
            outputs: (cls_scores, bbox_preds), per-level NCHW maps.
        Returns:
            boxes (B, K, 5) float32 and sigmoid scores (B, K, C), K summed
            over levels.
        """
        cfg = cfg if cfg is not None else self.test_cfg
        nms_pre = int(cfg.get('nms_pre', 1000))
        cls_scores, bbox_preds = outputs[0], outputs[1]
        featmap_sizes = [tuple(s.shape[-2:]) for s in cls_scores]
        level_anchors = self.anchors(featmap_sizes, cls_scores[0].device)
        c_n, e_n = self.cls_out_channels, self.coder.encode_size
        cand_boxes, cand_scores = [], []
        for scores, deltas, anchors in zip(cls_scores, bbox_preds,
                                           level_anchors):
            b = scores.shape[0]
            # NCHW -> (B, h*w*A, C): channel a*C + c at each location
            logits = scores.permute(0, 2, 3, 1).reshape(b, -1, c_n)
            deltas = deltas.permute(0, 2, 3, 1).reshape(b, -1, e_n)
            n = logits.shape[1]
            k = min(nms_pre, n) if nms_pre > 0 else n
            # top-k on raw logits: sigmoid is monotonic
            best = logits.amax(-1).float()
            _, idx = topk_candidates(best, k)                  # (B, k)
            sel_logits = logits.gather(
                1, idx[..., None].expand(-1, -1, c_n)).float()
            sel_deltas = deltas.gather(
                1, idx[..., None].expand(-1, -1, e_n)).float()
            sel_anchors = anchors[idx]                         # (B, k, 5)
            cand_scores.append(torch.sigmoid(sel_logits))
            cand_boxes.append(self.coder.decode(sel_anchors, sel_deltas,
                                                max_shape=img_shape))
        return torch.cat(cand_boxes, 1), torch.cat(cand_scores, 1)

    def get_bboxes(self, outputs, img_shape=None, cfg=None,
                   plain_pair_mask: bool = False):
        """Batched decode + multiclass rotated NMS. Returns
        (dets (B, max_per_img, 6), labels (B, max_per_img), valid)."""
        cfg = cfg if cfg is not None else self.test_cfg
        boxes, scores = self.candidates(outputs, img_shape, cfg)
        # background column for the multiclass NMS contract
        scores = torch.cat([scores, scores.new_zeros(scores.shape[:2] + (1,))],
                           -1)
        nms_cfg = cfg.get('nms', {'iou_thr': 0.1})
        return multiclass_nms_rotated(
            boxes, scores,
            score_thr=float(cfg.get('score_thr', 0.05)),
            iou_thr=float(nms_cfg.get('iou_thr', 0.1)),
            max_per_img=int(cfg.get('max_per_img', 2000)),
            max_candidates=int(cfg.get('max_candidates', 2000)),
            plain_pair_mask=plain_pair_mask)
