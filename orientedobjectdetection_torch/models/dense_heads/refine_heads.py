"""Refine-stage heads: R3Det's refine heads and S2ANet's ODM head
(counterpart of
``orientedobjectdetection_tpu/models/dense_heads/refine_heads.py``;
reference ``dense_heads/rotated_retina_refine_head.py:10-202``,
``odm_refine_head.py:12-223`` and their KFIoU variants).

A refine stage has one anchor a location, the previous stage's decoded box
there: a batched (B, N, 5) tensor handed in by the detector, detached.
Its loss runs the anchor heads' batched targets with those per-image
anchors; its decode takes one top-``nms_pre`` over all levels at once.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ...ops.nms import multiclass_nms_rotated, topk_candidates
from ...utils.registry import HEADS
from ..blocks import ConvModule
from ..utils_rotation import ORConv2d, rotation_invariant_pooling
from .rotated_anchor_head import (AnchorHead, KFIoURRetinaHead,
                                  RotatedRetinaHead, check_exact_topk,
                                  flatten_levels, kfiou_reg_loss)


class RefineHeadMixin:
    """Anchor-head logic over per-image anchors (B, N, 5), mixed into an
    :class:`AnchorHead`."""

    def loss_with_anchors(self, outputs, anchors, gt_bboxes, gt_labels,
                          gt_mask, prefix: str = '') -> dict:
        """``loss_cls`` and ``loss_bbox`` (named with ``prefix``) of this
        stage's outputs against the gts, with ``anchors`` (B, N, 5) the
        previous stage's detached rois."""
        losses = self._loss(outputs, gt_bboxes, gt_labels, gt_mask,
                            anchors=anchors)[0]
        return {prefix + k: v for k, v in losses.items()}

    def _reg_loss(self, anchors, box_flat, bbox_targets, bbox_weights,
                  num_pos):
        """The box loss on the deltas, as the JAX package's
        ``_refine_reg_loss`` (which reads no ``reg_decoded_bbox``)."""
        return self.bbox_loss(box_flat, bbox_targets, weight=bbox_weights,
                              avg_factor=num_pos)

    def refine_bboxes(self, outputs, anchors) -> torch.Tensor:
        """This stage's deltas decoded in float32 against its anchors at
        every location: the next stage's rois (B, N, 5), detached."""
        deltas = flatten_levels(outputs[1], 5).detach().float()
        return self.coder.decode(anchors, deltas)

    def get_bboxes_with_anchors(self, outputs, anchors, cfg=None,
                                img_shape=None,
                                plain_pair_mask: bool = False):
        """Decode + multiclass rotated NMS with per-image anchors: the top
        ``nms_pre`` locations over all levels at once by max raw logit (the
        lowest index first on a tie), decoded in float32 with ``img_shape``
        as the clip. Returns (dets (B, max_per_img, 6), labels, valid)."""
        cfg = cfg if cfg is not None else self.test_cfg
        check_exact_topk(cfg)
        c_n = self.cls_out_channels
        logits = flatten_levels(outputs[0], c_n)
        deltas = flatten_levels(outputs[1], 5)
        n = logits.shape[1]
        nms_pre = int(cfg.get('nms_pre', 2000))
        k = min(nms_pre, n) if nms_pre > 0 else n
        _, idx = topk_candidates(logits.amax(-1).float(), k)      # (B, k)
        sel_logits = logits.gather(
            1, idx[..., None].expand(-1, -1, c_n)).float()
        sel_deltas = deltas.gather(1, idx[..., None].expand(-1, -1, 5))
        sel_anchors = anchors.gather(1, idx[..., None].expand(-1, -1, 5))
        boxes = self.coder.decode(sel_anchors.float(), sel_deltas.float(),
                                  max_shape=img_shape)
        scores = torch.sigmoid(sel_logits)
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


@HEADS.register_module()
class RotatedRetinaRefineHead(RefineHeadMixin, RotatedRetinaHead):
    """R3Det's refine stage (reference ``rotated_retina_refine_head.py``):
    the RetinaNet towers with one anchor a location
    (``PseudoAnchorGenerator``), the anchors the previous stage's rois."""


class KFIoURefineMixin:
    """A refine stage with the KFIoU loss (reference
    ``kfiou_*_refine_head.py``): ``KFLoss`` on the deltas and the boxes
    decoded against the refined anchors; the configured ``KFLoss``, else
    ``KFLoss`` of weight 5, as the JAX package's ``_kfiou_refine_reg_loss``
    substitutes."""

    def __init__(self, *args, loss_bbox: Optional[dict] = None, **kwargs):
        if (loss_bbox or {}).get('type') != 'KFLoss':
            loss_bbox = dict(type='KFLoss', loss_weight=5.0)
        super().__init__(*args, loss_bbox=loss_bbox, **kwargs)

    def _reg_loss(self, anchors, box_flat, bbox_targets, bbox_weights,
                  num_pos):
        return kfiou_reg_loss(self, anchors, box_flat, bbox_targets,
                              bbox_weights, num_pos)


@HEADS.register_module()
class KFIoURRetinaRefineHead(KFIoURefineMixin, RefineHeadMixin,
                             KFIoURRetinaHead):
    """R3Det's refine stage with the KFIoU loss."""


@HEADS.register_module()
class ODMRefineHead(RefineHeadMixin, AnchorHead):
    """S2ANet's ODM head (reference ``odm_refine_head.py:12-223``):
    ``or_conv`` (:class:`ORConv2d`, ``feat_channels / 8`` filters in 8
    orientations) gives orientation-sensitive features; the class tower
    starts from their rotation-invariant pooling (``feat_channels / 8``
    channels), the regression tower from the features themselves. Outputs
    ``odm_cls`` (C logits) and ``odm_reg`` (5 deltas) a location."""

    def __init__(self, num_classes: int = 15, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 2,
                 anchor_generator: Optional[dict] = None,
                 bbox_coder: Optional[dict] = None,
                 loss_cls: Optional[dict] = None,
                 loss_bbox: Optional[dict] = None,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None,
                 norm_cfg: Optional[dict] = None,
                 init_cfg: Optional[dict] = None):
        super().__init__(num_classes, anchor_generator, bbox_coder,
                         loss_cls, loss_bbox, train_cfg=train_cfg,
                         test_cfg=test_cfg)
        pooled = feat_channels // 8
        self.or_conv = ORConv2d(in_channels, pooled, in_orientations=1,
                                num_orientations=8)
        self.cls_convs = nn.ModuleList(
            ConvModule(pooled if i == 0 else feat_channels, feat_channels, 3,
                       padding=1, relu=True)
            for i in range(stacked_convs))
        self.reg_convs = nn.ModuleList(
            ConvModule(feat_channels, feat_channels, 3, padding=1, relu=True)
            for i in range(stacked_convs))
        self.odm_cls = nn.Conv2d(feat_channels if stacked_convs else pooled,
                                 num_classes, 3, padding=1)
        self.odm_reg = nn.Conv2d(feat_channels, 5, 3, padding=1)

    @torch.no_grad()
    def init_cls_prior(self):
        """Focal-loss prior bias on ``odm_cls``."""
        self.odm_cls.bias.fill_(-math.log((1 - 0.01) / 0.01))

    def forward(self, feats):
        cls_scores, bbox_preds = [], []
        for x in feats:
            or_feat = self.or_conv(x)
            cls_feat = rotation_invariant_pooling(or_feat, 8)
            for conv in self.cls_convs:
                cls_feat = conv(cls_feat)
            reg_feat = or_feat
            for conv in self.reg_convs:
                reg_feat = conv(reg_feat)
            cls_scores.append(self.odm_cls(cls_feat))
            bbox_preds.append(self.odm_reg(reg_feat))
        return tuple(cls_scores), tuple(bbox_preds)


@HEADS.register_module()
class KFIoUODMRefineHead(KFIoURefineMixin, ODMRefineHead):
    """S2ANet's ODM head with the KFIoU loss."""
