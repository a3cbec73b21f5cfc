"""Gliding Vertex and RoI Transformer RoI heads (counterpart of
``orientedobjectdetection_tpu/models/roi_heads/gv_trans_heads.py``;
reference ``roi_heads/gv_ratio_roi_head.py``,
``bbox_heads/gv_bbox_head.py:17`` and ``roi_heads/roi_trans_roi_head.py``).

Both take the horizontal proposals of :class:`RotatedRPNHead` and pool
them as theta-0 rotated boxes through the RoIAlign kernel when serving (the
gather formulation under autograd in training, as the JAX package).

- Gliding Vertex: one RoI stage whose head has four branches: class
  logits, 4-parameter box deltas, the four gliding offsets of the vertices
  along the box's edges and the rectangularity ratio. The decode is the
  box, then its gliding polygon, then ``poly2obb``; a RoI whose ratio is
  above ``ratio_thr`` keeps its horizontal box.
- RoI Transformer: stage 0 regresses rotated boxes from the horizontal
  RoIs; stage 1 pools those rotated RoIs and refines them. Serving pools
  twice, so it launches the RoIAlign kernel twice a request, each stage
  inside its own ``two_stage.roialign_head_{i}`` profiler range.

Sampling is :func:`.oriented_roi_head.sample_roi_set`: static shapes, one
batched assignment (one IoU-matrix launch) a stage, no host round trip.
The sampling keys follow the JAX package's splits: ``split(rng, B)`` per
image, and for RoI Transformer first ``split(rng, num_stages)``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from ...ops.boxes import obb2hbb, obb2xyxy, poly2obb
from ...utils.registry import BBOX_CODERS, HEADS, LOSSES
from .oriented_roi_head import (build_max_iou_assigner, nms_from_cfg,
                                pool_rois, sample_roi_set)

_STRIDES = (4, 8, 16, 32)


def hbb_to_rot(hbbs: torch.Tensor) -> torch.Tensor:
    """(..., 4) xyxy -> (..., 5) theta-0 rotated boxes, w and h not clipped
    (JAX ``hbb_to_rot``)."""
    x1, y1, x2, y2 = hbbs.unbind(-1)
    return torch.stack([(x1 + x2) * 0.5, (y1 + y2) * 0.5, x2 - x1, y2 - y1,
                        torch.zeros_like(x1)], -1)


def sample_hbb_rois(assigner, proposals_xyxy, pvalid, gt_bboxes, gt_labels,
                    gt_mask, key, num: int, pos_fraction: float,
                    num_classes: int, version: str, add_gt: bool = True):
    """Horizontal proposals (B, N, 4) -> a sampled RoI set: the gts'
    circumscribed xyxy boxes come first among the proposals, and the
    assignment compares the theta-0 proposals with the gts' circumscribed
    horizontal boxes (``obb2hbb``). Returns :func:`sample_roi_set`'s
    (rois (B, num, 4) xyxy, labels, label weights, matched rotated gts,
    positives)."""
    gt_hbb = obb2hbb(gt_bboxes, version)
    return sample_roi_set(
        lambda boxes: assigner(hbb_to_rot(boxes), gt_hbb, gt_labels,
                               gt_mask),
        proposals_xyxy, pvalid, obb2xyxy(gt_bboxes, version), gt_bboxes,
        gt_labels, gt_mask, key, num, pos_fraction, num_classes, add_gt)


@HEADS.register_module()
class GVBBoxHead(nn.Module):
    """mmrotate names ``shared_fcs.{0,1}``, ``fc_cls`` (C+1), ``fc_reg``
    (4), ``fc_fix`` (4, sigmoid) and ``fc_ratio`` (1, sigmoid). The coder
    and loss options of the config are accepted and not read: the JAX
    head's losses are fixed (:meth:`GVRatioRoIHead.loss`)."""

    def __init__(self, num_classes: int = 15, in_channels: int = 256,
                 fc_out_channels: int = 1024, roi_feat_size: int = 7,
                 reg_class_agnostic: bool = True, ratio_thr: float = 0.8,
                 version: str = 'le90', bbox_coder: Optional[dict] = None,
                 fix_coder: Optional[dict] = None,
                 ratio_coder: Optional[dict] = None,
                 loss_cls: Optional[dict] = None,
                 loss_bbox: Optional[dict] = None,
                 loss_fix: Optional[dict] = None,
                 loss_ratio: Optional[dict] = None,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None,
                 init_cfg: Optional[dict] = None):
        super().__init__()
        self.num_classes = num_classes
        self.ratio_thr = ratio_thr
        flat = roi_feat_size * roi_feat_size * in_channels
        self.shared_fcs = nn.ModuleList(
            nn.Linear(flat if i == 0 else fc_out_channels, fc_out_channels)
            for i in range(2))
        self.fc_cls = nn.Linear(fc_out_channels, num_classes + 1)
        self.fc_reg = nn.Linear(fc_out_channels, 4)
        self.fc_fix = nn.Linear(fc_out_channels, 4)
        self.fc_ratio = nn.Linear(fc_out_channels, 1)

    def forward(self, roi_feats: torch.Tensor):
        """roi_feats (B, R, 7, 7, C) -> (cls (B, R, C+1), box deltas
        (B, R, 4), gliding offsets (B, R, 4), ratio (B, R, 1))."""
        x = roi_feats.flatten(2)
        for fc in self.shared_fcs:
            x = F.relu(fc(x))
        return (self.fc_cls(x), self.fc_reg(x), torch.sigmoid(self.fc_fix(x)),
                torch.sigmoid(self.fc_ratio(x)))


@HEADS.register_module()
class GVRatioRoIHead(nn.Module):
    """Gliding Vertex's RoI head. ``train_cfg`` holds the ``assigner``
    (default IoU 0.5 / 0.5 / 0.5 without low-quality matches) and the
    ``sampler`` (512 at 0.25, gts added as proposals). The ``roi_layer``'s
    ``sample_num`` is not read: it pools 7x7 bins with 2x2 samples, as the
    JAX package."""

    def __init__(self, bbox_roi_extractor: Optional[dict] = None,
                 bbox_head: Optional[dict] = None,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None,
                 version: str = 'le90',
                 init_cfg: Optional[dict] = None):
        super().__init__()
        self.train_cfg = train_cfg or {}
        self.test_cfg = test_cfg or {}
        self.version = version
        self.strides = tuple((bbox_roi_extractor or {}).get(
            'featmap_strides', _STRIDES))
        self.assigner = build_max_iou_assigner(self.train_cfg.get('assigner'))
        head = dict(bbox_head or dict(type='GVBBoxHead'))
        if head.get('train_cfg') is None:
            head['train_cfg'] = train_cfg
        if head.get('test_cfg') is None:
            head['test_cfg'] = test_cfg
        self.bbox_head = HEADS.build(head)
        self.hbb_coder = BBOX_CODERS.build(dict(
            type='DeltaXYWHBBoxCoder', target_stds=(0.1, 0.1, 0.2, 0.2)))
        self.fix_coder = BBOX_CODERS.build(dict(type='GVFixCoder',
                                                angle_range=version))
        self.ratio_coder = BBOX_CODERS.build(dict(type='GVRatioCoder',
                                                  angle_range=version))
        self.cls_loss = LOSSES.build(dict(type='CrossEntropyLoss'))
        self.smooth_l1 = LOSSES.build(dict(type='SmoothL1Loss', beta=1.0))

    @property
    def assigners(self) -> list:
        return [self.assigner]

    def pool(self, feats, rois_xyxy: torch.Tensor,
             plain_roi_align: bool = False,
             train: bool = False) -> torch.Tensor:
        """xyxy RoIs (B, R, 4) pooled as theta-0 boxes (:func:`pool_rois`)."""
        return pool_rois(feats, hbb_to_rot(rois_xyxy), self.strides,
                         plain_roi_align=plain_roi_align, train=train)

    def forward(self, feats, rois_xyxy: torch.Tensor,
                plain_roi_align: bool = False):
        """NCHW levels and xyxy proposals (B, R, 4) -> the head's four
        outputs on the serving path's pooling."""
        return self.bbox_head(self.pool(feats, rois_xyxy, plain_roi_align))

    @torch.no_grad()
    def sample_rois(self, proposals, prop_valid, gt_bboxes, gt_labels,
                    gt_mask, rng):
        """-> (rois (B, num, 4) xyxy, labels, label weights, box deltas,
        gliding offsets, ratios, box weights, positives of the batch (at
        least 1)); the three regression targets are 0 off the positives."""
        cfg = self.train_cfg.get('sampler') or {}
        gt_bboxes = gt_bboxes.float()
        rois, labels, lw, matched, pos = sample_hbb_rois(
            self.assigner, proposals.float(), prop_valid, gt_bboxes,
            gt_labels, gt_mask, rng.split(proposals.shape[0]),
            int(cfg.get('num', 512)), float(cfg.get('pos_fraction', 0.25)),
            self.bbox_head.num_classes, self.version,
            bool(cfg.get('add_gt_as_proposals', True)))
        bt = self.hbb_coder.encode(rois, obb2xyxy(matched, self.version))
        fix_t = self.fix_coder.encode(matched)
        ratio_t = self.ratio_coder.encode(matched)
        on = pos[..., None]
        bw = pos.float()
        return (rois, labels, lw, torch.where(on, bt, 0.0),
                torch.where(on, fix_t, 0.0), torch.where(on, ratio_t, 0.0),
                bw, bw.sum().clamp(min=1.0))

    def loss(self, head_outputs, targets) -> dict:
        """Softmax cross entropy over the sampled RoIs; smooth L1 (beta 1)
        on the box deltas, the gliding offsets and the ratio (the last x
        16) over the positives. The config's loss dicts are not read, as
        in the JAX package."""
        cls_score, bbox_pred, fix_pred, ratio_pred = head_outputs
        _, labels, lw, bt, fix_t, ratio_t, bw, _ = targets
        num_pos = bw.sum().clamp(min=1.0)          # the gathered batch's
        loss_cls = self.cls_loss(cls_score.float(), labels, weight=lw,
                                 avg_factor=lw.sum().clamp(min=1.0))
        return dict(
            loss_cls=loss_cls,
            loss_bbox=self.smooth_l1(bbox_pred.float(), bt, weight=bw,
                                     avg_factor=num_pos),
            loss_fix=self.smooth_l1(fix_pred.float(), fix_t, weight=bw,
                                    avg_factor=num_pos),
            loss_ratio=self.smooth_l1(ratio_pred.float(), ratio_t,
                                      weight=bw, avg_factor=num_pos) * 16.0)

    def decode(self, rois_xyxy, head_outputs, img_shape=None):
        """The rotated boxes (B, R, 5) and softmax scores (B, R, C+1) of
        the head's outputs."""
        cls_score, bbox_pred, fix_pred, ratio_pred = (
            t.float() for t in head_outputs)
        hbbs = self.hbb_coder.decode(rois_xyxy, bbox_pred,
                                     max_shape=img_shape)
        obbs = poly2obb(self.fix_coder.decode(hbbs, fix_pred), self.version)
        rect = ratio_pred > self.bbox_head.ratio_thr
        return (torch.where(rect, hbb_to_rot(hbbs), obbs),
                torch.softmax(cls_score, -1))

    def get_bboxes(self, rois_xyxy, head_outputs, cfg=None, img_shape=None,
                   plain_pair_mask: bool = False):
        """Decode (:meth:`decode`) and multiclass rotated NMS. Returns
        (dets (B, max_per_img, 6), labels, valid)."""
        cfg = cfg if cfg is not None else self.test_cfg
        boxes, scores = self.decode(rois_xyxy, head_outputs, img_shape)
        return nms_from_cfg(boxes, scores, cfg, plain_pair_mask)


@HEADS.register_module()
class RoITransRoIHead(nn.Module):
    """RoI Transformer's cascade: ``bbox_head`` is a list of stage heads
    (``roi_head.bbox_head.{i}``), ``train_cfg`` a list of stage configs
    (``assigner``, ``sampler``), ``bbox_roi_extractor`` a list whose
    ``featmap_strides`` each stage pools with. Every stage pools 7x7 bins
    with 2x2 samples, ``clockwise=False`` (the config's
    ``clockwise=True`` is not read, as in the JAX package). Stage 0 takes
    the horizontal proposals as theta-0 boxes; each next stage the rotated
    boxes the previous one decodes, class-agnostically, without a
    gradient."""

    def __init__(self, num_stages: int = 2,
                 stage_loss_weights: Sequence[float] = (1.0, 1.0),
                 bbox_roi_extractor=None, bbox_head=None, train_cfg=None,
                 test_cfg: Optional[dict] = None, version: str = 'le90',
                 init_cfg: Optional[dict] = None):
        super().__init__()
        self.num_stages = num_stages
        self.stage_loss_weights = tuple(stage_loss_weights)
        self.version = version
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg or {}
        heads = bbox_head or [
            dict(type='RotatedShared2FCBBoxHead',
                 bbox_coder=dict(type='DeltaXYWHAHBBoxCoder',
                                 angle_range=version)),
            dict(type='RotatedShared2FCBBoxHead',
                 bbox_coder=dict(type='DeltaXYWHAOBBoxCoder',
                                 angle_range=version))]
        built = []
        for i in range(num_stages):
            cfg = dict(heads[i])
            if cfg.get('test_cfg') is None:
                cfg['test_cfg'] = self.test_cfg
            built.append(HEADS.build(cfg))
        self.bbox_head = nn.ModuleList(built)
        extractors = bbox_roi_extractor
        self.strides = [
            tuple(extractors[i].get('featmap_strides', _STRIDES))
            if isinstance(extractors, (list, tuple)) and i < len(extractors)
            else _STRIDES for i in range(num_stages)]
        self.assigners = [build_max_iou_assigner(self.stage_cfg(i).get(
            'assigner')) for i in range(num_stages)]

    def stage_cfg(self, i: int) -> dict:
        if isinstance(self.train_cfg, (list, tuple)):
            return self.train_cfg[i] if i < len(self.train_cfg) else {}
        return self.train_cfg or {}

    def forward(self, feats, proposals_xyxy: torch.Tensor,
                plain_roi_align: bool = False) -> dict:
        """Serving: NCHW levels and xyxy proposals (B, R, 4) through every
        stage -> ``dict(rois (B, R, 5), cls_score, bbox_pred)``: the last
        stage's RoIs and outputs."""
        rois = hbb_to_rot(proposals_xyxy)
        for i, head in enumerate(self.bbox_head):
            with record_function(f'two_stage.roialign_head_{i}'):
                cls_score, bbox_pred = head(pool_rois(
                    feats, rois, self.strides[i],
                    plain_roi_align=plain_roi_align))
                if i + 1 < self.num_stages:
                    rois = head.decode_bboxes(rois, bbox_pred.float())
        return dict(rois=rois, cls_score=cls_score, bbox_pred=bbox_pred)

    def forward_train(self, feats, proposals_xyxy, batch, rng) -> list:
        """Training: each stage samples its RoIs (stage 0 from the
        proposals, all of them taken as valid, as the JAX package does;
        stage 1 from the RoIs stage 0 refined), pools them with the gather
        formulation and runs its head. Returns one dict a stage: ``rois,
        labels, lw, bt, bw, num_pos, cls_score, bbox_pred``."""
        gts = batch['gt_bboxes'].float()
        gt_labels, gt_mask = batch['gt_labels'], batch['gt_mask']
        bsz = proposals_xyxy.shape[0]
        stage_data, rois = [], None
        for i, head in enumerate(self.bbox_head):
            cfg = self.stage_cfg(i).get('sampler') or {}
            num = int(cfg.get('num', 512))
            fraction = float(cfg.get('pos_fraction', 0.25))
            key = rng.split(self.num_stages, i).split(bsz)
            with record_function(f'two_stage.sample_rois_{i}'), \
                    torch.no_grad():
                if i == 0:
                    props = proposals_xyxy.float()
                    sampled = sample_hbb_rois(
                        self.assigners[0], props,
                        torch.ones(props.shape[:2], dtype=torch.bool,
                                   device=props.device),
                        gts, gt_labels, gt_mask, key, num, fraction,
                        head.num_classes, self.version)
                    rois = hbb_to_rot(sampled[0])
                else:
                    assigner = self.assigners[i]
                    sampled = sample_roi_set(
                        lambda boxes: assigner(boxes, gts, gt_labels,
                                               gt_mask),
                        rois, torch.ones(rois.shape[:2], dtype=torch.bool,
                                         device=rois.device),
                        gts, gts, gt_labels, gt_mask, key, num, fraction,
                        head.num_classes)
                    rois = sampled[0]
                _, labels, lw, matched, pos = sampled
                bt = torch.where(pos[..., None],
                                 head.coder.encode(rois, matched), 0.0)
            with record_function(f'two_stage.roi_pool_{i}'):
                pooled = pool_rois(feats, rois, self.strides[i], train=True)
            cls_score, bbox_pred = head(pooled)
            bw = pos.float()
            stage_data.append(dict(
                rois=rois, labels=labels, lw=lw, bt=bt, bw=bw,
                num_pos=bw.sum().clamp(min=1.0), cls_score=cls_score,
                bbox_pred=bbox_pred))
            if i + 1 < self.num_stages:
                with torch.no_grad():
                    rois = head.decode_bboxes(rois, bbox_pred.float())
        return stage_data

    def loss(self, stage_data) -> dict:
        """Each stage's head losses, ``s{i}_loss_cls`` and
        ``s{i}_loss_bbox``, times its ``stage_loss_weights``; each stage's
        count of positives from its box weights (the whole batch's when a
        data-parallel step gathers them)."""
        losses = {}
        for i, (head, d) in enumerate(zip(self.bbox_head, stage_data)):
            parts = head.loss(d['cls_score'], d['bbox_pred'], d['rois'],
                              d['labels'], d['lw'], d['bt'], d['bw'],
                              d['bw'].sum().clamp(min=1.0))
            w = float(self.stage_loss_weights[i]) \
                if i < len(self.stage_loss_weights) else 1.0
            losses.update({f's{i}_{k}': v * w for k, v in parts.items()})
        return losses

    def get_bboxes(self, outputs, cfg=None, img_shape=None,
                   plain_pair_mask: bool = False):
        """The last stage's softmax scores and decoded boxes, multiclass
        rotated NMS. Returns (dets (B, max_per_img, 6), labels, valid)."""
        cfg = cfg if cfg is not None else self.test_cfg
        head = self.bbox_head[-1]
        scores = torch.softmax(outputs['cls_score'].float(), -1)
        decoded = head.decode_bboxes(outputs['rois'],
                                     outputs['bbox_pred'].float(), img_shape)
        if decoded.dim() == 4:                 # (B, R, C, 5) -> (B, R, C*5)
            decoded = decoded.flatten(2)
        return nms_from_cfg(decoded, scores, cfg, plain_pair_mask)
