"""Rotated RetinaNet heads: towers, batched targets and loss, batched decode
(counterpart of
``orientedobjectdetection_tpu/models/dense_heads/rotated_anchor_head.py``:
``RotatedRetinaHead`` and ``AnchorHeadLogic``, here ``AnchorHead``, with
``filter_bboxes``, and the variants ``KFIoURRetinaHead``,
``RotatedATSSHead`` and ``CSLRRetinaHead``).

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
from torch.profiler import record_function

from ...core.anchors import cached
from ...ops.nms import multiclass_nms_rotated, topk_candidates
from ...utils.registry import (BBOX_ASSIGNERS, BBOX_CODERS, HEADS, LOSSES,
                               PRIOR_GENERATORS)
from ..blocks import ConvModule


def batched(anchors: torch.Tensor) -> torch.Tensor:
    """Anchors shared by the batch (N, 5) or per image (B, N, 5) -> a shape
    that broadcasts against (B, N, 5)."""
    return anchors if anchors.dim() == 3 else anchors[None]


def flatten_levels(maps, width: int) -> torch.Tensor:
    """Per-level NCHW maps -> (B, N, width) in the anchors' order:
    location-major, channel ``a * width + e`` at each location."""
    b = maps[0].shape[0]
    return torch.cat([m.permute(0, 2, 3, 1).reshape(b, -1, width)
                      for m in maps], 1)


def check_exact_topk(cfg: dict) -> None:
    """``cfg['approx_topk']``: the JAX package's switch to an approximate
    top-k (``approx_max_k``), which the port does not have; true raises
    ValueError, false or absent runs the exact top-k."""
    if cfg.get('approx_topk', False):
        raise ValueError('test_cfg.approx_topk=True asks for an '
                         'approximate top-k, which the port does not '
                         'have; set it False for the exact top-k')


class AnchorHead(nn.Module):
    """What the anchor heads share besides their layers: anchors, batched
    targets and loss, decode. ``loss_cls`` / ``loss_bbox`` and
    ``train_cfg['assigner']`` are built once, here; a head built without
    them serves but cannot compute a loss. ``assign_by_circumhbbox`` (an
    angle-version string) switches the assigner to the gts' circumscribed
    horizontal boxes, as the reference head option does
    (``rotated_anchor_head.py:231-239``)."""

    def __init__(self, num_classes: int,
                 anchor_generator: dict, bbox_coder: dict,
                 loss_cls: Optional[dict] = None,
                 loss_bbox: Optional[dict] = None,
                 assign_by_circumhbbox: Optional[str] = None,
                 reg_decoded_bbox: bool = False,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None):
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
            self.assigner = self.build_assigner(dict(train_cfg['assigner']))
        self.prior_generator = PRIOR_GENERATORS.build(dict(anchor_generator))
        self.coder = BBOX_CODERS.build(dict(bbox_coder))
        self.num_anchors = self.prior_generator.num_base_anchors[0]
        self._anchor_cache: Dict[tuple, Sequence[torch.Tensor]] = {}

    def build_assigner(self, cfg: dict):
        """The assigner of ``train_cfg['assigner']``, on the gts'
        circumscribed boxes when the head asks for it."""
        if self.assign_by_circumhbbox is not None:
            cfg['assign_by_circumhbbox'] = self.assign_by_circumhbbox
        return BBOX_ASSIGNERS.build(cfg)

    @property
    def cls_out_channels(self) -> int:
        return self.num_classes      # sigmoid classifier

    def anchors(self, featmap_sizes, device) -> Sequence[torch.Tensor]:
        key = (tuple(tuple(s) for s in featmap_sizes), str(device))
        return cached(self._anchor_cache, key,
                      lambda: self.prior_generator.grid_priors(
                          featmap_sizes, device=device))

    def flat_anchors(self, featmap_sizes, device) -> torch.Tensor:
        """(N, 5) anchors concatenated over levels, the same for every
        image."""
        key = (tuple(tuple(s) for s in featmap_sizes), str(device), 'flat')
        return cached(self._anchor_cache, key, lambda: torch.cat(
            list(self.anchors(featmap_sizes, device)), 0))

    # ---- targets and loss (batched) -------------------------------------
    def _assign(self, anchors, featmap_sizes, gt_bboxes, gt_labels, gt_mask,
                gt_ignore=None, gt_ignore_mask=None):
        """The assigner's result for (N, 5) anchors and the padded gts.
        ``gt_ignore`` / ``gt_ignore_mask`` (padded ignore regions) reach the
        assigner when its ``ignore_iof_thr`` is set."""
        if gt_ignore is not None and self.assigner.ignore_iof_thr > 0:
            return self.assigner(anchors, gt_bboxes, gt_labels, gt_mask,
                                 gt_bboxes_ignore=gt_ignore,
                                 gt_ignore_mask=gt_ignore_mask)
        return self.assigner(anchors, gt_bboxes, gt_labels, gt_mask)

    @torch.no_grad()
    def _targets(self, anchors, gt_bboxes, assign):
        """anchors (N, 5) shared by the batch or (B, N, 5) per image, padded
        gts (B, G, 5) and their assignment -> per-anchor labels (B, N),
        label weights, box targets (B, N, E), box weights and the positive
        mask."""
        pos = assign.assigned_gt_inds >= 0
        neg = assign.assigned_gt_inds == -1
        safe_idx = assign.assigned_gt_inds.clamp(min=0)
        matched_gt = gt_bboxes.gather(
            1, safe_idx[..., None].expand(-1, -1, gt_bboxes.shape[-1]))
        bbox_targets = self.coder.encode(batched(anchors), matched_gt)
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
        return (flatten_levels(cls_scores, self.cls_out_channels).float(),
                flatten_levels(bbox_preds, self.coder.encode_size).float())

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
        return self._loss(outputs, gt_bboxes, gt_labels, gt_mask,
                          gt_ignore, gt_ignore_mask)[0]

    def _loss(self, outputs, gt_bboxes, gt_labels, gt_mask,
              gt_ignore=None, gt_ignore_mask=None, anchors=None):
        """The losses, and the targets and positive count they came from
        (a subclass adds a term on the same targets). ``anchors``: (B, N,
        5) per image in place of the grid's (a refine stage's)."""
        if self.assigner is None or self.cls_loss is None or \
                self.bbox_loss is None:
            raise RuntimeError('the head was built without loss_cls, '
                               'loss_bbox or train_cfg.assigner')
        cls_scores, bbox_preds = outputs[0], outputs[1]
        featmap_sizes = [tuple(s.shape[-2:]) for s in cls_scores]
        if anchors is None:
            anchors = self.flat_anchors(featmap_sizes, cls_scores[0].device)
        gt_bboxes = gt_bboxes.float()
        assign = self._assign(anchors, featmap_sizes, gt_bboxes, gt_labels,
                              gt_mask, gt_ignore, gt_ignore_mask)
        targets = self._targets(anchors, gt_bboxes, assign)
        labels, label_weights, bbox_targets, bbox_weights, pos = targets
        cls_flat, box_flat = self._flatten_preds(cls_scores, bbox_preds)
        # batch-wide positive count, at least 1 (reference
        # rotated_anchor_head.py:455-459)
        num_pos = pos.sum().float().clamp(min=1.0)
        loss_cls = self.cls_loss(cls_flat, labels, weight=label_weights,
                                 avg_factor=num_pos)
        loss_bbox = self._reg_loss(anchors, box_flat, bbox_targets,
                                   bbox_weights, num_pos)
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox), targets, num_pos

    def _reg_loss(self, anchors, box_flat, bbox_targets, bbox_weights,
                  num_pos):
        """Regression loss with mmdet's ``reg_decoded_bbox`` option: when
        set, predictions and targets are decoded first and the loss
        compares boxes instead of deltas."""
        if self.reg_decoded_bbox:
            decoded = self.coder.decode(batched(anchors), box_flat)
            target_boxes = self.coder.decode(batched(anchors), bbox_targets)
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

        ``cfg['approx_topk']`` true raises ValueError
        (:func:`check_exact_topk`).
        """
        cfg = cfg if cfg is not None else self.test_cfg
        check_exact_topk(cfg)
        nms_pre = int(cfg.get('nms_pre', 1000))
        cls_scores, bbox_preds = outputs[0], outputs[1]
        featmap_sizes = [tuple(s.shape[-2:]) for s in cls_scores]
        level_anchors = self.anchors(featmap_sizes, cls_scores[0].device)
        c_n, e_n = self.cls_out_channels, self.coder.encode_size
        cand_boxes, cand_scores = [], []
        for lvl, (scores, deltas, anchors) in enumerate(
                zip(cls_scores, bbox_preds, level_anchors)):
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
            sel_deltas = self._candidate_deltas(outputs, lvl, idx,
                                                sel_deltas)
            sel_anchors = anchors[idx]                         # (B, k, 5)
            cand_scores.append(torch.sigmoid(sel_logits))
            cand_boxes.append(self.coder.decode(sel_anchors, sel_deltas,
                                                max_shape=img_shape))
        return torch.cat(cand_boxes, 1), torch.cat(cand_scores, 1)

    def _candidate_deltas(self, outputs, lvl, idx, sel_deltas):
        """The selected candidates' (B, k, E) float32 deltas of level
        ``lvl``, before decoding (the CSL head replaces the angle)."""
        return sel_deltas

    def get_bboxes(self, outputs, img_shape=None, scale_factor=None,
                   rescale: bool = False, cfg=None,
                   plain_pair_mask: bool = False):
        """Batched decode + multiclass rotated NMS. Returns
        (dets (B, max_per_img, 6), labels (B, max_per_img), valid).

        ``rescale`` with a ``scale_factor`` (w, h, ...) divides the decoded
        centres and sizes by (w, h, w, h) before NMS, one factor for the
        batch, as the JAX head does. ``plain_pair_mask`` runs NMS with the
        pair-mask kernel's plain version."""
        cfg = cfg if cfg is not None else self.test_cfg
        boxes, scores = self.candidates(outputs, img_shape, cfg)
        if rescale and scale_factor is not None:
            sf = boxes.new_tensor(scale_factor)[:2].repeat(2)
            boxes = torch.cat([boxes[..., :4] / sf, boxes[..., 4:]], -1)
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


    def filter_bboxes(self, cls_scores, bbox_preds) -> list:
        """R3Det's first-stage rois (reference ``rotated_retina_head.py
        :122-180``): at each location the anchor of the highest class logit
        (max over classes, then the first argmax over anchors), decoded in
        float32 against the head's anchors. Returns per-level (B, H*W, 5)
        boxes."""
        featmap_sizes = [tuple(s.shape[-2:]) for s in cls_scores]
        level_anchors = self.anchors(featmap_sizes, cls_scores[0].device)
        a_n, c_n = self.num_anchors, self.cls_out_channels
        rois = []
        for scores, deltas, anchors in zip(cls_scores, bbox_preds,
                                           level_anchors):
            b, _, h, w = scores.shape
            d = deltas.permute(0, 2, 3, 1).reshape(b, h * w, a_n, 5)
            a = anchors.reshape(h * w, a_n, 5)
            if a_n == 1:
                best_deltas, best_anchors = d[:, :, 0], a[None, :, 0]
            else:
                s = scores.permute(0, 2, 3, 1).reshape(b, h * w, a_n, c_n)
                best = s.amax(-1).argmax(-1)                   # (B, h*w)
                best_deltas = d.gather(2, best[..., None, None].expand(
                    -1, -1, 1, 5))[:, :, 0]
                best_anchors = a[torch.arange(h * w, device=best.device),
                                 best]
            rois.append(self.coder.decode(best_anchors, best_deltas.float()))
        return rois


@HEADS.register_module()
class RotatedRetinaHead(AnchorHead):
    """RetinaNet head: ``stacked_convs`` 3x3 convs per tower, then A*C
    class logits (``retina_cls``) and A*5 box deltas (``retina_reg``)."""

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
        super().__init__(num_classes, anchor_generator, bbox_coder,
                         loss_cls, loss_bbox, assign_by_circumhbbox,
                         reg_decoded_bbox, train_cfg, test_cfg)
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

    @torch.no_grad()
    def init_cls_prior(self):
        """Focal-loss prior bias on ``retina_cls``: every score starts near
        0.01."""
        self.retina_cls.bias.fill_(-math.log((1 - 0.01) / 0.01))

    def towers(self, x):
        """One level's class and regression tower features."""
        c = x
        for conv in self.cls_convs:
            c = conv(c)
        r = x
        for conv in self.reg_convs:
            r = conv(r)
        return c, r

    def forward(self, feats):
        cls_scores, bbox_preds = [], []
        for x in feats:
            c, r = self.towers(x)
            cls_scores.append(self.retina_cls(c))
            bbox_preds.append(self.retina_reg(r))
        return tuple(cls_scores), tuple(bbox_preds)


def kfiou_reg_loss(head, anchors, box_flat, bbox_targets, bbox_weights,
                   num_pos):
    """``KFLoss`` on the encoded deltas and, decoded against the anchors
    (shared or per image), the predicted and the target boxes."""
    anchors = batched(anchors)
    return head.bbox_loss(
        box_flat, bbox_targets, weight=bbox_weights, avg_factor=num_pos,
        pred_decode=head.coder.decode(anchors, box_flat),
        targets_decode=head.coder.decode(anchors, bbox_targets))


@HEADS.register_module()
class KFIoURRetinaHead(RotatedRetinaHead):
    """RetinaNet head with the KFIoU loss (reference
    ``dense_heads/kfiou_rotate_retina_head.py``): ``KFLoss`` takes the
    encoded deltas and, decoded against the anchors, the predicted and the
    target boxes."""

    def _reg_loss(self, anchors, box_flat, bbox_targets, bbox_weights,
                  num_pos):
        return kfiou_reg_loss(self, anchors, box_flat, bbox_targets,
                              bbox_weights, num_pos)


@HEADS.register_module()
class RotatedATSSHead(RotatedRetinaHead):
    """ATSS-assigned RetinaNet head (reference
    ``rotated_atss_head.py:12-234``): the RetinaNet towers, with
    ``ATSSObbAssigner`` given the anchors' count per level. It takes no
    ignore regions, as in the JAX package. Its assigner is built from
    ``train_cfg['assigner']`` alone: the head's ``assign_by_circumhbbox``
    is not read (JAX ``rotated_anchor_head.py:401-406``)."""

    def build_assigner(self, cfg: dict):
        return BBOX_ASSIGNERS.build(cfg)

    def loss(self, outputs, gt_bboxes, gt_labels, gt_mask):
        return self._loss(outputs, gt_bboxes, gt_labels, gt_mask)[0]

    def _assign(self, anchors, featmap_sizes, gt_bboxes, gt_labels, gt_mask,
                gt_ignore=None, gt_ignore_mask=None):
        num_level = [h * w * self.num_anchors for h, w in featmap_sizes]
        return self.assigner(anchors, num_level, gt_bboxes, gt_labels,
                             gt_mask)


@HEADS.register_module()
class CSLRRetinaHead(RotatedRetinaHead):
    """RetinaNet head with a Circular Smooth Label angle branch (reference
    ``csl_rotated_retina_head.py``): ``retina_angle_cls``, a 3x3 conv on
    the regression tower with ``A * coding_len`` outputs, learns the bins
    of the bbox coder's encoded delta angle with ``loss_angle``
    (``SmoothFocalLoss``). Decoding writes each candidate's argmax angle
    into the 5th delta before the bbox coder. Training the branch on the
    raw gt angle instead is the bug ``RESULTS.md`` "CSL" records: the
    coder's edge swap then pairs swapped extents with unswapped angles.
    ``forward`` returns (cls_scores, bbox_preds, angle_clses). It takes no
    ignore regions, as in the JAX package. The angle loss carries a
    ``torch.profiler`` range, ``csl.angle_loss``."""

    def __init__(self, *args, angle_coder: Optional[dict] = None,
                 loss_angle: Optional[dict] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.angle_coder = BBOX_CODERS.build(dict(
            angle_coder or dict(type='CSLCoder', angle_version='le90',
                                omega=1, window='gaussian', radius=6)))
        self.angle_loss = LOSSES.build(dict(
            loss_angle or dict(type='SmoothFocalLoss', gamma=2.0,
                               alpha=0.25, loss_weight=0.8)))
        self.retina_angle_cls = nn.Conv2d(
            self.retina_reg.in_channels,
            self.num_anchors * self.angle_coder.coding_len, 3, padding=1)

    @torch.no_grad()
    def init_cls_prior(self):
        """The focal prior bias on ``retina_cls`` and on
        ``retina_angle_cls``."""
        super().init_cls_prior()
        self.retina_angle_cls.bias.fill_(-math.log((1 - 0.01) / 0.01))

    def forward(self, feats):
        cls_scores, bbox_preds, angle_clses = [], [], []
        for x in feats:
            c, r = self.towers(x)
            cls_scores.append(self.retina_cls(c))
            bbox_preds.append(self.retina_reg(r))
            angle_clses.append(self.retina_angle_cls(r))
        return tuple(cls_scores), tuple(bbox_preds), tuple(angle_clses)

    def loss(self, outputs, gt_bboxes, gt_labels, gt_mask):
        losses, targets, num_pos = self._loss(outputs, gt_bboxes, gt_labels,
                                              gt_mask)
        _, _, bbox_targets, bbox_weights, pos = targets
        b, length = outputs[0][0].shape[0], self.angle_coder.coding_len
        with record_function('csl.angle_loss'):
            ang_flat = torch.cat([
                a.permute(0, 2, 3, 1).reshape(b, -1, length)
                for a in outputs[2]], 1).float()
            with torch.no_grad():
                encoded = self.angle_coder.encode(bbox_targets[..., 4:5])
                ang_targets = torch.where(pos[..., None], encoded,
                                          encoded.new_zeros(()))
            losses['loss_angle'] = self.angle_loss(
                ang_flat, ang_targets, weight=bbox_weights,
                avg_factor=num_pos)
        return losses

    def _candidate_deltas(self, outputs, lvl, idx, sel_deltas):
        ang = outputs[2][lvl]
        length = self.angle_coder.coding_len
        logits = ang.permute(0, 2, 3, 1).reshape(ang.shape[0], -1, length)
        theta = self.angle_coder.decode(
            logits.gather(1, idx[..., None].expand(-1, -1, length)).float())
        return torch.cat([sel_deltas[..., :4], theta[..., None]], -1)
