"""Oriented standard RoI head (counterpart of
``orientedobjectdetection_tpu/models/roi_heads/oriented_roi_head.py``;
reference ``roi_heads/oriented_standard_roi_head.py:10-188``). Training:
proposals and gts -> rotated max-IoU assignment -> random sampling of a
fixed number of RoIs (512 at 0.25 positives) -> RoIAlignRotated -> bbox
head loss. Test: RoIAlignRotated over all proposals -> bbox head -> decode
-> multiclass rotated NMS.

The detector's maps are NCHW; the RoIAlign op takes channels-last levels,
as the JAX package's does, so the first ``len(featmap_strides)`` levels are
permuted here.

Serving pools with the RoIAlign kernel (:func:`roi_align_rotated_pyramid`,
CUDA on the card) or, on request, its plain version; neither carries a
gradient, and both raise for features that require one. Training pools the
sampled RoIs with the gather formulation (:func:`roi_align_rotated`) under
autograd instead, whose backward scatters the gradient into the levels.
The kernel has no backward, and the JAX package trains the same way: its
RoI head pools through its gather op in training and reserves the Pallas
kernel for inference (``use_pallas=not train``).

Sampling keeps the shapes static and waits for no host round trip: the
gts come first among the proposals (``add_gt_as_proposals``), one batched
assignment gives every image's matrix in one IoU-kernel launch, and the
sampled RoIs are ordered positives first, then negatives, then padding, by
a stable sort of the sampling scores (:func:`sample_roi_set`, which the
other two-stage heads share).

ReDet's ``RiRoIAlignRotated`` layer pools in the same two ways and then
rolls each RoI's orientation channels by its angle bin
(``backbones/re_resnet.py:ri_roll``, in a ``two_stage.ri_roll`` range):
features aligned into the RoI's frame. As in the JAX package it pools with
the gather op's default ``finest_scale`` (56), not the config's.

``RotatedStandardRoIHead`` (Rotated Faster R-CNN) takes horizontal
proposals: it pools and assigns them as theta-0 rotated boxes, on the gts'
circumscribed horizontal boxes, and regresses the rotated gts.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.profiler import record_function

from ...core.assigners import (MaxIoUAssigner, NEG, masks_from_scores,
                               sample_scores)
from ...ops.boxes import obb2hbb
from ...ops.nms import multiclass_nms_rotated
from ...ops.roi_align_kernels import (roi_align_rotated_pyramid,
                                      roi_align_rotated_pyramid_plain)
from ...ops.roi_align_rotated import roi_align_rotated
from ...utils.registry import HEADS
from ..backbones.re_resnet import ri_roll


def build_max_iou_assigner(cfg: Optional[dict]) -> MaxIoUAssigner:
    """A ``MaxIoUAssigner`` from a config's ``assigner`` (the type and the
    ``iou_calculator`` dropped); by default IoU 0.5 / 0.5 / 0.5 without
    low-quality matches, the RoI stages' setting."""
    cfg = dict(cfg or dict(pos_iou_thr=0.5, neg_iou_thr=0.5,
                           min_pos_iou=0.5, match_low_quality=False))
    cfg.pop('type', None)
    cfg.pop('iou_calculator', None)
    return MaxIoUAssigner(**cfg)


def take_rows(t: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``t`` (B, N[, D]) at ``index`` (B, K) along dim 1."""
    if t.dim() == 2:
        return t.gather(1, index)
    return t.gather(1, index[..., None].expand(-1, -1, t.shape[-1]))


def sample_roi_set(assign, props, pvalid, gt_props, gt_bboxes, gt_labels,
                   gt_mask, key, num: int, pos_fraction: float,
                   num_classes: int, add_gt: bool = True):
    """Assign and randomly sample proposals into a fixed RoI set per image
    (the JAX package's per-image sampler, batched).

    Args:
        assign: boxes (B, N', D) -> the :class:`AssignResult` of those
            boxes against the gts (the head's assigner on its own view of
            the boxes).
        props (B, N, D), pvalid (B, N): the proposals.
        gt_props (B, G, D): the gts in the proposals' form, put first
            among them when ``add_gt``.
        gt_bboxes (B, G, 5), gt_labels, gt_mask: the padded rotated gts.
        key: a :class:`SampleKey` with one key per image (``split(B)``);
            positives draw from ``key.split(2, 0)``, negatives from
            ``key.split(2, 1)``.
    Returns:
        rois (B, num, D): positives, then negatives, then padding, each in
        the stable descending order of its sampling scores; labels
        (B, num), ``num_classes`` for all but the positives; label weights
        (B, num) float; the matched rotated gts (B, num, 5); the positive
        mask (B, num).
    """
    if add_gt:
        props = torch.cat([gt_props, props], 1)
        pvalid = torch.cat([gt_mask, pvalid], 1)
    result = assign(props)
    pos = (result.assigned_gt_inds >= 0) & pvalid
    neg = (result.assigned_gt_inds == NEG) & pvalid
    pos_key, neg_key = sample_scores(pos, neg, key)
    pos_sel, neg_sel = masks_from_scores(pos_key, neg_key, num, pos_fraction)
    order_key = torch.where(pos_sel, 2.0 + pos_key,
                            torch.where(neg_sel, 1.0 + neg_key, 0.0))
    order = torch.sort(-order_key, dim=1, stable=True).indices[:, :num]
    sel_pos, sel_neg = take_rows(pos_sel, order), take_rows(neg_sel, order)
    matched = take_rows(gt_bboxes, take_rows(result.assigned_gt_inds,
                                             order).clamp(min=0))
    labels = torch.where(sel_pos, take_rows(result.labels, order),
                         num_classes)
    return (take_rows(props, order), labels, (sel_pos | sel_neg).float(),
            matched, sel_pos)


def pool_rois(feats, rois: torch.Tensor, strides, out_size=(7, 7),
              sampling_ratio: int = 2, finest_scale: float = 56.0,
              plain_roi_align: bool = False,
              train: bool = False) -> torch.Tensor:
    """feats: NCHW pyramid levels (the first ``len(strides)`` are pooled);
    rois (B, R, 5) -> pooled (B, R, 7, 7, C) channels-last.

    Serving (``train=False``): :func:`roi_align_rotated_pyramid` (the CUDA
    kernel on the card), or its plain version when ``plain_roi_align`` is
    set (a reference run on the card). Neither carries a gradient: both
    raise for features that ask for one, so call them under ``no_grad``.
    ``train=True``: the gather formulation under autograd."""
    levels = [f.permute(0, 2, 3, 1).contiguous()
              for f in feats[:len(strides)]]
    args = (levels, rois.float().contiguous(), tuple(out_size),
            [1.0 / s for s in strides], sampling_ratio, finest_scale)
    if train:
        return roi_align_rotated(*args)
    pool = roi_align_rotated_pyramid_plain if plain_roi_align \
        else roi_align_rotated_pyramid
    return pool(*args)


@HEADS.register_module()
class OrientedStandardRoIHead(nn.Module):
    """``bbox_head`` is the one submodule with parameters. The
    ``roi_layer``'s ``clockwise`` key is not read and the op runs with
    ``clockwise=False``, as in the JAX package; ``RiRoIAlignRotated``'s
    ``num_samples`` and ``num_orientations`` are not read either (2
    samples a bin side, 8 orientations). ``train_cfg`` holds the
    ``assigner`` (default IoU 0.5 / 0.5 / 0.5 without low-quality matches)
    and the ``sampler`` (512 at 0.25, gts added as proposals)."""

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
        self.assigner = build_max_iou_assigner(self.train_cfg.get('assigner'))
        self.bbox_roi_extractor = dict(bbox_roi_extractor or {})
        layer_type = self.bbox_roi_extractor.get('roi_layer', {}).get(
            'type', 'RoIAlignRotated')
        if layer_type not in ('RoIAlignRotated', 'RoIAlign',
                              'RiRoIAlignRotated'):
            raise NotImplementedError(f'roi_layer {layer_type!r} is not '
                                      f'ported')
        self.rotation_invariant = layer_type == 'RiRoIAlignRotated'
        head = dict(bbox_head or dict(type='RotatedShared2FCBBoxHead'))
        if head.get('train_cfg') is None:
            head['train_cfg'] = train_cfg
        if head.get('test_cfg') is None:
            head['test_cfg'] = test_cfg
        self.bbox_head = HEADS.build(head)

    @property
    def assigners(self) -> list:
        return [self.assigner]

    @property
    def roi_cfg(self) -> dict:
        cfg = self.bbox_roi_extractor
        layer = cfg.get('roi_layer', {})
        out = int(layer.get('out_size', layer.get('output_size', 7)))
        ratio = int(layer.get('sample_num', layer.get('sampling_ratio', 2)))
        return dict(out_size=(out,) * 2, sampling_ratio=max(ratio, 1),
                    finest_scale=float(cfg.get('finest_scale', 56)),
                    strides=cfg.get('featmap_strides', [4, 8, 16, 32]))

    def pool(self, feats, rois: torch.Tensor, plain_roi_align: bool = False,
             train: bool = False) -> torch.Tensor:
        """:func:`pool_rois` with this head's ``roi_layer`` settings, then
        for ``RiRoIAlignRotated`` the orientation roll."""
        rc = self.roi_cfg
        finest = 56.0 if self.rotation_invariant else rc['finest_scale']
        pooled = pool_rois(feats, rois, rc['strides'], rc['out_size'],
                           rc['sampling_ratio'], finest, plain_roi_align,
                           train)
        if not self.rotation_invariant:
            return pooled
        with record_function('two_stage.ri_roll'):
            return ri_roll(pooled, rois)

    def forward(self, feats, rois: torch.Tensor,
                plain_roi_align: bool = False):
        """feats: NCHW pyramid levels; rois (B, R, 5) -> the bbox head's
        (cls_score, bbox_pred) on the serving path's pooling (:meth:`pool`)."""
        return self.bbox_head(self.pool(feats, rois, plain_roi_align))

    @torch.no_grad()
    def sample_rois(self, proposals, prop_valid, gt_bboxes, gt_labels,
                    gt_mask, rng):
        """Assign and randomly sample proposals into a fixed RoI set per
        image.

        Args:
            proposals (B, R, 5), prop_valid (B, R): the RPN's padded
                proposals.
            gt_bboxes (B, G, 5), gt_labels (B, G), gt_mask (B, G): the
                padded gts.
            rng: a :class:`SampleKey` shared by the batch; image b samples
                with ``rng.split(B)``'s b-th key, as the JAX package's
                ``split(rng, B)``.
        Returns:
            rois (B, num, 5): positives, then negatives, then padding (each
            in the stable descending order of its sampling scores);
            labels (B, num), ``num_classes`` for all but the positives;
            label weights (B, num); delta targets (B, num, 5); box weights
            (B, num); and the positives of the batch, at least 1.
        """
        cfg = self.train_cfg.get('sampler') or {}
        gt_bboxes = gt_bboxes.float()
        props, gt_assign = self.assign_boxes(proposals.float(), gt_bboxes)
        rois, labels, label_weights, matched, sel_pos = sample_roi_set(
            lambda boxes: self.assigner(boxes, gt_assign, gt_labels,
                                        gt_mask),
            props, prop_valid, gt_assign, gt_bboxes, gt_labels, gt_mask,
            rng.split(props.shape[0]), int(cfg.get('num', 512)),
            float(cfg.get('pos_fraction', 0.25)),
            self.bbox_head.num_classes,
            bool(cfg.get('add_gt_as_proposals', True)))
        targets = self.bbox_head.coder.encode(rois, matched)
        targets = torch.where(sel_pos[..., None], targets, 0.0)
        bbox_weights = sel_pos.float()
        return (rois, labels, label_weights, targets, bbox_weights,
                bbox_weights.sum().clamp(min=1.0))

    def assign_boxes(self, proposals, gt_bboxes):
        """The proposals and the gts as the assigner compares them (the gts
        are also the proposals added first): both rotated, as they are."""
        return proposals, gt_bboxes

    def get_bboxes(self, rois, cls_score, bbox_pred, cfg=None,
                   img_shape=None, plain_pair_mask: bool = False):
        """Softmax scores, decoded boxes, multiclass rotated NMS. Returns
        (dets (B, max_per_img, 6), labels (B, max_per_img), valid)."""
        cfg = cfg if cfg is not None else self.test_cfg
        scores = torch.softmax(cls_score.float(), -1)         # (B, R, C+1)
        decoded = self.bbox_head.decode_bboxes(rois, bbox_pred.float(),
                                               img_shape)
        if decoded.dim() == 4:                 # (B, R, C, 5) -> (B, R, C*5)
            decoded = decoded.flatten(2)
        return nms_from_cfg(decoded, scores, cfg, plain_pair_mask)


def nms_from_cfg(boxes, scores, cfg: dict, plain_pair_mask: bool = False):
    """:func:`multiclass_nms_rotated` with a RoI head's ``test_cfg``
    (``score_thr``, ``nms.iou_thr``, ``max_per_img``, ``max_candidates``).
    Returns (dets (B, max_per_img, 6), labels, valid)."""
    nms_cfg = cfg.get('nms', {'iou_thr': 0.1})
    return multiclass_nms_rotated(
        boxes, scores, score_thr=float(cfg.get('score_thr', 0.05)),
        iou_thr=float(nms_cfg.get('iou_thr', 0.1)),
        max_per_img=int(cfg.get('max_per_img', 2000)),
        max_candidates=int(cfg.get('max_candidates', 2000)),
        plain_pair_mask=plain_pair_mask)


def as_theta0(rois: torch.Tensor) -> torch.Tensor:
    """(..., 4) xyxy -> (..., 5) theta-0 rotated boxes with w and h clipped
    at 0 (JAX ``RotatedStandardRoIHead._as_theta0``); 5-column boxes pass
    through."""
    if rois.shape[-1] == 5:
        return rois
    x1, y1, x2, y2 = rois.unbind(-1)
    return torch.stack([(x1 + x2) * 0.5, (y1 + y2) * 0.5,
                        (x2 - x1).clamp(min=0), (y2 - y1).clamp(min=0),
                        torch.zeros_like(x1)], -1)


@HEADS.register_module()
class RotatedStandardRoIHead(OrientedStandardRoIHead):
    """Rotated Faster R-CNN's RoI head (reference
    ``roi_heads/rotate_standard_roi_head.py``): horizontal proposals from
    :class:`RotatedRPNHead`, pooled as theta-0 rotated boxes (the RoIAlign
    kernel at theta 0), assigned by rotated IoU against the gts'
    circumscribed horizontal boxes (``obb2hbb``), which are also the
    proposals added first, and regressed (``DeltaXYWHAHBBoxCoder``) to the
    original rotated gts. The config's ``RoIAlign`` with ``sampling_ratio``
    0 pools with 1 sample a bin side, as the JAX package reads it."""

    def forward(self, feats, rois: torch.Tensor,
                plain_roi_align: bool = False):
        return super().forward(feats, as_theta0(rois), plain_roi_align)

    def assign_boxes(self, proposals, gt_bboxes):
        return as_theta0(proposals), obb2hbb(gt_bboxes, self.version)

    def get_bboxes(self, rois, cls_score, bbox_pred, cfg=None,
                   img_shape=None, plain_pair_mask: bool = False):
        return super().get_bboxes(as_theta0(rois), cls_score, bbox_pred,
                                  cfg, img_shape, plain_pair_mask)
