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
a stable sort of the sampling scores.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...core.assigners import (MaxIoUAssigner, NEG, masks_from_scores,
                               sample_scores)
from ...ops.nms import multiclass_nms_rotated
from ...ops.roi_align_kernels import (roi_align_rotated_pyramid,
                                      roi_align_rotated_pyramid_plain)
from ...ops.roi_align_rotated import roi_align_rotated
from ...utils.registry import HEADS


@HEADS.register_module()
class OrientedStandardRoIHead(nn.Module):
    """``bbox_head`` is the one submodule with parameters. The
    ``roi_layer``'s ``clockwise`` key is not read and the op runs with
    ``clockwise=False``, as in the JAX package. ``train_cfg`` holds the
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
        assigner = dict(self.train_cfg.get('assigner') or dict(
            pos_iou_thr=0.5, neg_iou_thr=0.5, min_pos_iou=0.5,
            match_low_quality=False))
        assigner.pop('type', None)
        assigner.pop('iou_calculator', None)
        self.assigner = MaxIoUAssigner(**assigner)
        self.bbox_roi_extractor = dict(bbox_roi_extractor or {})
        layer_type = self.bbox_roi_extractor.get('roi_layer', {}).get(
            'type', 'RoIAlignRotated')
        if layer_type != 'RoIAlignRotated':
            raise NotImplementedError(
                f'roi_layer {layer_type!r} is not ported yet (ReDet, '
                f'ROADMAP A.9)')
        head = dict(bbox_head or dict(type='RotatedShared2FCBBoxHead'))
        if head.get('train_cfg') is None:
            head['train_cfg'] = train_cfg
        if head.get('test_cfg') is None:
            head['test_cfg'] = test_cfg
        self.bbox_head = HEADS.build(head)

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
        """feats: NCHW pyramid levels (the first ``len(strides)`` are
        pooled); rois (B, R, 5) -> pooled (B, R, 7, 7, C) channels-last.

        Serving (``train=False``): :func:`roi_align_rotated_pyramid` (the
        CUDA kernel on the card), or its plain version when
        ``plain_roi_align`` is set (a reference run on the card). Neither
        carries a gradient: both raise for features that ask for one, so
        call them under ``no_grad``. ``train=True``: the gather
        formulation under autograd."""
        rc = self.roi_cfg
        strides = rc['strides']
        levels = [f.permute(0, 2, 3, 1).contiguous()
                  for f in feats[:len(strides)]]
        args = (levels, rois.float().contiguous(), rc['out_size'],
                [1.0 / s for s in strides], rc['sampling_ratio'],
                rc['finest_scale'])
        if train:
            return roi_align_rotated(*args)
        pool = roi_align_rotated_pyramid_plain if plain_roi_align \
            else roi_align_rotated_pyramid
        return pool(*args)

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
        num = int(cfg.get('num', 512))
        pos_fraction = float(cfg.get('pos_fraction', 0.25))
        gt_bboxes = gt_bboxes.float()
        props, pvalid = proposals.float(), prop_valid
        if bool(cfg.get('add_gt_as_proposals', True)):
            props = torch.cat([gt_bboxes, props], 1)
            pvalid = torch.cat([gt_mask, pvalid], 1)
        assign = self.assigner(props, gt_bboxes, gt_labels, gt_mask)
        pos = (assign.assigned_gt_inds >= 0) & pvalid
        neg = (assign.assigned_gt_inds == NEG) & pvalid
        pos_key, neg_key = sample_scores(pos, neg,
                                         rng.split(props.shape[0]))
        pos_sel, neg_sel = masks_from_scores(pos_key, neg_key, num,
                                             pos_fraction)
        order_key = torch.where(pos_sel, 2.0 + pos_key,
                                torch.where(neg_sel, 1.0 + neg_key, 0.0))
        order = torch.sort(-order_key, dim=1, stable=True).indices[:, :num]

        def take(t):
            index = order if t.dim() == 2 else \
                order[..., None].expand(-1, -1, t.shape[-1])
            return t.gather(1, index)

        rois = take(props)
        sel_pos, sel_neg = take(pos_sel), take(neg_sel)
        matched = gt_bboxes.gather(1, take(
            assign.assigned_gt_inds).clamp(min=0)[..., None].expand(-1, -1,
                                                                    5))
        targets = self.bbox_head.coder.encode(rois, matched)
        targets = torch.where(sel_pos[..., None], targets, 0.0)
        labels = torch.where(sel_pos, take(assign.labels),
                             self.bbox_head.num_classes)
        bbox_weights = sel_pos.float()
        return (rois, labels, (sel_pos | sel_neg).float(), targets,
                bbox_weights, bbox_weights.sum().clamp(min=1.0))

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
        nms_cfg = cfg.get('nms', {'iou_thr': 0.1})
        return multiclass_nms_rotated(
            decoded, scores, score_thr=float(cfg.get('score_thr', 0.05)),
            iou_thr=float(nms_cfg.get('iou_thr', 0.1)),
            max_per_img=int(cfg.get('max_per_img', 2000)),
            max_candidates=int(cfg.get('max_candidates', 2000)),
            plain_pair_mask=plain_pair_mask)
