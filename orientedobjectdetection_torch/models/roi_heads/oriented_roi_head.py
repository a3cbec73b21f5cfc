"""Oriented standard RoI head (counterpart of
``orientedobjectdetection_tpu/models/roi_heads/oriented_roi_head.py``;
reference ``roi_heads/oriented_standard_roi_head.py:10-188``): at test time
RoIAlignRotated over all proposals -> bbox head -> decode -> multiclass
rotated NMS.

The detector's maps are NCHW; the RoIAlign op takes channels-last levels,
as the JAX package's does, so the first ``len(featmap_strides)`` levels are
permuted here.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...ops.nms import multiclass_nms_rotated
from ...ops.roi_align_kernels import (roi_align_rotated_pyramid,
                                      roi_align_rotated_pyramid_plain)
from ...utils.registry import HEADS


@HEADS.register_module()
class OrientedStandardRoIHead(nn.Module):
    """``bbox_head`` is the one submodule with parameters. The
    ``roi_layer``'s ``clockwise`` key is not read and the op runs with
    ``clockwise=False``, as in the JAX package."""

    def __init__(self, bbox_roi_extractor: Optional[dict] = None,
                 bbox_head: Optional[dict] = None,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None,
                 version: str = 'le90',
                 init_cfg: Optional[dict] = None):
        super().__init__()
        self.test_cfg = test_cfg or {}
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

    def forward(self, feats, rois: torch.Tensor,
                plain_roi_align: bool = False):
        """feats: NCHW pyramid levels (the first ``len(strides)`` are
        pooled); rois (B, R, 5) -> the bbox head's (cls_score, bbox_pred).

        Pooled by :func:`roi_align_rotated_pyramid` (the CUDA kernel on the
        card), or by its plain version when ``plain_roi_align`` is set (a
        reference run on the card). Neither carries a gradient: both raise
        for features that ask for one, so call this under ``no_grad``."""
        rc = self.roi_cfg
        strides = rc['strides']
        levels = [f.permute(0, 2, 3, 1).contiguous()
                  for f in feats[:len(strides)]]
        args = (levels, rois.float().contiguous(), rc['out_size'],
                [1.0 / s for s in strides], rc['sampling_ratio'],
                rc['finest_scale'])
        pool = roi_align_rotated_pyramid_plain if plain_roi_align \
            else roi_align_rotated_pyramid
        return self.bbox_head(pool(*args))

    def sample_rois(self, proposals, prop_valid, gt_bboxes, gt_labels,
                    gt_mask, rng):
        raise NotImplementedError(
            'OrientedStandardRoIHead.sample_rois is not ported yet '
            '(ROADMAP A.1, two-stage training)')

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
