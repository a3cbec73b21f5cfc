"""Rotated RPN head with horizontal proposals (counterpart of
``orientedobjectdetection_tpu/models/dense_heads/rotated_rpn_head.py``;
reference ``dense_heads/rotated_rpn_head.py``): mmdet's RPN with
4-parameter deltas over horizontal anchors, for Gliding Vertex, Rotated
Faster R-CNN and RoI Transformer. The gts are assigned on their
circumscribed horizontal boxes; proposals are axis-aligned xyxy boxes
``(B, max_num, 4)``.

It is :class:`OrientedRPNHead` with another coder: the same convolutions,
anchors, batched assignment (one IoU-matrix launch for the batch on the
card), ``rng_from_gt`` sampling, losses and the same HBB NMS
(:func:`...ops.nms.nms_hbb`) over the top ``max_candidates`` decoded
boxes of all levels.
"""

from __future__ import annotations

from typing import Optional

from ...ops.boxes import obb2xyxy
from ...utils.registry import BBOX_CODERS, HEADS
from .oriented_rpn_head import OrientedRPNHead


@HEADS.register_module()
class RotatedRPNHead(OrientedRPNHead):
    """``rpn_reg`` has A*4 outputs. The anchor generator is always a
    ``RotatedAnchorGenerator`` (the Rotated Faster R-CNN config names
    mmdet's ``AnchorGenerator``), and the coder is ``DeltaXYWHBBoxCoder``
    with the config's means and stds (an ``angle_range`` is dropped), as in
    the JAX package. Proposals take no ``min_bbox_size`` filter, and the
    NMS threshold defaults to 0.7."""

    default_nms_thr = 0.7

    def build_coder(self, bbox_coder: Optional[dict]):
        cfg = dict(bbox_coder or {})
        cfg.pop('angle_range', None)
        cfg['type'] = 'DeltaXYWHBBoxCoder'
        return BBOX_CODERS.build(cfg)

    def regression_targets(self, anchors_xyxy, matched):
        """4-parameter deltas of the anchors (N, 4) to their matched gts'
        circumscribed boxes."""
        return self.coder.encode(anchors_xyxy[None],
                                 obb2xyxy(matched, self.version))

    def keep_size(self, boxes, min_bbox_size: float):
        return None

    def candidate_hbbs(self, boxes):
        return boxes
