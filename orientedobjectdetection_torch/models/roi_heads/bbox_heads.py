"""Rotated RoI bbox head (counterpart of
``orientedobjectdetection_tpu/models/roi_heads/bbox_heads.py``; reference
``roi_heads/bbox_heads/rotated_bbox_head.py:16`` and
``convfc_rbbox_head.py``, ``RotatedShared2FCBBoxHead``): pooled rotated RoI
features -> shared FCs -> softmax class logits (C+1) and 5-parameter deltas.

The pooled features arrive channels-last, ``(B, R, 7, 7, C)``, and are
flattened in that order, as the JAX package does; ``shared_fcs.0.weight``
carries between the packages by a transpose alone.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.registry import BBOX_CODERS, HEADS, LOSSES


@HEADS.register_module()
class RotatedShared2FCBBoxHead(nn.Module):
    """mmrotate names: ``shared_fcs.{i}``, ``fc_cls``, ``fc_reg``. The
    losses default to softmax cross entropy and smooth L1 with beta 1, as
    the JAX package's do; ``train_cfg`` is accepted for the reference
    configs and not read."""

    def __init__(self, num_classes: int = 15, in_channels: int = 256,
                 fc_out_channels: int = 1024, roi_feat_size: int = 7,
                 num_shared_fcs: int = 2, reg_class_agnostic: bool = True,
                 bbox_coder: Optional[dict] = None,
                 loss_cls: Optional[dict] = None,
                 loss_bbox: Optional[dict] = None,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None,
                 init_cfg: Optional[dict] = None):
        super().__init__()
        self.num_classes = num_classes
        self.reg_class_agnostic = reg_class_agnostic
        self.cls_loss = LOSSES.build(dict(loss_cls or dict(
            type='CrossEntropyLoss', loss_weight=1.0)))
        self.bbox_loss = LOSSES.build(dict(loss_bbox or dict(
            type='SmoothL1Loss', beta=1.0, loss_weight=1.0)))
        self.coder = BBOX_CODERS.build(dict(bbox_coder or dict(
            type='DeltaXYWHAOBBoxCoder', angle_range='le90',
            norm_factor=None, edge_swap=True, proj_xy=True,
            target_means=(0., 0., 0., 0., 0.),
            target_stds=(0.1, 0.1, 0.2, 0.2, 0.1))))
        flat = roi_feat_size * roi_feat_size * in_channels
        self.shared_fcs = nn.ModuleList(
            nn.Linear(flat if i == 0 else fc_out_channels, fc_out_channels)
            for i in range(num_shared_fcs))
        last = fc_out_channels if num_shared_fcs else flat
        self.fc_cls = nn.Linear(last, num_classes + 1)
        self.fc_reg = nn.Linear(
            last, 5 if reg_class_agnostic else 5 * num_classes)

    def forward(self, roi_feats: torch.Tensor):
        """roi_feats (B, R, 7, 7, C) -> cls (B, R, C+1),
        reg (B, R, 5 or 5*C)."""
        x = roi_feats.flatten(2)
        for fc in self.shared_fcs:
            x = F.relu(fc(x))
        return self.fc_cls(x), self.fc_reg(x)

    def loss(self, cls_score, bbox_pred, rois, labels, label_weights,
             bbox_targets, bbox_weights, num_pos):
        """All (B, R, ...) from the RoI head's ``sample_rois``; labels equal
        to ``num_classes`` are background. The class loss averages over the
        sampled RoIs, the box loss over ``num_pos``; a per-class regression
        is read at each RoI's label. Returns ``dict(loss_cls, loss_bbox)``."""
        loss_cls = self.cls_loss(
            cls_score.float(), labels, weight=label_weights,
            avg_factor=label_weights.sum().clamp(min=1.0))
        loss_bbox = self.bbox_loss(
            self.pred_at_labels(bbox_pred.float(), labels), bbox_targets,
            weight=bbox_weights, avg_factor=num_pos)
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox)

    def pred_at_labels(self, bbox_pred, labels):
        """(B, R, 5) deltas: a per-class regression read at each RoI's label
        (background reads the last class); agnostic ones as they are."""
        if self.reg_class_agnostic:
            return bbox_pred
        b, r = bbox_pred.shape[:2]
        per_class = bbox_pred.reshape(b, r, self.num_classes, 5)
        safe = labels.clamp(0, self.num_classes - 1)
        return per_class.gather(
            2, safe[..., None, None].expand(-1, -1, 1, 5))[..., 0, :]

    def decode_bboxes(self, rois, bbox_pred, img_shape=None):
        """rois (B, R, 5); bbox_pred (B, R, 5 or C*5) -> decoded
        (B, R, [C,] 5)."""
        if self.reg_class_agnostic:
            return self.coder.decode(rois, bbox_pred, max_shape=img_shape)
        b, r = bbox_pred.shape[:2]
        bp = bbox_pred.reshape(b, r, self.num_classes, 5)
        return self.coder.decode(rois[:, :, None, :], bp,
                                 max_shape=img_shape)


@HEADS.register_module()
class RotatedKFIoUShared2FCBBoxHead(RotatedShared2FCBBoxHead):
    """The shared-2FC head trained with the KFIoU loss (reference
    ``bbox_heads/kfiou_rotate_bbox_head.py``, the stage-1 head of the
    ``configs/kfiou/roi_trans_kfiou_ln_*`` configs): ``KFLoss`` reads the
    deltas and the boxes decoded from the predicted and the target deltas
    against the RoIs."""

    def __init__(self, *args, loss_bbox: Optional[dict] = None, **kwargs):
        super().__init__(*args, loss_bbox=loss_bbox or dict(
            type='KFLoss', loss_weight=1.0), **kwargs)

    def loss(self, cls_score, bbox_pred, rois, labels, label_weights,
             bbox_targets, bbox_weights, num_pos):
        loss_cls = self.cls_loss(
            cls_score.float(), labels, weight=label_weights,
            avg_factor=label_weights.sum().clamp(min=1.0))
        bbox_pred = self.pred_at_labels(bbox_pred.float(), labels)
        loss_bbox = self.bbox_loss(
            bbox_pred, bbox_targets, weight=bbox_weights, avg_factor=num_pos,
            pred_decode=self.coder.decode(rois, bbox_pred),
            targets_decode=self.coder.decode(rois, bbox_targets))
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox)
