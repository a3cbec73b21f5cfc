"""Two-stage rotated detector, test mode (counterpart of
``orientedobjectdetection_tpu/models/detectors/two_stage.py``; reference
``detectors/two_stage.py:11-195``): backbone -> neck -> RPN head ->
proposals -> RoI head, then the RoI head's decode and NMS.

The stages of a request run inside ``torch.profiler.record_function`` ranges
named ``two_stage.*`` (``network_rpn``, ``proposals``, ``roialign_head``,
``decode_nms``), so a profile of a request splits by stage.
"""

from __future__ import annotations

from typing import Optional

from torch import nn
from torch.profiler import record_function

from ...utils.registry import BACKBONES, DETECTORS, HEADS, NECKS
from .single_stage import init_seeded_weights


@DETECTORS.register_module()
class RotatedTwoStageDetector(nn.Module):
    """Input NCHW images; ``forward`` returns ``dict(proposals (B, R, 5),
    prop_valid (B, R), cls_score (B, R, C+1), bbox_pred (B, R, 5))``."""

    def __init__(self, backbone: dict, neck: Optional[dict] = None,
                 rpn_head: Optional[dict] = None,
                 roi_head: Optional[dict] = None,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None,
                 pretrained: Optional[str] = None,
                 init_cfg: Optional[dict] = None):
        super().__init__()
        self.train_cfg = train_cfg or {}
        self.test_cfg = test_cfg or {}
        self.backbone = BACKBONES.build(dict(backbone))
        self.neck = NECKS.build(dict(neck)) if neck is not None else None
        rpn = dict(rpn_head)
        rpn.setdefault('train_cfg', self.train_cfg.get('rpn'))
        rpn.setdefault('test_cfg', self.test_cfg.get('rpn'))
        self.rpn_head = HEADS.build(rpn)
        roi = dict(roi_head)
        roi.setdefault('train_cfg', self.train_cfg.get('rcnn'))
        roi.setdefault('test_cfg', self.test_cfg.get('rcnn'))
        self.roi_head = HEADS.build(roi)

    def init_weights(self, seed: int = 0):
        """Seeded random weights (:func:`init_seeded_weights`): LeCun-normal
        convolution and linear weights, zero biases, identity frozen BN."""
        init_seeded_weights(self, seed)

    def extract_feat(self, images):
        x = self.backbone(images)
        return self.neck(x) if self.neck is not None else x

    def forward(self, images, batch=None, train: bool = False,
                plain_roi_align: bool = False):
        if train:
            raise NotImplementedError(
                'two-stage training is not ported yet (ROADMAP A.1)')
        with record_function('two_stage.network_rpn'):
            feats = self.extract_feat(images)
            rpn_outputs = self.rpn_head(feats)
        with record_function('two_stage.proposals'):
            proposals, _, prop_valid = self.rpn_head.get_proposals(
                rpn_outputs, cfg=self.test_cfg.get('rpn'))
        with record_function('two_stage.roialign_head'):
            cls_score, bbox_pred = self.roi_head(
                feats, proposals, plain_roi_align=plain_roi_align)
        return dict(proposals=proposals, prop_valid=prop_valid,
                    cls_score=cls_score, bbox_pred=bbox_pred)

    def loss_from_outputs(self, outputs, batch):
        raise NotImplementedError(
            'two-stage training is not ported yet (ROADMAP A.1)')

    def bboxes_from_outputs(self, outputs, img_shape=None, cfg=None,
                            plain_pair_mask: bool = False):
        cfg = cfg if cfg is not None else self.test_cfg.get('rcnn')
        with record_function('two_stage.decode_nms'):
            return self.roi_head.get_bboxes(
                outputs['proposals'], outputs['cls_score'],
                outputs['bbox_pred'], cfg=cfg, img_shape=img_shape,
                plain_pair_mask=plain_pair_mask)


@DETECTORS.register_module()
class OrientedRCNN(RotatedTwoStageDetector):
    """Thin alias (reference ``detectors/oriented_rcnn.py``)."""
