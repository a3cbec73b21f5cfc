from .. import core  # noqa: F401  (registers anchors, coders and assigners)
from ..utils.registry import (BACKBONES, DETECTORS, HEADS, LOSSES, MODELS,
                              NECKS)
from .backbones import ResNet
from .dense_heads import OrientedRPNHead, RotatedRetinaHead
from .detectors import (OrientedRCNN, RotatedRetinaNet,
                        RotatedSingleStageDetector, RotatedTwoStageDetector)
from .losses import CrossEntropyLoss, FocalLoss, L1Loss, SmoothL1Loss
from .necks import FPN
from .roi_heads import OrientedStandardRoIHead, RotatedShared2FCBBoxHead


def build_detector(cfg, train_cfg=None, test_cfg=None):
    """mmdet-compatible detector factory (reference
    ``models/builder.py:45-56``): train_cfg/test_cfg may live in the model
    config or be passed explicitly."""
    cfg = dict(cfg)
    if train_cfg is not None:
        cfg['train_cfg'] = train_cfg
    if test_cfg is not None:
        cfg['test_cfg'] = test_cfg
    return DETECTORS.build(cfg)


__all__ = [
    'ResNet', 'FPN', 'RotatedRetinaHead', 'RotatedRetinaNet',
    'RotatedSingleStageDetector', 'OrientedRPNHead',
    'OrientedStandardRoIHead', 'RotatedShared2FCBBoxHead', 'OrientedRCNN',
    'RotatedTwoStageDetector', 'CrossEntropyLoss', 'FocalLoss', 'L1Loss',
    'SmoothL1Loss', 'build_detector', 'MODELS', 'BACKBONES', 'NECKS',
    'HEADS', 'DETECTORS', 'LOSSES',
]
