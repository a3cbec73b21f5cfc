from .. import core  # noqa: F401  (registers anchors, coders and assigners)
from ..utils.registry import (BACKBONES, DETECTORS, HEADS, LOSSES, MODELS,
                              NECKS)
from .backbones import (ConvNeXt, CSPNeXt, CSPNeXtLarge, ReResNet, ResNet,
                        Swin, SwinTransformer, YOLOv8CSPDarknet)
from .dense_heads import (CSLRFCOSHead, CSLRRetinaHead, KFIoUODMRefineHead,
                          KFIoURRetinaHead, KFIoURRetinaRefineHead,
                          KLDRepPointsHead, ODMRefineHead,
                          OrientedRepPointsHead, OrientedRPNHead,
                          RotatedATSSHead, RotatedFCOSHead,
                          RotatedRepPointsHead, RotatedRetinaHead,
                          RotatedRetinaRefineHead, RotatedRPNHead,
                          SAMRepPointsHead, OBBLabelAssigner,
                          RotatedDecoupled1x1ObjHead, RotatedDecoupledBGHead,
                          RotatedDecoupledObjHead, RotatedMSDCNHead,
                          RotatedYOLOv8AngleHead, RotatedYOLOv8Head)
from .detectors import (GlidingVertex, OrientedRCNN, R3Det, ReDet,
                        RoITransformer, RotatedFasterRCNN, RotatedFCOS,
                        RotatedRepPoints, RotatedRetinaNet,
                        RotatedSingleStageDetector, RotatedTwoStageDetector,
                        RotatedYOLOv8, S2ANet)
from .losses import (CrossEntropyLoss, FocalLoss, GDLoss, GDLoss_v1,
                     GIoULoss, IoULoss, KFLoss, KLDRepPointsLoss, L1Loss,
                     ObjectnessLoss, ObjectnessLoss2, ObjectnessLoss3,
                     RotatedIoULoss, SmoothFocalLoss, SmoothL1Loss,
                     SpatialBorderLoss, VarifocalLoss)
from .necks import FPN, ReFPN, YOLOv6RepPAFPN, YOLOv8PAFPN, YOLOv8PAFPN_E
from .roi_heads import (GVBBoxHead, GVRatioRoIHead, OrientedStandardRoIHead,
                        RoITransRoIHead, RotatedKFIoUShared2FCBBoxHead,
                        RotatedShared2FCBBoxHead, RotatedStandardRoIHead)


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
    'ResNet', 'SwinTransformer', 'Swin', 'ConvNeXt', 'ReResNet', 'FPN',
    'ReFPN', 'RotatedRetinaHead', 'KFIoURRetinaHead',
    'RotatedATSSHead', 'CSLRRetinaHead', 'RotatedFCOSHead', 'CSLRFCOSHead',
    'RotatedRetinaNet', 'RotatedFCOS', 'RotatedSingleStageDetector',
    'OrientedRPNHead', 'OrientedStandardRoIHead', 'RotatedShared2FCBBoxHead',
    'OrientedRCNN', 'RotatedTwoStageDetector', 'RotatedRetinaRefineHead',
    'KFIoURRetinaRefineHead', 'ODMRefineHead', 'KFIoUODMRefineHead',
    'S2ANet', 'R3Det', 'RotatedRPNHead', 'RotatedStandardRoIHead',
    'RotatedKFIoUShared2FCBBoxHead', 'GVBBoxHead', 'GVRatioRoIHead',
    'RoITransRoIHead', 'RotatedFasterRCNN', 'GlidingVertex',
    'RoITransformer', 'ReDet', 'RotatedRepPoints', 'RotatedRepPointsHead',
    'OrientedRepPointsHead', 'SAMRepPointsHead', 'KLDRepPointsHead',
    'KLDRepPointsLoss', 'SpatialBorderLoss', 'CrossEntropyLoss',
    'FocalLoss', 'GDLoss', 'GDLoss_v1', 'GIoULoss', 'IoULoss', 'KFLoss',
    'L1Loss', 'RotatedIoULoss', 'SmoothFocalLoss', 'SmoothL1Loss',
    'CSPNeXt', 'CSPNeXtLarge', 'YOLOv8CSPDarknet', 'YOLOv6RepPAFPN',
    'YOLOv8PAFPN',
    'YOLOv8PAFPN_E', 'RotatedYOLOv8Head', 'RotatedYOLOv8AngleHead',
    'OBBLabelAssigner', 'RotatedMSDCNHead', 'RotatedDecoupledObjHead',
    'RotatedDecoupledBGHead', 'RotatedDecoupled1x1ObjHead', 'RotatedYOLOv8',
    'VarifocalLoss', 'ObjectnessLoss', 'ObjectnessLoss2', 'ObjectnessLoss3',
    'build_detector', 'MODELS', 'BACKBONES', 'NECKS',
    'HEADS', 'DETECTORS', 'LOSSES',
]
