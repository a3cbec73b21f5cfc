from .common import (CrossEntropyLoss, FocalLoss, GIoULoss, IoULoss, L1Loss,
                     ObjectnessLoss, ObjectnessLoss2, ObjectnessLoss3,
                     SmoothFocalLoss, SmoothL1Loss, VarifocalLoss,
                     reduce_loss, sigmoid_focal_loss, smooth_l1_loss,
                     weighted_loss)
from .gaussian_dist_loss import GDLoss, GDLoss_v1
from .kf_iou_loss import KFLoss, kfiou_loss
from .kld_reppoints_loss import KLDRepPointsLoss, kld_fitted_to_gt
from .rotated_iou_loss import RotatedIoULoss
from .spatial_border_loss import SpatialBorderLoss

__all__ = ['CrossEntropyLoss', 'FocalLoss', 'GIoULoss', 'IoULoss', 'L1Loss',
           'SmoothFocalLoss', 'SmoothL1Loss', 'VarifocalLoss', 'ObjectnessLoss',
           'ObjectnessLoss2', 'ObjectnessLoss3', 'GDLoss', 'GDLoss_v1',
           'KFLoss', 'kfiou_loss', 'RotatedIoULoss', 'KLDRepPointsLoss',
           'kld_fitted_to_gt', 'SpatialBorderLoss', 'reduce_loss',
           'sigmoid_focal_loss', 'smooth_l1_loss', 'weighted_loss']
