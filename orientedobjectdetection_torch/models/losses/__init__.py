from .common import (CrossEntropyLoss, FocalLoss, GIoULoss, IoULoss, L1Loss,
                     SmoothFocalLoss, SmoothL1Loss, reduce_loss,
                     sigmoid_focal_loss, smooth_l1_loss, weighted_loss)
from .gaussian_dist_loss import GDLoss, GDLoss_v1
from .kf_iou_loss import KFLoss, kfiou_loss
from .rotated_iou_loss import RotatedIoULoss

__all__ = ['CrossEntropyLoss', 'FocalLoss', 'GIoULoss', 'IoULoss', 'L1Loss',
           'SmoothFocalLoss', 'SmoothL1Loss', 'GDLoss', 'GDLoss_v1',
           'KFLoss', 'kfiou_loss', 'RotatedIoULoss', 'reduce_loss',
           'sigmoid_focal_loss', 'smooth_l1_loss', 'weighted_loss']
