from .common import (FocalLoss, L1Loss, SmoothL1Loss, reduce_loss,
                     sigmoid_focal_loss, smooth_l1_loss, weighted_loss)

__all__ = ['FocalLoss', 'L1Loss', 'SmoothL1Loss', 'reduce_loss',
           'sigmoid_focal_loss', 'smooth_l1_loss', 'weighted_loss']
