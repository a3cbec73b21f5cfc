from .bbox_heads import RotatedShared2FCBBoxHead
from .oriented_roi_head import OrientedStandardRoIHead

__all__ = ['RotatedShared2FCBBoxHead', 'OrientedStandardRoIHead']
