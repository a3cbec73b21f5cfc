from .bbox_heads import (RotatedKFIoUShared2FCBBoxHead,
                         RotatedShared2FCBBoxHead)
from .gv_trans_heads import GVBBoxHead, GVRatioRoIHead, RoITransRoIHead
from .oriented_roi_head import OrientedStandardRoIHead, RotatedStandardRoIHead

__all__ = ['RotatedShared2FCBBoxHead', 'RotatedKFIoUShared2FCBBoxHead',
           'OrientedStandardRoIHead', 'RotatedStandardRoIHead', 'GVBBoxHead',
           'GVRatioRoIHead', 'RoITransRoIHead']
