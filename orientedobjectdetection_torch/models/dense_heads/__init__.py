from .oriented_rpn_head import OrientedRPNHead
from .rotated_anchor_head import (CSLRRetinaHead, KFIoURRetinaHead,
                                  RotatedATSSHead, RotatedRetinaHead)
from .refine_heads import (KFIoUODMRefineHead, KFIoURRetinaRefineHead,
                           ODMRefineHead, RotatedRetinaRefineHead)
from .rotated_fcos_head import CSLRFCOSHead, RotatedFCOSHead
from .rotated_reppoints_head import (KLDRepPointsHead, OrientedRepPointsHead,
                                     RotatedRepPointsHead, SAMRepPointsHead)
from .rotated_rpn_head import RotatedRPNHead

__all__ = ['OrientedRPNHead', 'RotatedRetinaHead', 'KFIoURRetinaHead',
           'RotatedATSSHead', 'CSLRRetinaHead', 'RotatedFCOSHead',
           'CSLRFCOSHead', 'RotatedRetinaRefineHead', 'KFIoURRetinaRefineHead',
           'ODMRefineHead', 'KFIoUODMRefineHead', 'RotatedRPNHead',
           'RotatedRepPointsHead', 'OrientedRepPointsHead',
           'SAMRepPointsHead', 'KLDRepPointsHead']
