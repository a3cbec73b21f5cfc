from .oriented_rpn_head import OrientedRPNHead
from .rotated_anchor_head import (CSLRRetinaHead, KFIoURRetinaHead,
                                  RotatedATSSHead, RotatedRetinaHead)
from .refine_heads import (KFIoUODMRefineHead, KFIoURRetinaRefineHead,
                           ODMRefineHead, RotatedRetinaRefineHead)
from .rotated_fcos_head import CSLRFCOSHead, RotatedFCOSHead
from .rotated_reppoints_head import (KLDRepPointsHead, OrientedRepPointsHead,
                                     RotatedRepPointsHead, SAMRepPointsHead)
from .rotated_rpn_head import RotatedRPNHead
from .rotated_yolov8_head import (OBBLabelAssigner, RotatedYOLOv8AngleHead,
                                  RotatedYOLOv8Head)
from .jy_heads import (RotatedDecoupled1x1ObjHead, RotatedDecoupledBGHead,
                       RotatedDecoupledObjHead, RotatedMSDCNHead)

__all__ = ['OrientedRPNHead', 'RotatedRetinaHead', 'KFIoURRetinaHead',
           'RotatedATSSHead', 'CSLRRetinaHead', 'RotatedFCOSHead',
           'CSLRFCOSHead', 'RotatedRetinaRefineHead', 'KFIoURRetinaRefineHead',
           'ODMRefineHead', 'KFIoUODMRefineHead', 'RotatedRPNHead',
           'RotatedRepPointsHead', 'OrientedRepPointsHead',
           'SAMRepPointsHead', 'KLDRepPointsHead', 'RotatedYOLOv8Head',
           'RotatedYOLOv8AngleHead', 'OBBLabelAssigner', 'RotatedMSDCNHead',
           'RotatedDecoupledObjHead', 'RotatedDecoupledBGHead',
           'RotatedDecoupled1x1ObjHead']
