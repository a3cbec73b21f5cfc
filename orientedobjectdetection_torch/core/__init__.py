from .anchors import RotatedAnchorGenerator, anchor_inside_flags
from .assigners import AssignResult, MaxIoUAssigner
from .coders import (DeltaXYWHAOBBoxCoder, MidpointOffsetCoder,
                     poly2obb_from_parallelogram)

__all__ = ['RotatedAnchorGenerator', 'anchor_inside_flags', 'AssignResult',
           'MaxIoUAssigner', 'DeltaXYWHAOBBoxCoder', 'MidpointOffsetCoder',
           'poly2obb_from_parallelogram']
