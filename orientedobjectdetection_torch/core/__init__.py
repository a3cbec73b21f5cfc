from .anchors import RotatedAnchorGenerator, anchor_inside_flags
from .assigners import AssignResult, MaxIoUAssigner
from .coders import DeltaXYWHAOBBoxCoder

__all__ = ['RotatedAnchorGenerator', 'anchor_inside_flags', 'AssignResult',
           'MaxIoUAssigner', 'DeltaXYWHAOBBoxCoder']
