from .oriented_rpn_head import OrientedRPNHead
from .rotated_anchor_head import RotatedRetinaHead

__all__ = ['OrientedRPNHead', 'RotatedRetinaHead']
