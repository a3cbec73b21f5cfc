from .rotated_anchor_head import RotatedRetinaHead

__all__ = ['RotatedRetinaHead']
