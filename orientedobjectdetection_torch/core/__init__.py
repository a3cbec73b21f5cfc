from .anchors import RotatedAnchorGenerator
from .coders import DeltaXYWHAOBBoxCoder

__all__ = ['RotatedAnchorGenerator', 'DeltaXYWHAOBBoxCoder']
