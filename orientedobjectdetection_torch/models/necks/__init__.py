from ..backbones.re_resnet import ReFPN
from .fpn import FPN

__all__ = ['FPN', 'ReFPN']
