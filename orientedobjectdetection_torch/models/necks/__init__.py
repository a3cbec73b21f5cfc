from ..backbones.re_resnet import ReFPN
from .fpn import FPN
from .pafpn import YOLOv8PAFPN, YOLOv8PAFPN_E

__all__ = ['FPN', 'ReFPN', 'YOLOv8PAFPN', 'YOLOv8PAFPN_E']
