from .convnext import ConvNeXt
from .csp_darknet import YOLOv8CSPDarknet
from .cspnext import CSPNeXt, CSPNeXtLarge
from .re_resnet import ReResNet
from .resnet import ResNet
from .swin import Swin, SwinTransformer

__all__ = ['ResNet', 'SwinTransformer', 'Swin', 'ConvNeXt', 'ReResNet',
           'CSPNeXt', 'CSPNeXtLarge', 'YOLOv8CSPDarknet']
