from .convnext import ConvNeXt
from .re_resnet import ReResNet
from .resnet import ResNet
from .swin import Swin, SwinTransformer

__all__ = ['ResNet', 'SwinTransformer', 'Swin', 'ConvNeXt', 'ReResNet']
