from .single_stage import RotatedRetinaNet, RotatedSingleStageDetector
from .two_stage import OrientedRCNN, RotatedTwoStageDetector

__all__ = ['RotatedRetinaNet', 'RotatedSingleStageDetector', 'OrientedRCNN',
           'RotatedTwoStageDetector']
