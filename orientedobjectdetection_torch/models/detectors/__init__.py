from .single_stage import (RotatedFCOS, RotatedRetinaNet,
                           RotatedSingleStageDetector)
from .two_stage import OrientedRCNN, RotatedTwoStageDetector

__all__ = ['RotatedRetinaNet', 'RotatedFCOS', 'RotatedSingleStageDetector',
           'OrientedRCNN', 'RotatedTwoStageDetector']
