from .single_stage import (RotatedFCOS, RotatedRetinaNet,
                           RotatedSingleStageDetector)
from .refine_detectors import R3Det, S2ANet
from .two_stage import OrientedRCNN, RotatedTwoStageDetector

__all__ = ['RotatedRetinaNet', 'RotatedFCOS', 'RotatedSingleStageDetector',
           'OrientedRCNN', 'RotatedTwoStageDetector', 'S2ANet', 'R3Det']
