from .single_stage import (RotatedFCOS, RotatedRepPoints, RotatedRetinaNet,
                           RotatedSingleStageDetector, RotatedYOLOv8)
from .refine_detectors import R3Det, S2ANet
from .two_stage import (GlidingVertex, OrientedRCNN, ReDet, RoITransformer,
                        RotatedFasterRCNN, RotatedTwoStageDetector)

__all__ = ['RotatedRetinaNet', 'RotatedFCOS', 'RotatedSingleStageDetector',
           'OrientedRCNN', 'RotatedTwoStageDetector', 'S2ANet', 'R3Det',
           'RotatedFasterRCNN', 'GlidingVertex', 'RoITransformer', 'ReDet',
           'RotatedRepPoints', 'RotatedYOLOv8']
