from .single_stage import RotatedRetinaNet, RotatedSingleStageDetector

__all__ = ['RotatedRetinaNet', 'RotatedSingleStageDetector']
