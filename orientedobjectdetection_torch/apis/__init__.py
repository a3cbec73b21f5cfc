from .inference import (DetectorBundle, inference_detector,
                        inference_detector_by_patches, inference_detector_tta,
                        init_detector, results_to_per_class)

__all__ = ['DetectorBundle', 'init_detector', 'inference_detector',
           'inference_detector_by_patches', 'inference_detector_tta',
           'results_to_per_class']
