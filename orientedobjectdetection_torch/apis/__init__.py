from .inference import (DetectorBundle, inference_detector, init_detector,
                        results_to_per_class)

__all__ = ['DetectorBundle', 'init_detector', 'inference_detector',
           'results_to_per_class']
