from .config import Config, ConfigDict
from .registry import (BACKBONES, BBOX_ASSIGNERS, BBOX_CODERS, DETECTORS,
                       HEADS, LOSSES, MODELS, NECKS, PRIOR_GENERATORS,
                       Registry, build_from_cfg)

__all__ = [
    'Config', 'ConfigDict', 'Registry', 'build_from_cfg', 'MODELS',
    'BACKBONES', 'NECKS', 'HEADS', 'DETECTORS', 'LOSSES', 'BBOX_CODERS',
    'BBOX_ASSIGNERS', 'PRIOR_GENERATORS',
]
