from .config import Config, ConfigDict
from .registry import (BACKBONES, BBOX_CODERS, DETECTORS, HEADS, MODELS,
                       NECKS, PRIOR_GENERATORS, Registry, build_from_cfg)

__all__ = [
    'Config', 'ConfigDict', 'Registry', 'build_from_cfg', 'MODELS',
    'BACKBONES', 'NECKS', 'HEADS', 'DETECTORS', 'BBOX_CODERS',
    'PRIOR_GENERATORS',
]
