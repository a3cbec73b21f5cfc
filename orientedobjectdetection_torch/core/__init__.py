from .anchors import RotatedAnchorGenerator, anchor_inside_flags
from .assigners import (AssignResult, MaxIoUAssigner, PseudoSampler,
                        RRandomSampler, SampleKey, SamplingResult,
                        random_sample_masks, rng_from_gt)
from .coders import (DeltaXYWHAOBBoxCoder, MidpointOffsetCoder,
                     poly2obb_from_parallelogram)

__all__ = ['RotatedAnchorGenerator', 'anchor_inside_flags', 'AssignResult',
           'MaxIoUAssigner', 'PseudoSampler', 'RRandomSampler', 'SampleKey',
           'SamplingResult', 'random_sample_masks', 'rng_from_gt',
           'DeltaXYWHAOBBoxCoder', 'MidpointOffsetCoder',
           'poly2obb_from_parallelogram']
