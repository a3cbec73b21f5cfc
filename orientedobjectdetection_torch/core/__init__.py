from .anchors import (MlvlPointGenerator, PseudoAnchorGenerator,
                      RotatedAnchorGenerator, anchor_inside_flags)
from .assigners import (AssignResult, ATSSObbAssigner, MaxIoUAssigner,
                        PseudoSampler, RRandomSampler, SampleKey,
                        SamplingResult, random_sample_masks, rng_from_gt)
from .coders import (CSLCoder, DeltaXYWHAOBBoxCoder, DistanceAnglePointCoder,
                     MidpointOffsetCoder, poly2obb_from_parallelogram)

__all__ = ['RotatedAnchorGenerator', 'PseudoAnchorGenerator',
           'MlvlPointGenerator',
           'anchor_inside_flags', 'AssignResult', 'MaxIoUAssigner',
           'ATSSObbAssigner', 'PseudoSampler', 'RRandomSampler', 'SampleKey',
           'SamplingResult', 'random_sample_masks', 'rng_from_gt',
           'DeltaXYWHAOBBoxCoder', 'MidpointOffsetCoder',
           'DistanceAnglePointCoder', 'CSLCoder',
           'poly2obb_from_parallelogram']
