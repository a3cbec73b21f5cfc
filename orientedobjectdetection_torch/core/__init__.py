from .anchors import (MlvlPointGenerator, PseudoAnchorGenerator,
                      RotatedAnchorGenerator, anchor_inside_flags)
from .assigners import (AssignResult, ATSSKldAssigner, ATSSObbAssigner,
                        MaxIoUAssigner, PseudoSampler, RRandomSampler,
                        SampleKey, SamplingResult, SASAssigner,
                        random_sample_masks, rng_from_gt)
from .coders import (CSLCoder, DeltaXYWHAHBBoxCoder, DeltaXYWHAOBBoxCoder,
                     DeltaXYWHBBoxCoder, DistanceAnglePointCoder, GVFixCoder,
                     GVRatioCoder, MidpointOffsetCoder,
                     poly2obb_from_parallelogram)

__all__ = ['RotatedAnchorGenerator', 'PseudoAnchorGenerator',
           'MlvlPointGenerator',
           'anchor_inside_flags', 'AssignResult', 'MaxIoUAssigner',
           'ATSSObbAssigner', 'ATSSKldAssigner', 'SASAssigner',
           'PseudoSampler', 'RRandomSampler', 'SampleKey',
           'SamplingResult', 'random_sample_masks', 'rng_from_gt',
           'DeltaXYWHAOBBoxCoder', 'MidpointOffsetCoder',
           'DistanceAnglePointCoder', 'CSLCoder', 'DeltaXYWHBBoxCoder',
           'DeltaXYWHAHBBoxCoder', 'GVFixCoder', 'GVRatioCoder',
           'poly2obb_from_parallelogram']
