"""Port parity, ReDet (``configs/redet/redet_tiny_synth.py``: ReResNet-18,
a 64-wide ReFPN, the ``RiRoIAlignRotated`` RoI layer, 2 classes, at 128
px) against the JAX package on the same random weights
(:class:`test_torch_rotated_rpn.Family`): the weight mapping, the RoI
head's pooling with the orientation roll, the served detections, and one
train step's losses, gradients and parameter update. The stem stays
trainable at ``frozen_stages=1`` in both packages (layer1 is frozen).

Tolerances: pooled features 1e-5 of their largest value (the same gather
RoIAlign, then an exact roll); head outputs 1e-4; the rest as the harness
states.
"""

import os.path as osp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orientedobjectdetection_tpu.models.backbones.re_resnet import \
    ri_roi_align_rotated as j_ri_align
from orientedobjectdetection_torch.core.assigners import SampleKey
from orientedobjectdetection_torch.parallel import frozen_mask
from test_torch_rotated_rpn import (CONFIGS, FROZEN, SIZE, Family, nchw,
                                    random_levels)
from test_torch_rotated_rpn import jax_draws  # noqa: F401 (a fixture)
from test_torch_two_stage_train import to_torch

torch.set_num_threads(1)

TINY = osp.join(CONFIGS, 'redet', 'redet_tiny_synth.py')


@pytest.fixture(scope='module')
def family():
    return Family(TINY, 90)


def test_weights_round_trip(family):
    family.check_weights()


def test_the_stem_trains_and_layer1_is_frozen(family):
    detector = family.detector()
    mask = frozen_mask(detector, FROZEN)
    assert mask['backbone.conv1.weight'] and mask['backbone.bn1.weight']
    assert not any(v for k, v in mask.items()
                   if k.startswith('backbone.layer1.'))
    assert mask['backbone.layer2.0.conv2.weight']


def rotated_rois(seed, n=60):
    """RoIs over the image, their angles at and beside the roll's bin
    boundaries ``(k + 1/2) pi / 4``."""
    rng = np.random.default_rng(seed)
    rois = np.zeros((2, n, 5), np.float32)
    rois[..., :2] = rng.uniform(16, SIZE - 16, (2, n, 2))
    rois[..., 2:4] = rng.uniform(8, 60, (2, n, 2))
    k = rng.integers(-4, 4, (2, n))
    rois[..., 4] = (k + 0.5) * np.float32(np.pi / 4) + rng.choice(
        [0, 1e-4, -1e-4, 0.3], (2, n))
    return rois


def test_roi_head_pools_rolls_and_classifies_as_jax(family):
    """Serving (the kernel's plain version on the CPU) and training (the
    gather op under autograd) pool, roll and classify as the JAX head."""
    det = family.detector()
    head = det.roi_head
    assert head.rotation_invariant
    feats = random_levels(91, count=4)
    rois = rotated_rois(92)
    rc = head.roi_cfg
    ref = j_ri_align([jnp.asarray(f) for f in feats], jnp.asarray(rois),
                     rc['out_size'], [1.0 / s for s in rc['strides']],
                     rc['sampling_ratio'])
    ref = np.asarray(ref)
    levels = [nchw(f) for f in feats]
    with torch.no_grad():
        served = head.pool(levels, torch.from_numpy(rois))
    trained = head.pool(levels, torch.from_numpy(rois), train=True)
    for got in (served, trained):
        np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
    jroi = family.jax_head('roi_head', 'rcnn')
    r_cls, r_reg = jax.jit(jroi.apply)(
        {'params': family.variables['params']['roi_head']},
        tuple(jnp.asarray(f) for f in feats), jnp.asarray(rois))
    with torch.no_grad():
        cls_score, bbox_pred = head(levels, torch.from_numpy(rois))
    np.testing.assert_allclose(cls_score.numpy(), np.asarray(r_cls),
                               atol=1e-4)
    np.testing.assert_allclose(bbox_pred.numpy(), np.asarray(r_reg),
                               atol=1e-4)


def test_serving_matches_jax(family):
    outputs = family.check_serving()
    assert outputs['proposals'].shape[-1] == 5


def test_train_step_losses_and_gradients_match_jax(family, jax_draws):
    outputs = family.check_step0(['loss_rpn_cls', 'loss_rpn_bbox',
                                  'loss_cls', 'loss_bbox'])
    ref = family.j_outputs
    np.testing.assert_array_equal(outputs['labels'].numpy(),
                                  np.asarray(ref['labels']))
    assert float(family.j_losses['loss_bbox']) > 0


def test_make_train_step_matches_jax(family, jax_draws):
    family.check_train_step()


def test_train_step_samples_with_the_step_key(family):
    """The RoI sampling of a step with the port's own draws: a fixed RoI
    set whose positives come first."""
    detector = family.detector()
    batch = to_torch(family.batch)
    out = detector(batch['images'].permute(0, 3, 1, 2), batch=batch,
                   train=True, rng=SampleKey(step=0))
    assert out['rois'].shape[:2] == out['labels'].shape
    assert (out['labels'][:, 0] < 2).all()
