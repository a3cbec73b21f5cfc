"""Port parity, Rotated Faster R-CNN
(``configs/rotated_faster_rcnn/rotated_faster_rcnn_tiny_synth.py``: R18,
64-wide FPN, 2 classes, at 128 px) against the JAX package on the same
random weights: the weight mapping, ``RotatedStandardRoIHead``'s pooling,
sampling (the JAX draws swapped in) and decode, the served detections, and
one train step's losses, gradients and parameter update
(:class:`test_torch_rotated_rpn.Family`).

The config's ``RoIAlign`` with ``sampling_ratio=0`` pools with one sample a
bin side in both packages.

Tolerances: RoI-head outputs 1e-4 (float32 FC layers on the same pooled
features); sampled labels and weights exact; the sampled RoIs (the gts'
circumscribed boxes come from float32 sines and cosines) and targets
1e-5; the rest as the harness states.
"""

import os.path as osp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orientedobjectdetection_torch.core.assigners import SampleKey
from test_torch_rotated_rpn import (CONFIGS, SIZE, Family, j_rng, nchw,
                                    random_levels)
from test_torch_rotated_rpn import jax_draws  # noqa: F401 (a fixture)
from test_torch_two_stage_train import to_torch

torch.set_num_threads(1)

TINY = osp.join(CONFIGS, 'rotated_faster_rcnn',
                'rotated_faster_rcnn_tiny_synth.py')


@pytest.fixture(scope='module')
def family():
    return Family(TINY, 60)


def random_props(gts, seed, n=256, valid=200):
    """xyxy proposals around the gts and elsewhere, the last padding."""
    rng = np.random.default_rng(seed)
    props = np.zeros((2, n, 4), np.float32)
    for b in range(2):
        g = gts[b, rng.integers(0, 3, 120)]
        half = np.abs(np.stack([g[:, 2], g[:, 3]], -1)) * rng.uniform(
            0.4, 0.7, (120, 2))
        ctr = g[:, :2] + rng.normal(0, 4, (120, 2))
        near = np.concatenate([ctr - half, ctr + half], -1)
        x1 = rng.uniform(0, SIZE - 40, (valid - 120, 2))
        far = np.concatenate([x1, x1 + rng.uniform(6, 40, x1.shape)], -1)
        props[b, :valid] = np.concatenate([near, far])
    props[0, 7] = props[0, 6]                 # a duplicate proposal
    return props, np.arange(n)[None].repeat(2, 0) < valid


def test_weights_round_trip(family):
    family.check_weights()


def test_roi_head_forward_pools_theta0_at_one_sample(family):
    """xyxy proposals (w and h clipped at 0) through the RoI head, with
    the config's sampling ratio 1."""
    det = family.detector()
    assert det.roi_head.roi_cfg['sampling_ratio'] == 1
    feats = random_levels(61, count=4)
    rng = np.random.default_rng(62)
    x1 = rng.uniform(0, SIZE - 30, (2, 40, 2))
    props = np.concatenate([x1, x1 + rng.uniform(-2, 60, x1.shape)],
                           -1).astype(np.float32)     # some inverted
    jroi = family.jax_head('roi_head', 'rcnn')
    r_cls, r_reg = jax.jit(jroi.apply)(
        {'params': family.variables['params']['roi_head']},
        tuple(jnp.asarray(f) for f in feats), jnp.asarray(props))
    with torch.no_grad():
        cls_score, bbox_pred = det.roi_head([nchw(f) for f in feats],
                                            torch.from_numpy(props))
    np.testing.assert_allclose(cls_score.numpy(), np.asarray(r_cls),
                               atol=1e-4)
    np.testing.assert_allclose(bbox_pred.numpy(), np.asarray(r_reg),
                               atol=1e-4)


def test_sample_rois_matches_jax(family, jax_draws):
    """Assignment on the gts' circumscribed boxes (added first as
    proposals), regression to the rotated gts: RoIs, labels, order,
    weights and targets."""
    gts = family.batch['gt_bboxes']
    props, valid = random_props(gts, 63)
    jroi = family.jax_head('roi_head', 'rcnn')
    ref = jax.jit(jroi.sample_rois)(
        jnp.asarray(props), jnp.asarray(valid), jnp.asarray(gts),
        jnp.asarray(family.batch['gt_labels']),
        jnp.asarray(family.batch['gt_mask']), j_rng(3))
    tb = to_torch(family.batch)
    got = family.detector().roi_head.sample_rois(
        torch.from_numpy(props), torch.from_numpy(valid), tb['gt_bboxes'],
        tb['gt_labels'], tb['gt_mask'], SampleKey(step=3))
    rois, labels, lw, bt, bw, num_pos = got
    assert rois.shape == (2, 128, 5) and (rois[..., 4][lw > 0].abs() <
                                          1e-6).sum() > 100
    np.testing.assert_allclose(rois.numpy(), np.asarray(ref[0]), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(lw.numpy(), np.asarray(ref[2]))
    np.testing.assert_allclose(bt.numpy(), np.asarray(ref[3]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(bw.numpy(), np.asarray(ref[4]))
    assert float(num_pos) == float(ref[5]) and 0 < float(num_pos) <= 64


def test_get_bboxes_matches_jax(family):
    """Decode against theta-0 RoIs and NMS on the same head outputs."""
    rng = np.random.default_rng(64)
    x1 = rng.uniform(0, SIZE - 40, (2, 120, 2))
    rois = np.concatenate([x1, x1 + rng.uniform(4, 40, x1.shape)],
                          -1).astype(np.float32)
    rois[:, -10:] = 0.0
    cls = rng.normal(0, 2, (2, 120, 3)).astype(np.float32)
    reg = rng.normal(0, 0.5, (2, 120, 5)).astype(np.float32)
    cfg = dict(family.jcfg.model['test_cfg']['rcnn'])
    jroi = family.jax_head('roi_head', 'rcnn')
    r_dets, r_labels, r_valid = jax.jit(
        lambda a, b, c: jroi.get_bboxes(a, b, c, cfg=cfg))(
        jnp.asarray(rois), jnp.asarray(cls), jnp.asarray(reg))
    dets, labels, valid = family.detector().roi_head.get_bboxes(
        torch.from_numpy(rois), torch.from_numpy(cls),
        torch.from_numpy(reg), cfg=cfg)
    assert 10 < np.asarray(r_valid).sum(1).min()
    np.testing.assert_array_equal(valid.numpy(), np.asarray(r_valid))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(r_labels))
    np.testing.assert_allclose(dets.numpy(), np.asarray(r_dets), atol=1e-4)


def test_serving_matches_jax(family):
    outputs = family.check_serving()
    assert outputs['proposals'].shape == (2, 256, 4)


def test_train_step_losses_and_gradients_match_jax(family, jax_draws):
    outputs = family.check_step0(['loss_rpn_cls', 'loss_rpn_bbox',
                                  'loss_cls', 'loss_bbox'])
    ref = family.j_outputs
    np.testing.assert_array_equal(outputs['labels'].numpy(),
                                  np.asarray(ref['labels']))
    np.testing.assert_allclose(outputs['rois'].numpy(),
                               np.asarray(ref['rois']), rtol=1e-4,
                               atol=1e-3)
    assert float(family.j_losses['loss_bbox']) > 0


def test_make_train_step_matches_jax(family, jax_draws):
    family.check_train_step()
