"""Port parity, the whole inference slice: a small Rotated RetinaNet
(ResNet-18, 32-wide FPN and head, 4 classes) on two 128 px images, JAX
``DetectorBundle`` (apply + bboxes_from_outputs) against the port's
``init_detector`` bundle on weights carried by ``from_jax_variables``.

Labels and valid flags must match exactly, detections to 1e-3 (float32
network, then decode and NMS on the same candidates)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _retina_cfg
from orientedobjectdetection_tpu.apis.inference import \
    DetectorBundle as JBundle
from orientedobjectdetection_tpu.models import build_detector as j_build
from orientedobjectdetection_tpu.utils.config import Config as JConfig
from orientedobjectdetection_torch.apis import (inference_detector,
                                                init_detector)
from orientedobjectdetection_torch.utils import Config
from orientedobjectdetection_torch.utils.jax_weights import \
    from_jax_variables

torch.set_num_threads(1)

SIZE = 128


def slice_cfg():
    model = _retina_cfg(num_classes=4, depth=18, channels=32, stacked=1)
    model['test_cfg'].update(max_candidates=256, max_per_img=300)
    return dict(model=model, pad_size=(SIZE, SIZE))


def carried_variables(det, seed):
    """JAX init, then random frozen BN and a zero class bias: with the focal
    prior (-4.6) every score would sit below score_thr and NMS would see
    padding only. Regression weights are scaled down (see below)."""
    variables = jax.jit(det.init)(jax.random.PRNGKey(seed),
                                  jnp.zeros((1, SIZE, SIZE, 3)))
    variables = jax.tree_util.tree_map(np.array, variables)   # writable
    rng = np.random.default_rng(seed)
    for path, leaf in jax.tree_util.tree_leaves_with_path(variables):
        name = path[-1].key
        if name in ('scale', 'var'):
            leaf[...] = rng.uniform(0.5, 1.5, leaf.shape)
        elif name in ('bias', 'mean'):
            leaf[...] = rng.normal(0, 0.1, leaf.shape)
    head = variables['params']['bbox_head']
    head['cls_out']['bias'][...] = 0.0
    # deltas of a trained head: boxes near their anchors, inside the image
    head['reg_out']['kernel'] *= 0.05
    return variables


def test_slice_matches_jax():
    cfg = slice_cfg()
    det = j_build(cfg['model'])
    variables = carried_variables(det, 3)
    images = np.random.default_rng(4).normal(
        0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    rd, rl, rv = JBundle(JConfig(cfg), det, variables)(jnp.asarray(images))

    bundle = init_detector(Config(cfg), from_jax_variables(variables),
                           device='cpu')
    dets, labels, valid = bundle(torch.from_numpy(images))
    rv = np.asarray(rv)
    assert rv.sum() > 20                       # NMS saw real boxes
    assert rv.sum(1).max() < 256               # and suppressed some
    np.testing.assert_array_equal(valid.numpy(), rv)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(rl))
    np.testing.assert_allclose(dets.numpy(), np.asarray(rd), atol=1e-3)

    # the single-image entry point gives image 0's detections per class
    per_class = inference_detector(bundle, images[0], img_norm_cfg=dict(
        mean=[0., 0., 0.], std=[1., 1., 1.], to_rgb=False))
    for c, arr in enumerate(per_class):
        m = rv[0] & (np.asarray(rl)[0] == c)
        np.testing.assert_allclose(arr, np.asarray(rd)[0][m], atol=1e-3)


def test_init_detector_on_missing_card_raises():
    """The entry points default to the card and never fall back to the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        init_detector(Config(slice_cfg()))
