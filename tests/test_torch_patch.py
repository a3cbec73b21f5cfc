"""Port parity, huge-image serving (``core/patch.py`` and
``apis/inference.py``): the window planning on a grid of sizes, the merge
of per-window detections, and ``inference_detector_by_patches`` and
``inference_detector_tta`` on a small Rotated RetinaNet (ResNet-18, 32-wide
FPN and head, 4 classes; the weights of ``tests/test_torch_slice.py``
carried across) against the JAX package's, on the CPU.

Windows are exact. The merge of the same detections is exact (it only
translates and selects). Through the network, detections agree to 1e-3 (a
float32 network, as in the slice test) with the same counts and labels."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from orientedobjectdetection_tpu.apis import inference as jinf
from orientedobjectdetection_tpu.core import patch as jpatch
from orientedobjectdetection_tpu.models import build_detector as j_build
from orientedobjectdetection_tpu.utils.config import Config as JConfig
from orientedobjectdetection_torch.apis import (
    inference_detector_by_patches, inference_detector_tta, init_detector)
from orientedobjectdetection_torch.core import patch as ppatch
from orientedobjectdetection_torch.utils import Config
from orientedobjectdetection_torch.utils.jax_weights import \
    from_jax_variables
from test_torch_slice import carried_variables, slice_cfg

torch.set_num_threads(1)

DETS_ATOL = 1e-3


@pytest.mark.parametrize('width,height', [(100, 100), (1024, 1024),
                                          (4000, 4000), (1500, 700),
                                          (300, 2100), (130, 1030)])
@pytest.mark.parametrize('sizes,steps,ratios', [
    ((1024,), (824,), (1.0,)), ((256,), (192,), (0.5, 1.0, 2.0)),
    ((512, 1024), (256, 500), (1.0, 1.5))])
def test_windows_match_jax(width, height, sizes, steps, ratios):
    got = ppatch.get_multiscale_patch(sizes, steps, ratios)
    assert got == jpatch.get_multiscale_patch(sizes, steps, ratios)
    windows = ppatch.slide_window(width, height, *got)
    ref = jpatch.slide_window(width, height, *got)
    assert windows.dtype == np.int64
    np.testing.assert_array_equal(windows, ref)
    assert len(windows) >= 1


def test_slide_window_keeps_the_best_covered_when_none_passes():
    windows = ppatch.slide_window(100, 50, [400], [300], img_rate_thr=0.9)
    np.testing.assert_array_equal(windows, [[0, 0, 400, 400]])
    with pytest.raises(ValueError, match='step'):
        ppatch.slide_window(100, 100, [64], [128])


def window_detections(n_win, k, num_classes, seed):
    rng = np.random.default_rng(seed)
    dets = np.stack([rng.uniform(0, 120, (n_win, k)),
                     rng.uniform(0, 120, (n_win, k)),
                     rng.uniform(6, 30, (n_win, k)),
                     rng.uniform(3, 15, (n_win, k)),
                     rng.uniform(-np.pi / 2, np.pi / 2, (n_win, k)),
                     rng.uniform(0.05, 1, (n_win, k))], -1).astype(np.float32)
    labels = rng.integers(0, num_classes, (n_win, k))
    valid = rng.uniform(0, 1, (n_win, k)) > 0.3
    return dets, np.where(valid, labels, -1), valid


@pytest.mark.parametrize('max_out', [2000, 40])
def test_translate_and_merge_matches_jax(max_out):
    dets, labels, valid = window_detections(6, 50, 3, 0)
    windows = np.array([[0, 0, 128, 128], [100, 0, 128, 128],
                        [0, 100, 128, 128], [100, 100, 128, 128],
                        [50, 50, 128, 128], [200, 0, 128, 128]])
    got = ppatch.translate_and_merge(dets, labels, valid, windows, 3,
                                     max_out=max_out, device='cpu')
    ref = jpatch.translate_and_merge(dets, labels, valid, windows, 3,
                                     max_out=max_out)
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[0], ref[0])
    assert 0 < len(got[0]) <= min(max_out, int(valid.sum()))
    none = ppatch.translate_and_merge(dets, labels, np.zeros_like(valid),
                                      windows, 3, device='cpu')
    assert none[0].shape == (0, 6) and none[1].shape == (0,)


@pytest.fixture(scope='module')
def bundles():
    cfg = slice_cfg()
    det = j_build(cfg['model'])
    variables = carried_variables(det, 3)
    jax_bundle = jinf.DetectorBundle(JConfig(cfg), det, variables)
    port = init_detector(Config(cfg), from_jax_variables(variables),
                         device='cpu')
    return jax_bundle, port


def same_per_class(got, ref):
    assert len(got) == len(ref)
    total = 0
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, atol=DETS_ATOL)
        total += len(g)
    return total


def test_inference_by_patches_matches_jax(bundles):
    jax_bundle, port = bundles
    img = np.random.default_rng(8).integers(0, 256, (260, 300, 3),
                                            np.uint8)
    kwargs = dict(sizes=(128,), steps=(100,), ratios=(1.0,), bs=4)
    got = inference_detector_by_patches(port, img, **kwargs)
    ref = jinf.inference_detector_by_patches(jax_bundle, img, **kwargs)
    assert same_per_class(got, ref) > 20       # the windows found boxes
    # merged in the image frame: centres beyond the first window's reach
    centres = np.concatenate([g[:, :2] for g in got])
    assert centres[:, 0].max() > 128 and centres[:, 1].max() > 128


def test_inference_tta_matches_jax(bundles):
    jax_bundle, port = bundles
    img = np.random.default_rng(9).integers(0, 256, (120, 100, 3), np.uint8)
    got = inference_detector_tta(port, img)
    ref = jinf.inference_detector_tta(jax_bundle, img)
    assert same_per_class(got, ref) > 10
