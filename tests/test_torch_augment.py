"""Port parity, the augmenting transforms (``datasets/pipelines.py``) and
the rotation they rest on (``utils/image_io.py``), on the CPU.

- ``get_rotation_matrix_2d`` equals ``cv2.getRotationMatrix2D`` exactly;
  ``warp_affine`` lands within 1 of ``cv2.warpAffine`` on random angles,
  odd sizes and both ``auto_bound`` recentrings (OpenCV 5 computes the
  warp in float32; about 1e-5 of the elements differ, by 1, where the
  blend lands next to a half).
- ``PolyRandomRotate``, ``RRandomCrop`` and ``RMosaic`` against the JAX
  package's with the same draws: the port draws from ``results['rng']``,
  and numpy's global functions that JAX calls are patched, in the test
  only, to take the same values from a generator of the same seed, in the
  same order. Images within 1 (the warp) or exact, kept labels exact,
  boxes within 1e-3 px and 1e-4 rad (OpenCV's float32 ``minAreaRect``
  against the port's float64 one, on rotated rectangles).
- ``LoadPatchFromImage`` and ``MultiScaleFlipAug`` (``flip`` kept, never
  applied) exact.
"""

import cv2
import numpy as np
import pytest

from orientedobjectdetection_tpu.datasets import pipelines as jpipe
from orientedobjectdetection_torch.datasets import pipelines as ppipe
from orientedobjectdetection_torch.utils import image_io

BOX_ATOL = 1e-3
ANGLE_ATOL = 1e-4


def bound(h, w, angle):
    c, s = abs(np.cos(np.radians(angle))), abs(np.sin(np.radians(angle)))
    return int(round(h * s + w * c)), int(round(h * c + w * s))


@pytest.mark.parametrize('seed', range(6))
@pytest.mark.parametrize('auto_bound', [False, True])
def test_warp_affine_within_one_of_cv2(seed, auto_bound):
    rng = np.random.default_rng(seed)
    h, w = (int(v) for v in rng.integers(3, 257, 2) | 1)       # odd sizes
    img = rng.integers(0, 256, (h, w, 3), np.uint8)
    differ = total = 0
    for angle in np.concatenate([rng.uniform(-180, 180, 4),
                                 [0.0, 90.0, -180.0, 45.0]]):
        m = cv2.getRotationMatrix2D((w / 2, h / 2), float(angle), 1)
        np.testing.assert_array_equal(image_io.get_rotation_matrix_2d(
            (w / 2, h / 2), float(angle)), m)
        size = (w, h)
        if auto_bound:
            size = bound(h, w, angle)
            m[0, 2] += size[0] / 2 - w / 2
            m[1, 2] += size[1] / 2 - h / 2
        ref = cv2.warpAffine(img, m, size)
        got = image_io.warp_affine(img, m, size)
        assert got.shape == ref.shape and got.dtype == np.uint8
        diff = np.abs(got.astype(int) - ref)
        assert diff.max() <= 1
        differ += int((diff > 0).sum())
        total += diff.size
    assert differ / total < 1e-3
    # one channel, and a quarter turn that is an exact copy
    np.testing.assert_array_equal(
        image_io.warp_affine(img[..., 0], np.array([[1., 0, 0], [0, 1, 0]]),
                             (w, h)), img[..., 0])


def test_warp_affine_refuses_float():
    with pytest.raises(ValueError, match='uint8'):
        image_io.warp_affine(np.zeros((4, 4, 3), np.float32),
                             np.eye(2, 3), (4, 4))


class SameDraws:
    """numpy's global draws for the JAX transform, taken from a generator
    of ``seed`` as the port takes them from ``results['rng']``."""

    def __init__(self, monkeypatch, seed):
        rng = np.random.default_rng(seed)
        monkeypatch.setattr(np.random, 'rand', lambda: rng.random())
        monkeypatch.setattr(np.random, 'choice', lambda a: rng.choice(a))
        monkeypatch.setattr(np.random, 'randint',
                            lambda lo, hi, size=None: rng.integers(lo, hi,
                                                                   size))
        monkeypatch.setattr(np.random, 'uniform',
                            lambda lo, hi: rng.uniform(lo, hi))


def sample(seed, h=96, w=128, n=6, labels=None):
    rng = np.random.default_rng(seed)
    boxes = np.stack([rng.uniform(25, w - 25, n), rng.uniform(25, h - 25, n),
                      rng.uniform(12, 30, n), rng.uniform(7, 11, n),
                      rng.uniform(-np.pi / 2, np.pi / 2, n)],
                     -1).astype(np.float32)
    lab = np.arange(n) % 3 if labels is None else np.asarray(labels)
    return dict(img=rng.integers(0, 256, (h, w, 3), np.uint8),
                img_shape=(h, w, 3), gt_bboxes=boxes,
                gt_labels=lab.astype(np.int64))


def copy(results):
    return {k: (v.copy() if isinstance(v, np.ndarray) else v)
            for k, v in results.items()}


def same_boxes(got, ref):
    assert got['gt_bboxes'].shape == ref['gt_bboxes'].shape
    np.testing.assert_array_equal(got['gt_labels'], ref['gt_labels'])
    np.testing.assert_allclose(got['gt_bboxes'][:, :4],
                               ref['gt_bboxes'][:, :4], atol=BOX_ATOL)
    gap = (got['gt_bboxes'][:, 4] - ref['gt_bboxes'][:, 4] + np.pi / 2) \
        % np.pi - np.pi / 2
    assert np.abs(gap).max(initial=0) <= ANGLE_ATOL


@pytest.mark.parametrize('seed', range(8))
@pytest.mark.parametrize('kwargs', [
    dict(rotate_ratio=0.7),
    dict(rotate_ratio=1.0, auto_bound=True),
    dict(rotate_ratio=1.0, mode='value', angles_range=[30, -60, 135]),
    dict(rotate_ratio=1.0, rect_classes=[2]),
    dict(rotate_ratio=0.0)])
def test_poly_random_rotate_matches_jax(monkeypatch, seed, kwargs):
    results = sample(seed)
    port = ppipe.PolyRandomRotate(version='le90', **kwargs)
    got = port(dict(copy(results), rng=np.random.default_rng(100 + seed)))
    SameDraws(monkeypatch, 100 + seed)
    ref = jpipe.PolyRandomRotate(version='le90', **kwargs)(copy(results))
    assert (got is None) == (ref is None)
    if ref is None:
        return
    assert got['rotate'] == ref['rotate']
    assert got['rotate_angle'] == ref['rotate_angle']
    assert tuple(got['img_shape']) == tuple(ref['img_shape'])
    assert np.abs(got['img'].astype(int) - ref['img']).max() <= 1
    same_boxes(got, ref)
    if kwargs.get('rect_classes'):                  # snapped to ±90 / ±180
        assert abs(got['rotate_angle']) in (90.0, 180.0)


def test_poly_random_rotate_drops_and_returns_none():
    """A box whose centre leaves the turned image, or with a side of 5 px
    or less, is dropped; with none left the sample is dropped."""
    t = ppipe.PolyRandomRotate(rotate_ratio=1.0, version='le90')
    results = sample(0, n=2)
    results['gt_bboxes'][0] = [126, 48, 20, 10, 0]      # at the right edge
    results['gt_bboxes'][1] = [64, 48, 20, 4, 0]        # too thin
    assert t.rotate(copy(results), 90.0) is None
    kept = ppipe.PolyRandomRotate(allow_negative=True,
                                  version='le90').rotate(copy(results), 90.0)
    assert kept['gt_bboxes'].shape == (0, 5)
    results['gt_bboxes'][1] = [64, 48, 20, 10, 0]
    out = t.rotate(copy(results), 90.0)
    np.testing.assert_allclose(out['gt_bboxes'][0, :4], [64, 48, 20, 10],
                               atol=1e-4)


@pytest.mark.parametrize('seed', range(4))
@pytest.mark.parametrize('crop_size,crop_type', [((64, 80), 'absolute'),
                                                 ((0.5, 0.7), 'relative'),
                                                 ((200, 300), 'absolute')])
def test_rrandom_crop_matches_jax(monkeypatch, seed, crop_size, crop_type):
    results = sample(seed)
    results['gt_bboxes_ignore'] = sample(seed + 50)['gt_bboxes']
    kw = dict(crop_size=crop_size, crop_type=crop_type,
              allow_negative_crop=True)
    got = ppipe.RRandomCrop(**kw)(dict(copy(results),
                                       rng=np.random.default_rng(seed)))
    SameDraws(monkeypatch, seed)
    ref = jpipe.RRandomCrop(**kw)(copy(results))
    for key in ('img', 'gt_bboxes', 'gt_labels', 'gt_bboxes_ignore'):
        np.testing.assert_array_equal(got[key], ref[key])
    assert tuple(got['img_shape']) == tuple(ref['img_shape'])


def test_rrandom_crop_drops_an_empty_crop():
    results = sample(0, n=1)
    results['gt_bboxes'][0, :2] = (100, 80)
    t = ppipe.RRandomCrop(crop_size=(40, 40))
    assert t.crop(copy(results), 0, 0) is None
    assert len(t.crop(copy(results), 80, 50)['gt_bboxes']) == 1


def mosaic_inputs(seed):
    results = sample(seed, h=96, w=128)
    results['mix_results'] = [sample(seed + k, h=64 + 16 * k, w=80, n=3)
                              for k in (1, 2, 3)]
    for s in results['mix_results']:
        s['img'] = s['img'].astype(np.float32)          # mixed dtypes
    return results


@pytest.mark.parametrize('seed', range(4))
@pytest.mark.parametrize('img_scale', [(128, 128), (96, 160)])
def test_rmosaic_matches_jax(monkeypatch, seed, img_scale):
    results = mosaic_inputs(seed)
    got = ppipe.RMosaic(img_scale=img_scale)(
        dict(copy(results), mix_results=results['mix_results'],
             rng=np.random.default_rng(seed)))
    SameDraws(monkeypatch, seed)
    ref = jpipe.RMosaic(img_scale=img_scale)(
        dict(copy(results), mix_results=results['mix_results']))
    assert got['img'].dtype == np.float32
    assert got['img'].shape == (2 * img_scale[0], 2 * img_scale[1], 3)
    for key in ('img', 'gt_bboxes', 'gt_labels'):
        np.testing.assert_array_equal(got[key], ref[key])
    assert (got['img'] == 114).any()                    # the pad value


def test_rmosaic_without_mix_passes_through():
    results = sample(0)
    assert ppipe.RMosaic()(dict(results, rng=None))['img'] is results['img']


@pytest.mark.parametrize('win', [(0, 0, 64, 64), (100, 50, 64, 64),
                                 (120, 90, 32, 48)])
@pytest.mark.parametrize('to_float32', [False, True])
def test_load_patch_matches_jax(win, to_float32):
    img = np.random.default_rng(1).integers(0, 256, (96, 128, 3), np.uint8)
    got = ppipe.LoadPatchFromImage(to_float32)(dict(img=img, win=win))
    ref = jpipe.LoadPatchFromImage(to_float32)(dict(img=img, win=win))
    for key in ('img', 'scale_factor'):
        np.testing.assert_array_equal(got[key], ref[key])
        assert got[key].dtype == ref[key].dtype
    assert got['img_shape'] == ref['img_shape'] == (win[3], win[2], 3)


@pytest.mark.parametrize('img_scale', [(64, 64), [(64, 64), (32, 48)]])
def test_multiscale_flip_aug_matches_jax(img_scale):
    """``flip=True`` is kept and not applied, a list of scales returns a
    list (the JAX package's behaviour; ROADMAP C)."""
    img = np.random.default_rng(2).integers(0, 256, (96, 128, 3), np.uint8)
    transforms = [dict(type='RResize'), dict(type='Pad', size_divisor=32),
                  dict(type='Collect', keys=['img'])]
    got = ppipe.MultiScaleFlipAug(transforms, img_scale=img_scale,
                                  flip=True)(dict(img=img, img_shape=(96,
                                                                      128,
                                                                      3)))
    ref = jpipe.MultiScaleFlipAug(transforms, img_scale=img_scale,
                                  flip=True)(dict(img=img, img_shape=(96,
                                                                      128,
                                                                      3)))
    got, ref = ([got], [ref]) if isinstance(img_scale, tuple) else (got, ref)
    assert len(got) == len(ref) == (1 if isinstance(img_scale, tuple)
                                    else 2)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g['img'], r['img'])
        assert g['img_metas']['flip'] is False and \
            g['img_metas']['flip_direction'] is None
