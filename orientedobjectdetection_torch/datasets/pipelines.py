"""Host-side data pipeline transforms in numpy (counterpart of
``orientedobjectdetection_tpu/datasets/pipelines.py``; reference
``datasets/pipelines/transforms.py`` and ``loading.py``).

Each transform is a callable over a results dict (mmcv's keys: ``img``
``(H, W, 3)`` BGR, ``img_shape``, ``ori_shape``, ``pad_shape``,
``scale_factor``, ``gt_bboxes (N, 5)``, ``gt_labels (N,)``, ``filename``).
Images are read and resized by :mod:`..utils.image_io`, not OpenCV. The one
random transform, :class:`RRandomFlip`, draws from an explicit
``np.random.Generator``: the sample's own, ``results['rng']``, which the
dataset puts there.
"""

from __future__ import annotations

import os.path as osp
from typing import Optional, Sequence, Tuple

import numpy as np

from ..ops.boxes import norm_angle
from ..utils.image_io import imread, resize_bilinear
from ..utils.registry import PIPELINES


@PIPELINES.register_module()
class LoadImageFromFile:
    """Reads the image with :func:`imread`. ``cache='ram'`` keeps every
    decoded uint8 image of this transform in memory, keyed by path: the
    first epoch decodes, later epochs do not."""

    def __init__(self, to_float32: bool = False, color_type: str = 'color',
                 cache: str = 'none'):
        self.to_float32 = to_float32
        self.cache = cache
        self._cache = {}

    def __call__(self, results):
        path = results.get('img_prefix')
        fname = results['img_info']['filename']
        full = osp.join(path, fname) if path else fname
        img = self._cache.get(full) if self.cache == 'ram' else None
        if img is None:
            if not osp.isfile(full):
                raise FileNotFoundError(full)
            img = imread(full)
            if self.cache == 'ram':
                img.setflags(write=False)
                self._cache[full] = img
        if self.to_float32:
            img = img.astype(np.float32)
        results['filename'] = full
        results['ori_filename'] = fname
        results['img'] = img
        results['img_shape'] = img.shape
        results['ori_shape'] = img.shape
        results['scale_factor'] = np.array([1., 1., 1., 1.], np.float32)
        return results


@PIPELINES.register_module()
class LoadAnnotations:
    def __init__(self, with_bbox: bool = True, with_label: bool = True):
        self.with_bbox = with_bbox
        self.with_label = with_label

    def __call__(self, results):
        ann = results['ann_info']
        if self.with_bbox:
            results['gt_bboxes'] = ann['bboxes'].astype(np.float32).copy()
            results['gt_bboxes_ignore'] = ann.get(
                'bboxes_ignore', np.zeros((0, 5), np.float32)).copy()
        if self.with_label:
            results['gt_labels'] = ann['labels'].astype(np.int64).copy()
        return results


def rescale_size(old_size, scale):
    """mmcv's keep-ratio target size ``(w, h)``."""
    w, h = old_size
    if isinstance(scale, (int, float)):
        factor = scale
    else:
        max_long, max_short = max(scale), min(scale)
        factor = min(max_long / max(h, w), max_short / min(h, w))
    return int(w * factor + 0.5), int(h * factor + 0.5)


@PIPELINES.register_module()
class RResize:
    """Keep-ratio resize; rotated boxes scale their centres by (sx, sy) and
    their sides by sqrt(sx * sy) (reference ``transforms.py:38-48``)."""

    def __init__(self, img_scale=None, multiscale_mode='range',
                 ratio_range=None):
        self.img_scale = img_scale

    def __call__(self, results):
        img = results['img']
        h, w = img.shape[:2]
        scale = results.get('scale', self.img_scale)
        if isinstance(scale, list):
            scale = scale[0]
        new_w, new_h = rescale_size((w, h), scale)
        resized = resize_bilinear(img, (new_w, new_h))
        w_scale = new_w / w
        h_scale = new_h / h
        results['img'] = resized
        results['img_shape'] = resized.shape
        results['scale_factor'] = np.array(
            [w_scale, h_scale, w_scale, h_scale], np.float32)
        for key in ('gt_bboxes', 'gt_bboxes_ignore'):
            if key in results and len(results[key]):
                b = results[key]
                b[:, 0] *= w_scale
                b[:, 1] *= h_scale
                b[:, 2:4] *= np.sqrt(w_scale * h_scale)
                results[key] = b
        return results


@PIPELINES.register_module()
class RRandomFlip:
    """Random flip with the convention's angle remap (reference
    ``transforms.py:51-98``). It draws from ``results['rng']``, the
    dataset's generator of this fetch (the JAX package draws from numpy's
    global generator); a ``flip`` already in the results is kept."""

    def __init__(self, flip_ratio=None, direction='horizontal',
                 version: str = 'oc'):
        self.flip_ratio = flip_ratio
        self.direction = direction
        self.version = version

    def bbox_flip(self, bboxes, img_shape, direction):
        flipped = bboxes.copy()
        if direction == 'horizontal':
            flipped[:, 0] = img_shape[1] - bboxes[:, 0] - 1
        elif direction == 'vertical':
            flipped[:, 1] = img_shape[0] - bboxes[:, 1] - 1
        elif direction == 'diagonal':
            flipped[:, 0] = img_shape[1] - bboxes[:, 0] - 1
            flipped[:, 1] = img_shape[0] - bboxes[:, 1] - 1
            return flipped
        else:
            raise ValueError(direction)
        if self.version == 'oc':
            rot = bboxes[:, 4] != np.pi / 2
            flipped[rot, 4] = np.pi / 2 - bboxes[rot, 4]
            flipped[rot, 2] = bboxes[rot, 3]
            flipped[rot, 3] = bboxes[rot, 2]
        else:
            flipped[:, 4] = norm_angle(np.pi - bboxes[:, 4], self.version)
        return flipped

    def __call__(self, results):
        if 'flip' not in results:
            results['flip'] = bool(
                results['rng'].random() < (self.flip_ratio or 0))
            results['flip_direction'] = self.direction
        if results['flip']:
            axis = 0 if results['flip_direction'] == 'vertical' else 1
            results['img'] = np.ascontiguousarray(
                np.flip(results['img'], axis=axis))
            if results['flip_direction'] == 'diagonal':
                results['img'] = np.ascontiguousarray(
                    np.flip(results['img'], axis=0))
            for key in ('gt_bboxes', 'gt_bboxes_ignore'):
                if key in results and len(results[key]):
                    results[key] = self.bbox_flip(
                        results[key], results['img_shape'],
                        results['flip_direction'])
        return results


@PIPELINES.register_module()
class Normalize:
    def __init__(self, mean, std, to_rgb: bool = True):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.to_rgb = to_rgb

    def __call__(self, results):
        img = results['img'].astype(np.float32)
        if self.to_rgb:
            img = img[..., ::-1]
        results['img'] = (img - self.mean) / self.std
        results['img_norm_cfg'] = dict(mean=self.mean, std=self.std,
                                       to_rgb=self.to_rgb)
        return results


@PIPELINES.register_module()
class Pad:
    def __init__(self, size: Optional[Tuple[int, int]] = None,
                 size_divisor: Optional[int] = None, pad_val: float = 0):
        self.size = size
        self.size_divisor = size_divisor
        self.pad_val = pad_val

    def __call__(self, results):
        img = results['img']
        h, w = img.shape[:2]
        if self.size is not None:
            th, tw = self.size
        else:
            d = self.size_divisor
            th, tw = -(-h // d) * d, -(-w // d) * d
        padded = np.full((th, tw) + img.shape[2:], self.pad_val, img.dtype)
        padded[:h, :w] = img
        results['img'] = padded
        results['pad_shape'] = padded.shape
        return results


@PIPELINES.register_module()
class DefaultFormatBundle:
    def __call__(self, results):
        return results


@PIPELINES.register_module()
class Collect:
    def __init__(self, keys: Sequence[str],
                 meta_keys=('filename', 'ori_filename', 'ori_shape',
                            'img_shape', 'pad_shape', 'scale_factor', 'flip',
                            'flip_direction')):
        self.keys = keys
        self.meta_keys = meta_keys

    def __call__(self, results):
        out = {k: results[k] for k in self.keys if k in results}
        out['img_metas'] = {k: results.get(k) for k in self.meta_keys}
        return out


@PIPELINES.register_module()
class MultiScaleFlipAug:
    """Test-time wrapper: each scale without a flip (the flip variants of
    test-time augmentation are ROADMAP A.5)."""

    def __init__(self, transforms, img_scale=None, flip=False,
                 flip_direction='horizontal'):
        if flip:
            raise NotImplementedError('MultiScaleFlipAug(flip=True) is '
                                      'test-time augmentation, ROADMAP A.5')
        self.transforms = Compose(transforms)
        self.img_scale = img_scale if isinstance(img_scale, list) \
            else [img_scale]

    def __call__(self, results):
        outs = []
        for scale in self.img_scale:
            r = dict(results)
            r['scale'] = scale
            r['flip'] = False
            r['flip_direction'] = None
            outs.append(self.transforms(r))
        return outs[0] if len(outs) == 1 else outs


class Compose:
    """A pipeline of transforms, each a callable or a config dict."""

    def __init__(self, transforms):
        self.transforms = [PIPELINES.build(dict(t)) if isinstance(t, dict)
                           else t for t in transforms]

    def __call__(self, results):
        for t in self.transforms:
            results = t(results)
            if results is None:
                return None
        return results


def _not_ported(name):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f'{name} is not ported yet (ROADMAP A.4b)')
    return type(name, (), {'__init__': __init__,
                           '__doc__': f'JAX ``datasets/pipelines.py:{name}``'
                                      ': not ported yet (ROADMAP A.4b).'})


for _name in ('PolyRandomRotate', 'RRandomCrop', 'RMosaic',
              'LoadPatchFromImage'):
    PIPELINES.register_module(module=_not_ported(_name))
