"""Host-side data pipeline transforms in numpy (counterpart of
``orientedobjectdetection_tpu/datasets/pipelines.py``; reference
``datasets/pipelines/transforms.py`` and ``loading.py``).

Each transform is a callable over a results dict (mmcv's keys: ``img``
``(H, W, 3)`` BGR, ``img_shape``, ``ori_shape``, ``pad_shape``,
``scale_factor``, ``gt_bboxes (N, 5)``, ``gt_labels (N,)``, ``filename``).
Images are read, resized and rotated by :mod:`..utils.image_io`, not
OpenCV. The random transforms (:class:`RRandomFlip`,
:class:`PolyRandomRotate`, :class:`RRandomCrop`, :class:`RMosaic`) draw
from an explicit ``np.random.Generator``: the sample's own,
``results['rng']``, which the dataset puts there (the JAX package draws
from numpy's global generator). Each of the last three takes its draws in
one method and applies them in another (``rotate``, ``crop``, ``mosaic``),
which the parity tests call with given draws.
"""

from __future__ import annotations

import os.path as osp
from typing import Optional, Sequence, Tuple

import numpy as np

from ..ops.boxes import norm_angle, obb2poly_np, poly2obb_np
from ..utils.image_io import (get_rotation_matrix_2d, imread,
                              resize_bilinear, warp_affine)
from ..utils.registry import PIPELINES


@PIPELINES.register_module()
class LoadImageFromFile:
    """Reads the image (PNG, JPEG, BMP or TIFF) with :func:`imread`, as
    ``cv2.imread(path, cv2.IMREAD_COLOR)`` reads it. ``cache='ram'`` keeps
    every decoded uint8 image of this transform in memory, keyed by path:
    the first epoch decodes, later epochs do not."""

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
    """Test-time wrapper: the transforms once per scale, a list for a list
    of scales. ``flip`` is kept and never applied, as in the JAX package
    (flip test-time augmentation is :func:`..apis.inference.
    inference_detector_tta`; ROADMAP C, reference behaviour)."""

    def __init__(self, transforms, img_scale=None, flip=False,
                 flip_direction='horizontal'):
        self.transforms = Compose(transforms)
        self.img_scale = img_scale if isinstance(img_scale, list) \
            else [img_scale]
        self.flip = flip
        self.flip_direction = flip_direction

    def __call__(self, results):
        outs = []
        for scale in self.img_scale:
            r = dict(results)
            r['scale'] = scale
            r['flip'] = False
            r['flip_direction'] = None
            outs.append(self.transforms(r))
        return outs[0] if len(outs) == 1 else outs


@PIPELINES.register_module()
class PolyRandomRotate:
    """Random rotation (reference ``transforms.py:101-277``): the image
    through :func:`warp_affine` about its centre, each gt box through its
    polygon (:func:`obb2poly_np`), the same map in float64 and
    :func:`poly2obb_np`; boxes whose centre leaves the image or with a side
    of 5 px or less are dropped, and with none left the sample is dropped
    (``None``) unless ``allow_negative``. A sample not drawn for rotation
    goes through the same at angle 0."""

    def __init__(self, rotate_ratio: float = 0.5, mode: str = 'range',
                 angles_range=180, auto_bound: bool = False,
                 rect_classes=None, allow_negative: bool = False,
                 version: str = 'le90'):
        if mode not in ('range', 'value'):
            raise ValueError(f'mode must be range or value, got {mode!r}')
        self.rotate_ratio = rotate_ratio
        self.mode = mode
        self.angles_range = angles_range
        self.auto_bound = auto_bound
        self.rect_classes = rect_classes or []
        self.allow_negative = allow_negative
        self.version = version
        self.discrete_range = [90, 180, -90, -180]

    def draw(self, results, rng: np.random.Generator) -> Optional[float]:
        """The angle in degrees, in the JAX package's order of draws: the
        ratio, then the angle, then the snap of a ``rect_classes`` gt to
        ±90 / ±180; None when the sample is not rotated."""
        if rng.random() >= self.rotate_ratio:
            return None
        if self.mode == 'range':
            angle = float(self.angles_range) * (2 * rng.random() - 1)
        else:
            angle = float(rng.choice(self.angles_range))
        if self.rect_classes and any(int(c) in self.rect_classes
                                     for c in results.get('gt_labels', [])):
            angle = float(rng.choice(self.discrete_range))
        return angle

    def __call__(self, results):
        angle = self.draw(results, results['rng'])
        results['rotate'] = angle is not None
        return self.rotate(results, angle or 0.0)

    def rotate(self, results, angle: float):
        results['rotate_angle'] = angle
        img = results['img']
        h, w = img.shape[:2]
        c = img.shape[2] if img.ndim == 3 else 1
        center = (w / 2, h / 2)
        abs_cos = abs(np.cos(np.radians(angle)))
        abs_sin = abs(np.sin(np.radians(angle)))
        if self.auto_bound:
            bound_w = int(round(h * abs_sin + w * abs_cos))
            bound_h = int(round(h * abs_cos + w * abs_sin))
        else:
            bound_w, bound_h = w, h
        rm = get_rotation_matrix_2d(center, angle, 1)
        if self.auto_bound:
            rm[0, 2] += bound_w / 2 - center[0]
            rm[1, 2] += bound_h / 2 - center[1]
        results['img'] = warp_affine(img, rm, (bound_w, bound_h))
        results['img_shape'] = (bound_h, bound_w, c)

        gt = results.get('gt_bboxes', np.zeros((0, 5), np.float32))
        labels = results.get('gt_labels', np.zeros((0,), np.int64))
        if len(gt):
            with_score = np.concatenate(
                [gt, np.zeros((gt.shape[0], 1), np.float32)], -1)
            pts = obb2poly_np(with_score, self.version)[:, :8] \
                .reshape(-1, 2).astype(np.float64)
            # cv2.transform's order: m00 * x + m01 * y + m02
            pts = np.stack([rm[0, 0] * pts[:, 0] + rm[0, 1] * pts[:, 1] +
                            rm[0, 2],
                            rm[1, 0] * pts[:, 0] + rm[1, 1] * pts[:, 1] +
                            rm[1, 2]], -1)
            obbs = []
            for p in pts.reshape(-1, 8):
                o = poly2obb_np(p.astype(np.float32), self.version)
                obbs.append(o if o is not None else (0, 0, 0, 0, 0))
            gt = np.asarray(obbs, np.float32)
            keep = (gt[:, 0] > 0) & (gt[:, 0] < bound_w) & \
                   (gt[:, 1] > 0) & (gt[:, 1] < bound_h) & \
                   (gt[:, 2] > 5) & (gt[:, 3] > 5)
            gt = gt[keep]
            labels = labels[keep]
        if len(gt) == 0 and not self.allow_negative:
            return None
        results['gt_bboxes'] = gt
        results['gt_labels'] = labels
        return results


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


@PIPELINES.register_module()
class RRandomCrop:
    """Random crop keeping the boxes whose centre stays inside it
    (reference ``transforms.py:280-384``); with no gt left the sample is
    dropped (``None``) unless ``allow_negative_crop``."""

    def __init__(self, crop_size, crop_type: str = 'absolute',
                 allow_negative_crop: bool = False, iof_thr: float = 0.7,
                 version: str = 'oc'):
        self.crop_size = crop_size
        self.crop_type = crop_type
        self.allow_negative_crop = allow_negative_crop
        self.iof_thr = iof_thr
        self.version = version

    def crop_shape(self, h: int, w: int) -> Tuple[int, int]:
        if self.crop_type == 'absolute':
            ch, cw = self.crop_size
        else:                                           # relative
            ch, cw = int(h * self.crop_size[0]), int(w * self.crop_size[1])
        return min(ch, h), min(cw, w)

    def __call__(self, results):
        h, w = results['img'].shape[:2]
        ch, cw = self.crop_shape(h, w)
        rng = results['rng']
        y0 = int(rng.integers(0, h - ch + 1))
        x0 = int(rng.integers(0, w - cw + 1))
        return self.crop(results, x0, y0)

    def crop(self, results, x0: int, y0: int):
        img = results['img']
        ch, cw = self.crop_shape(*img.shape[:2])
        results['img'] = img[y0:y0 + ch, x0:x0 + cw]
        results['img_shape'] = results['img'].shape
        for key in ('gt_bboxes', 'gt_bboxes_ignore'):
            if key in results and len(results[key]):
                b = results[key].copy()
                b[:, 0] -= x0
                b[:, 1] -= y0
                keep = (b[:, 0] >= 0) & (b[:, 0] < cw) & \
                       (b[:, 1] >= 0) & (b[:, 1] < ch)
                results[key] = b[keep]
                if key == 'gt_bboxes':
                    results['gt_labels'] = results['gt_labels'][keep]
        if not self.allow_negative_crop and \
                len(results.get('gt_bboxes', [])) == 0:
            return None
        return results


@PIPELINES.register_module()
class RMosaic:
    """Four-image rotated mosaic (reference ``transforms.py:387-562``) on a
    ``(2h, 2w, 3)`` float32 canvas filled with ``pad_val``: the sample and
    the three of ``results['mix_results']`` (which
    :class:`..datasets.wrappers.MultiImageMixDataset` puts there) around a
    random centre, each box kept while its centre lies strictly inside the
    canvas. Without three mix samples the results pass through."""

    def __init__(self, img_scale=(1024, 1024), center_ratio_range=(0.5, 1.5),
                 pad_val: float = 114.0, version: str = 'le90'):
        self.img_scale = img_scale
        self.center_ratio_range = center_ratio_range
        self.pad_val = pad_val
        self.version = version

    def __call__(self, results):
        mix = results.get('mix_results')
        if not mix or len(mix) < 3:
            return results
        h, w = self.img_scale
        rng = results['rng']
        cy = int(rng.uniform(*self.center_ratio_range) * h)
        cx = int(rng.uniform(*self.center_ratio_range) * w)
        return self.mosaic(results, cx, cy)

    def mosaic(self, results, cx: int, cy: int):
        h, w = self.img_scale
        canvas = np.full((2 * h, 2 * w, 3), self.pad_val, np.float32)
        samples = [results] + list(results['mix_results'][:3])
        all_boxes, all_labels = [], []
        for s, (ix, iy) in zip(samples, ((0, 0), (1, 0), (0, 1), (1, 1))):
            img = s['img']
            ih, iw = img.shape[:2]
            x1 = cx if ix else max(cx - iw, 0)
            y1 = cy if iy else max(cy - ih, 0)
            x2 = min(cx + iw, 2 * w) if ix else cx
            y2 = min(cy + ih, 2 * h) if iy else cy
            pw, ph = x2 - x1, y2 - y1
            if pw <= 0 or ph <= 0:
                continue
            sx = 0 if ix else iw - pw
            sy = 0 if iy else ih - ph
            canvas[y1:y2, x1:x2] = img[sy:sy + ph, sx:sx + pw]
            if len(s.get('gt_bboxes', [])):
                b = s['gt_bboxes'].copy()
                b[:, 0] += x1 - sx
                b[:, 1] += y1 - sy
                keep = (b[:, 0] > 0) & (b[:, 0] < 2 * w) & \
                       (b[:, 1] > 0) & (b[:, 1] < 2 * h)
                all_boxes.append(b[keep])
                all_labels.append(np.asarray(s['gt_labels'])[keep])
        results['img'] = canvas
        results['img_shape'] = canvas.shape
        results['gt_bboxes'] = np.concatenate(all_boxes) if all_boxes else \
            np.zeros((0, 5), np.float32)
        results['gt_labels'] = np.concatenate(all_labels) if all_labels \
            else np.zeros((0,), np.int64)
        return results


@PIPELINES.register_module()
class LoadPatchFromImage:
    """Crop the window ``results['win'] = (x, y, w, h)`` out of an image
    already in ``results['img']``, zero-padded to the window's size
    (reference ``pipelines/loading.py:10-45``)."""

    def __init__(self, to_float32: bool = False):
        self.to_float32 = to_float32

    def __call__(self, results):
        img = results['img']
        x, y, w, h = results['win']
        patch = img[y:y + h, x:x + w]
        if patch.shape[0] < h or patch.shape[1] < w:
            canvas = np.zeros((h, w) + img.shape[2:], img.dtype)
            canvas[:patch.shape[0], :patch.shape[1]] = patch
            patch = canvas
        if self.to_float32:
            patch = patch.astype(np.float32)
        results['img'] = patch
        results['img_shape'] = patch.shape
        results['ori_shape'] = patch.shape
        results['scale_factor'] = np.array([1., 1., 1., 1.], np.float32)
        return results
