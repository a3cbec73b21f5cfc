"""Rotated-box visualization (counterpart of
``orientedobjectdetection_tpu/core/visualization.py``; reference
``core/visualization/image.py:40-244``).

Draws without OpenCV: each box's polygon with ``utils/image_io.py:line``
(``cv2.polylines`` of a closed polygon is ``cv2.line`` on each edge, pixel
for pixel), the label with ``utils/font.py:put_text`` (OpenCV's Hershey
simplex glyphs, drawn without antialiasing), and the file with
``utils/image_io.py:imwrite``: a ``.jpg`` out file is a JPEG as
``cv2.imwrite`` writes it, a ``.bmp`` a BMP, any other a PNG.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..ops.boxes import obb2poly_np
from ..utils.font import put_text
from ..utils.image_io import imread, imwrite, line

DOTA_PALETTE = [(165, 42, 42), (189, 183, 107), (0, 255, 0), (255, 0, 0),
                (138, 43, 226), (255, 128, 0), (255, 0, 255), (0, 255, 255),
                (255, 193, 193), (0, 51, 153), (255, 250, 205), (0, 139, 139),
                (255, 255, 0), (147, 116, 116), (0, 0, 255)]
PALETTES = ('dota', 'sar', 'hrsc', 'hrsc_classwise', 'random')


def palette_colors(palette, num_classes: int):
    """An explicit color list, or a name of :data:`PALETTES` (the reference
    demos' ``--palette``): 'random' is seeded, 'sar' and 'hrsc' draw every
    class green, the others :data:`DOTA_PALETTE`."""
    if isinstance(palette, str):
        if palette not in PALETTES:
            raise ValueError(f'palette must be one of {PALETTES}, got '
                             f'{palette!r}')
        if palette == 'random':
            rng = np.random.default_rng(42)
            return [tuple(int(v) for v in rng.integers(0, 255, 3))
                    for _ in range(max(num_classes, 1))]
        if palette in ('sar', 'hrsc'):
            return [(0, 255, 0)]
        return DOTA_PALETTE
    return palette or DOTA_PALETTE


def draw_polygon(img: np.ndarray, pts: np.ndarray, color,
                 thickness: int) -> None:
    """``cv2.polylines(img, [pts], True, color, thickness)`` for one
    polygon of integer vertices, in place."""
    for i in range(len(pts)):
        line(img, pts[i - 1], pts[i], color, thickness)


def _load(img) -> np.ndarray:
    return imread(img) if isinstance(img, str) else img


def imshow_det_rbboxes(img, result: List[np.ndarray],
                       class_names: Optional[Sequence[str]] = None,
                       score_thr: float = 0.3,
                       thickness: int = 2,
                       font_scale: float = 0.5,
                       version: str = 'le90',
                       palette=None,
                       out_file: Optional[str] = None) -> np.ndarray:
    """Draw per-class ``(n, 6)`` detections on a copy of ``img`` (a PNG,
    JPEG, BMP or TIFF path, or an ``(H, W, 3)`` uint8 BGR array): each box
    scoring at
    least ``score_thr`` as a closed polygon in its class's color, labelled
    ``name|score`` 3 pixels above its first corner. ``palette``: a color
    list or a name of :data:`PALETTES`. Writes ``out_file`` when given (in
    the format its extension names, as ``cv2.imwrite`` does) and returns
    the drawn image."""
    img = _load(img).copy()
    palette = palette_colors(palette, len(result))
    for cls, dets in enumerate(result):
        dets = np.asarray(dets, np.float32).reshape(-1, 6)
        dets = dets[dets[:, 5] >= score_thr]
        if len(dets) == 0:
            continue
        color = tuple(int(v) for v in palette[cls % len(palette)])
        label = class_names[cls] if class_names else str(cls)
        for p in obb2poly_np(dets, version):
            pts = p[:8].reshape(4, 2).astype(np.int32)
            draw_polygon(img, pts, color, thickness)
            put_text(img, f'{label}|{p[8]:.2f}',
                     (int(pts[0, 0]), int(pts[0, 1]) - 3), font_scale,
                     color)
    if out_file:
        imwrite(out_file, img)
    return img


def imshow_gt_det_rbboxes(img, gt_bboxes: np.ndarray,
                          gt_labels: np.ndarray,
                          result: List[np.ndarray],
                          class_names: Optional[Sequence[str]] = None,
                          score_thr: float = 0.3,
                          thickness: int = 2,
                          font_scale: float = 0.5,
                          version: str = 'le90',
                          out_file: Optional[str] = None) -> np.ndarray:
    """Ground truth (left) and detections (right) side by side, with a
    4-pixel white band between. ``gt_bboxes`` ``(n, 5)`` ``[cx, cy, w, h,
    theta]``, ``gt_labels`` ``(n,)`` class indices."""
    img = _load(img)
    gt_img = img.copy()
    gt_bboxes = np.asarray(gt_bboxes, np.float32).reshape(-1, 5)
    gt_labels = np.asarray(gt_labels).reshape(-1)
    if len(gt_bboxes):
        polys = obb2poly_np(np.concatenate(
            [gt_bboxes, np.ones((len(gt_bboxes), 1), np.float32)], -1),
            version)
        for p, cls in zip(polys, gt_labels):
            pts = p[:8].reshape(4, 2).astype(np.int32)
            color = tuple(int(v) for v in
                          DOTA_PALETTE[int(cls) % len(DOTA_PALETTE)])
            draw_polygon(gt_img, pts, color, thickness)
            label = (class_names[int(cls)] if class_names is not None
                     else str(int(cls)))
            put_text(gt_img, label, (int(pts[0, 0]), int(pts[0, 1]) - 3),
                     font_scale, color)
    det_img = imshow_det_rbboxes(img, result, class_names=class_names,
                                 score_thr=score_thr, thickness=thickness,
                                 font_scale=font_scale, version=version)
    sep = np.full((img.shape[0], 4, 3), 255, img.dtype)
    out = np.concatenate([gt_img, sep, det_img], axis=1)
    if out_file:
        imwrite(out_file, out)
    return out
