"""Offline DOTA huge-image tiler without OpenCV (a port-only copy of
``tools/data/dota/split/img_split.py``; reference
``tools/data/dota/split/img_split.py``).

Slides the windows of :func:`..core.patch.slide_window` (``--sizes`` and
``--gaps``, each scaled by ``1 / rate`` for every ``--rates``) over each
image, writes each window as ``<id>__<size>__<x>___<y>.png`` (or the
format ``--img-ext`` / ``split_one(img_ext=...)`` names, ``.tif`` a TIFF as
``cv2.imwrite`` writes it; padded with
``(104, 116, 124)`` where it runs over the image's edge) and its
annotations: an object whose area lies in the window by ``--iof-thr``
(0.7) or more keeps its difficulty, a smaller part of one is written with
difficulty 2; an annotated window with no object is skipped.
``DOTADataset.merge_det`` parses the offsets back. Images are read
(PNG, JPEG, BMP or TIFF scenes: ``.png``, ``.jpg``, ``.bmp`` and ``.tif``
files, as the reference lists them) and written with
:mod:`..utils.image_io`.

    python -m orientedobjectdetection_torch.tools.img_split \\
        --img-dirs data/DOTA/train/images \\
        --ann-dirs data/DOTA/train/labelTxt --save-dir data/split_1024 \\
        --sizes 1024 --gaps 200 [--rates 0.5 1.0] [--img-ext .tif]
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import numpy as np

from ..core.patch import slide_window
from ..utils.image_io import imread, imwrite


def load_dota_ann(ann_path):
    """A DOTA annotation file -> (polygons (n, 8) float32, class names,
    difficulties (n,)); lines with fewer than 9 fields or coordinates that
    are not numbers are skipped."""
    polys, names, diffs = [], [], []
    if ann_path and osp.isfile(ann_path):
        with open(ann_path) as f:
            for line in f:
                items = line.split()
                if len(items) < 9:
                    continue
                try:
                    poly = np.asarray(items[:8], np.float32)
                except ValueError:
                    continue
                polys.append(poly)
                names.append(items[8])
                diffs.append(int(items[9]) if len(items) > 9 else 0)
    return (np.asarray(polys, np.float32).reshape(-1, 8), names,
            np.asarray(diffs, np.int64))


def poly_area(polys):
    x = polys[:, 0::2]
    y = polys[:, 1::2]
    return 0.5 * np.abs(
        np.sum(x * np.roll(y, -1, axis=1) - np.roll(x, -1, axis=1) * y,
               axis=1))


def _clip_edge(pts, edge, x0, y0, x1, y1):
    """One Sutherland-Hodgman pass of a polygon against a window edge."""
    def inside(q):
        if edge == 'left':
            return q[0] >= x0
        if edge == 'right':
            return q[0] <= x1
        if edge == 'top':
            return q[1] >= y0
        return q[1] <= y1

    def intersect(a, b):
        if edge in ('left', 'right'):
            xe = x0 if edge == 'left' else x1
            t = (xe - a[0]) / (b[0] - a[0] + 1e-12)
            return [xe, a[1] + t * (b[1] - a[1])]
        ye = y0 if edge == 'top' else y1
        t = (ye - a[1]) / (b[1] - a[1] + 1e-12)
        return [a[0] + t * (b[0] - a[0]), ye]

    out = []
    for j in range(len(pts)):
        a, b = pts[j], pts[(j + 1) % len(pts)]
        if inside(a):
            out.append(a)
            if not inside(b):
                out.append(intersect(a, b))
        elif inside(b):
            out.append(intersect(a, b))
    return out


def clip_polys_to_window(polys, x0, y0, x1, y1):
    """Each polygon's share of its area inside the window (the polygon
    clipped by Sutherland-Hodgman)."""
    ratios = np.zeros(len(polys), np.float32)
    full = poly_area(polys)
    for i, p in enumerate(polys):
        pts = p.reshape(4, 2).tolist()
        for edge in ('left', 'right', 'top', 'bottom'):
            if not pts:
                break
            pts = _clip_edge(pts, edge, x0, y0, x1, y1)
        if len(pts) >= 3:
            arr = np.asarray(pts)
            xx, yy = arr[:, 0], arr[:, 1]
            area = 0.5 * abs(np.sum(xx * np.roll(yy, -1) -
                                    np.roll(xx, -1) * yy))
            ratios[i] = area / max(full[i], 1e-6)
    return ratios


def get_windows(width, height, sizes, gaps, img_rate_thr=0.6):
    steps = [s - g for s, g in zip(sizes, gaps)]
    return slide_window(width, height, sizes, steps, img_rate_thr)


def split_one(task, save_img_dir, save_ann_dir, sizes, gaps,
              iof_thr=0.7, no_padding=False, padding_value=(104, 116, 124),
              img_ext='.png'):
    """Tile one ``(image path, annotation path or None)``; returns the
    number of tiles written."""
    img_path, ann_path = task
    img = imread(img_path)
    h, w = img.shape[:2]
    base = osp.splitext(osp.basename(img_path))[0]
    polys, names, diffs = load_dota_ann(ann_path)
    n_out = 0
    for (x, y, ww, hh) in get_windows(w, h, sizes, gaps):
        x1, y1 = int(x), int(y)
        x2, y2 = int(min(x + ww, w)), int(min(y + hh, h))
        patch = img[y1:y2, x1:x2]
        if not no_padding and (patch.shape[0] < hh or patch.shape[1] < ww):
            canvas = np.empty((hh, ww, 3), img.dtype)
            canvas[...] = padding_value
            canvas[:patch.shape[0], :patch.shape[1]] = patch
            patch = canvas
        # the window size in the name keeps the scales of a multi-scale
        # split apart (reference img_split.py:307-309)
        name = f'{base}__{int(ww)}__{x1}___{y1}'
        lines = []
        if len(polys):
            ratios = clip_polys_to_window(polys, x1, y1, x2, y2)
            keep = ratios >= iof_thr
            trunc = (ratios > 1e-3) & ~keep       # written as difficulty 2
            for idx in np.nonzero(keep | trunc)[0]:
                p = polys[idx].copy()
                p[0::2] -= x1
                p[1::2] -= y1
                diff = diffs[idx] if keep[idx] else 2
                coords = ' '.join(f'{v:.1f}' for v in p)
                lines.append(f'{coords} {names[idx]} {diff}')
        if ann_path is not None and not lines:
            continue                # annotated splits skip empty windows
        imwrite(osp.join(save_img_dir, name + img_ext),
                np.ascontiguousarray(patch))
        if ann_path is not None:
            with open(osp.join(save_ann_dir, name + '.txt'), 'w') as f:
                f.write('\n'.join(lines))
        n_out += 1
    return n_out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Tile huge DOTA images')
    p.add_argument('--base-json', default=None)
    p.add_argument('--img-dirs', nargs='+', default=None)
    p.add_argument('--ann-dirs', nargs='+', default=None)
    p.add_argument('--save-dir', default=None)
    p.add_argument('--sizes', type=int, nargs='+', default=[1024])
    p.add_argument('--gaps', type=int, nargs='+', default=[200])
    p.add_argument('--rates', type=float, nargs='+', default=[1.0])
    p.add_argument('--iof-thr', type=float, default=0.7)
    p.add_argument('--nproc', type=int, default=8)
    p.add_argument('--img-ext', default='.png',
                   help='the windows\' format, by extension (.png, .tif, '
                        '.jpg or .bmp; as split_one\'s img_ext)')
    args = p.parse_args(argv)
    if args.base_json:
        with open(args.base_json) as f:
            cfg = json.load(f)
        for k, v in cfg.items():
            key = k.replace('-', '_')
            if getattr(args, key, None) in (None, [1024], [200], [1.0]):
                setattr(args, key, v)
    return args


def main(argv=None) -> int:
    """Split every image of ``--img-dirs``; returns the tiles written."""
    args = parse_args(argv)
    sizes, gaps = [], []
    for r in args.rates:
        for s, g in zip(args.sizes, args.gaps):
            sizes.append(int(s / r))
            gaps.append(int(g / r))
    save_img = osp.join(args.save_dir, 'images')
    save_ann = osp.join(args.save_dir, 'annfiles')
    os.makedirs(save_img, exist_ok=True)
    os.makedirs(save_ann, exist_ok=True)
    tasks = []
    for i, img_dir in enumerate(args.img_dirs):
        ann_dir = args.ann_dirs[i] if args.ann_dirs else None
        for fname in sorted(os.listdir(img_dir)):
            if not fname.lower().endswith(('.png', '.jpg', '.bmp', '.tif')):
                continue
            ann = osp.join(ann_dir, osp.splitext(fname)[0] + '.txt') \
                if ann_dir else None
            tasks.append((osp.join(img_dir, fname), ann))
    worker = partial(split_one, save_img_dir=save_img, save_ann_dir=save_ann,
                     sizes=sizes, gaps=gaps, iof_thr=args.iof_thr,
                     img_ext=args.img_ext)
    with ThreadPoolExecutor(max_workers=args.nproc) as pool:
        counts = list(pool.map(worker, tasks))
    print(f'split {len(tasks)} images -> {sum(counts)} patches '
          f'in {args.save_dir}')
    return sum(counts)


if __name__ == '__main__':
    main()
