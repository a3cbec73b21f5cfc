"""Synthetic DOTA- and HRSC-layout datasets without OpenCV (counterpart of
``tools/data/synth/generate_synth.py``, whose generators it follows draw
for draw: the same seed writes the same annotation files).

``{root}/{split}/images/*.png`` and ``{root}/{split}/annfiles/*.txt`` with
``x1 y1 x2 y2 x3 y3 x4 y4 class difficulty`` lines:

- :func:`generate_synth`: the tiny protocol, two classes ("plane": warm,
  squarish, a cross strut; "ship": cool, elongated, a bright bow), 1-5
  objects on a cluttered background;
- :func:`generate_synth_hard`: crowded 15-class scenes (100-600 instances,
  rows of one class, overlapping twins, 8-32 px objects);
- :func:`generate_synth_hrsc` (``--hrsc``): 1-4 ships a scene in the
  HRSC2016 layout, ``{root}/FullDataSet/AllImages/*.bmp``,
  ``{root}/FullDataSet/Annotations/*.xml`` and
  ``{root}/ImageSets/{split}.txt``.

Images are drawn with :mod:`..utils.image_io`, which follows OpenCV's
rasterisation; they equal the original's except along some drawn edges
(``tests/test_torch_synth.py`` states how many pixels differ).

    python -m orientedobjectdetection_torch.tools.generate_synth \\
        --root data/synth_dota --num-images 200 --size 256 --seed 0
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np

from ..ops.boxes import obb2poly_np
from ..utils import image_io

CLASSES = ('plane', 'ship')


def _rect_poly(cx, cy, w, h, a):
    return obb2poly_np(
        np.asarray([[cx, cy, w, h, a, 0.]], np.float32), 'le90')[0, :8]


def _render(img, poly, cls, rng):
    pts = poly.reshape(4, 2).astype(np.int32)
    if cls == 0:                                   # plane: warm + cross strut
        color = (int(rng.integers(20, 70)), int(rng.integers(20, 70)),
                 int(rng.integers(180, 255)))
        image_io.fill_poly(img, pts, color)
        mid01, mid23 = (pts[0] + pts[1]) // 2, (pts[2] + pts[3]) // 2
        image_io.line(img, mid01, mid23, (240, 240, 240), 2)
    else:                                          # ship: cool + bright bow
        color = (int(rng.integers(180, 255)), int(rng.integers(20, 90)),
                 int(rng.integers(20, 70)))
        image_io.fill_poly(img, pts, color)
        bow = (pts[1] + pts[2]) // 2
        image_io.circle(img, bow, 3, (230, 230, 230))


def _sample_box(cls, size, rng):
    margin = 36
    cx = float(rng.uniform(margin, size - margin))
    cy = float(rng.uniform(margin, size - margin))
    if cls == 0:                                   # plane: squarish
        w = float(rng.uniform(28, 52))
        h = w * float(rng.uniform(0.6, 0.95))
    else:                                          # ship: elongated
        w = float(rng.uniform(40, 70))
        h = w * float(rng.uniform(0.25, 0.42))
    a = float(rng.uniform(-np.pi / 2, np.pi / 2))
    return cx, cy, w, h, a


def _clutter(img, size, rng, lo, hi, grey_lo, grey_hi):
    for _ in range(int(rng.integers(lo, hi))):
        p0 = tuple(int(v) for v in rng.integers(0, size, 2))
        p1 = tuple(int(v) for v in rng.integers(0, size, 2))
        image_io.line(img, p0, p1, (int(rng.integers(grey_lo, grey_hi)),) * 3)


def _write(img_dir, ann_dir, stem, img, lines):
    image_io.imwrite(osp.join(img_dir, stem + '.png'),
                     image_io.gaussian_blur_3x3(img))
    with open(osp.join(ann_dir, stem + '.txt'), 'w') as f:
        f.write('\n'.join(lines) + ('\n' if lines else ''))


def _dirs(root, split):
    img_dir = osp.join(root, split, 'images')
    ann_dir = osp.join(root, split, 'annfiles')
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)
    return img_dir, ann_dir


def generate_synth(root, num_images=200, size=256, seed=0, split='trainval',
                   max_objs=5):
    """Write ``num_images`` tiny-protocol scenes under ``root/split``."""
    img_dir, ann_dir = _dirs(root, split)
    rng = np.random.default_rng(seed)
    for i in range(num_images):
        img = rng.integers(60, 120, (size, size, 3), np.uint8)
        _clutter(img, size, rng, 2, 6, 90, 150)
        lines, placed = [], []
        for _ in range(int(rng.integers(1, max_objs + 1))):
            cls = int(rng.integers(0, len(CLASSES)))
            for _attempt in range(20):
                cx, cy, w, h, a = _sample_box(cls, size, rng)
                r = max(w, h) / 2
                if all(np.hypot(cx - px, cy - py) > r + pr + 6
                       for px, py, pr in placed):
                    break
            else:
                continue
            placed.append((cx, cy, r))
            poly = _rect_poly(cx, cy, w, h, a)
            _render(img, poly, cls, rng)
            lines.append(' '.join(f'{v:.1f}' for v in poly) +
                         f' {CLASSES[cls]} 0')
        _write(img_dir, ann_dir, f'P{i:04d}', img, lines)
    return root


def generate_synth_hrsc(root, num_images=200, size=256, seed=0,
                        imageset='trainval', max_objs=4):
    """Write ``num_images`` ship scenes in the HRSC2016 layout (reference
    ``datasets/hrsc.py:17-100``): VOC-style XML with ``HRSC_Object``
    ``mbox_cx/cy/w/h/ang``, one ``ship`` class, and the image set's id
    list."""
    img_dir = osp.join(root, 'FullDataSet', 'AllImages')
    ann_dir = osp.join(root, 'FullDataSet', 'Annotations')
    set_dir = osp.join(root, 'ImageSets')
    for d in (img_dir, ann_dir, set_dir):
        os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    ids = []
    for i in range(num_images):
        img = rng.integers(60, 120, (size, size, 3), np.uint8)
        _clutter(img, size, rng, 2, 6, 90, 150)
        objs, placed = [], []
        for _ in range(int(rng.integers(1, max_objs + 1))):
            for _attempt in range(20):
                cx, cy, w, h, a = _sample_box(1, size, rng)   # ship shape
                r = max(w, h) / 2
                if all(np.hypot(cx - px, cy - py) > r + pr + 6
                       for px, py, pr in placed):
                    break
            else:
                continue
            placed.append((cx, cy, r))
            _render(img, _rect_poly(cx, cy, w, h, a), 1, rng)
            objs.append((cx, cy, w, h, a))
        stem = f'H{i:04d}'
        ids.append(stem)
        image_io.imwrite(osp.join(img_dir, stem + '.bmp'),
                         image_io.gaussian_blur_3x3(img))
        obj_xml = '\n'.join(
            '    <HRSC_Object>\n'
            '      <Class_ID>100000001</Class_ID>\n'
            f'      <mbox_cx>{cx:.2f}</mbox_cx>\n'
            f'      <mbox_cy>{cy:.2f}</mbox_cy>\n'
            f'      <mbox_w>{w:.2f}</mbox_w>\n'
            f'      <mbox_h>{h:.2f}</mbox_h>\n'
            f'      <mbox_ang>{a:.5f}</mbox_ang>\n'
            '    </HRSC_Object>' for cx, cy, w, h, a in objs)
        with open(osp.join(ann_dir, stem + '.xml'), 'w') as f:
            f.write('<HRSC_Image>\n  <Img_ID>%s</Img_ID>\n'
                    '  <HRSC_Objects>\n%s\n  </HRSC_Objects>\n'
                    '</HRSC_Image>\n' % (stem, obj_xml))
    with open(osp.join(set_dir, imageset + '.txt'), 'w') as f:
        f.write('\n'.join(ids) + '\n')
    return root


DOTA_CLASSES = (
    'plane', 'baseball-diamond', 'bridge', 'ground-track-field',
    'small-vehicle', 'large-vehicle', 'ship', 'tennis-court',
    'basketball-court', 'storage-tank', 'soccer-ball-field', 'roundabout',
    'harbor', 'swimming-pool', 'helicopter')

# per-class signature: (hue 0-179, long-side range px, aspect h/w range)
_HARD_STYLE = [
    (0, (14, 30), (0.60, 0.95)), (12, (16, 32), (0.80, 1.00)),
    (24, (20, 32), (0.15, 0.30)), (36, (22, 32), (0.45, 0.70)),
    (48, (8, 14), (0.40, 0.60)), (60, (12, 22), (0.30, 0.50)),
    (72, (14, 30), (0.20, 0.40)), (84, (14, 24), (0.45, 0.60)),
    (96, (14, 24), (0.50, 0.65)), (108, (9, 16), (0.90, 1.00)),
    (120, (20, 32), (0.60, 0.80)), (132, (10, 18), (0.90, 1.00)),
    (144, (18, 32), (0.25, 0.45)), (156, (12, 22), (0.40, 0.60)),
    (168, (12, 24), (0.55, 0.85)),
]


def _hard_color(cls, rng):
    h = (_HARD_STYLE[cls][0] + int(rng.integers(-4, 5))) % 180
    hsv = np.uint8([[[h, rng.integers(180, 255), rng.integers(150, 255)]]])
    return tuple(int(v) for v in image_io.hsv2bgr(hsv)[0, 0])


def _hard_render(img, poly, cls, rng):
    pts = poly.reshape(4, 2).astype(np.int32)
    image_io.fill_poly(img, pts, _hard_color(cls, rng))
    c = pts.mean(0).astype(np.int32)           # a glyph besides the hue
    if cls % 3 == 0:
        image_io.circle(img, c, 1, (245, 245, 245))
    elif cls % 3 == 1:
        m01, m23 = (pts[0] + pts[1]) // 2, (pts[2] + pts[3]) // 2
        image_io.line(img, m01, m23, (15, 15, 15))


def _hard_box(cls, size, rng):
    lo, hi = _HARD_STYLE[cls][1]
    ar_lo, ar_hi = _HARD_STYLE[cls][2]
    w = float(rng.uniform(lo, hi))
    h = w * float(rng.uniform(ar_lo, ar_hi))
    cx = float(rng.uniform(hi, size - hi))
    cy = float(rng.uniform(hi, size - hi))
    a = float(rng.uniform(-np.pi / 2, np.pi / 2))
    return cx, cy, w, h, a


def generate_synth_hard(root, num_images=120, size=512, seed=0,
                        split='trainval', n_range=(100, 600)):
    """Write crowded 15-class scenes in the DOTA layout."""
    img_dir, ann_dir = _dirs(root, split)
    rng = np.random.default_rng(seed)
    n_cls = len(DOTA_CLASSES)
    for i in range(num_images):
        img = rng.integers(55, 110, (size, size, 3), np.uint8)
        _clutter(img, size, rng, 4, 10, 80, 140)
        n_target = int(rng.integers(n_range[0], n_range[1] + 1))
        boxes = []                                # (cx, cy, w, h, a, cls)
        # ~60% of instances come from same-class rows
        while len(boxes) < int(0.6 * n_target):
            cls = int(rng.integers(0, n_cls))
            k = int(rng.integers(5, 21))
            theta = float(rng.uniform(-np.pi / 2, np.pi / 2))
            ux, uy = np.cos(theta), np.sin(theta)
            margin = _HARD_STYLE[cls][1][1]
            sx = float(rng.uniform(margin, size - margin))
            sy = float(rng.uniform(margin, size - margin))
            _, _, w0, h0, _ = _hard_box(cls, size, rng)
            step = w0 * float(rng.uniform(0.95, 1.30))  # near-touching
            for j in range(k):
                cx = sx + j * step * ux + float(rng.normal(0, 1.0))
                cy = sy + j * step * uy + float(rng.normal(0, 1.0))
                if not (4 < cx < size - 4 and 4 < cy < size - 4):
                    break
                a = theta + float(rng.normal(0, 0.06))
                a = (a + np.pi / 2) % np.pi - np.pi / 2
                boxes.append((cx, cy, w0 * float(rng.uniform(0.92, 1.08)),
                              h0 * float(rng.uniform(0.92, 1.08)), a, cls))
        # scattered singles; ~8% get an overlapping same-class twin
        while len(boxes) < n_target:
            cls = int(rng.integers(0, n_cls))
            cx, cy, w, h, a = _hard_box(cls, size, rng)
            boxes.append((cx, cy, w, h, a, cls))
            if rng.random() < 0.08 and len(boxes) < n_target:
                off = w * float(rng.uniform(0.3, 0.55))
                boxes.append((cx + off * np.cos(a), cy + off * np.sin(a),
                              w, h, a + float(rng.normal(0, 0.05)), cls))
        lines = []
        for cx, cy, w, h, a, cls in boxes:       # back to front
            poly = _rect_poly(cx, cy, w, h, a)
            _hard_render(img, poly, cls, rng)
            lines.append(' '.join(f'{v:.1f}' for v in poly) +
                         f' {DOTA_CLASSES[cls]} 0')
        _write(img_dir, ann_dir, f'D{i:04d}', img, lines)
    return root


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--root', required=True)
    p.add_argument('--num-images', type=int, default=200)
    p.add_argument('--size', type=int, default=256)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--split', default='trainval')
    p.add_argument('--hrsc', action='store_true',
                   help='the HRSC2016 layout; --split names its image set')
    p.add_argument('--hard', action='store_true',
                   help='the crowded 15-class synth-hard protocol')
    p.add_argument('--n-min', type=int, default=100)
    p.add_argument('--n-max', type=int, default=600)
    args = p.parse_args(argv)
    if args.hrsc:
        generate_synth_hrsc(args.root, args.num_images, args.size, args.seed,
                            args.split)
    elif args.hard:
        generate_synth_hard(args.root, args.num_images, args.size, args.seed,
                            args.split, n_range=(args.n_min, args.n_max))
    else:
        generate_synth(args.root, args.num_images, args.size, args.seed,
                       args.split)
    print(f'wrote {args.num_images} images to {args.root}')


if __name__ == '__main__':
    main()
