"""A feature level of the backbone as a heatmap over the image (counterpart
of ``tools/heatmap.py``; reference jy's ``tools/heatmap_jy.py:15-40``).

    python -m orientedobjectdetection_torch.tools.heatmap <config> <img> \\
        [ckpt] --out-dir heatmaps [--level 0] [--reduce mean]

The image (PNG, JPEG, BMP or TIFF), normalized with ImageNet's statistics and
padded into the config's ``pad_size`` canvas, goes through the backbone; the
channels of level ``--level`` are reduced (mean or max), scaled to [0, 255],
resized to the canvas, colored with OpenCV's JET map and blended half and half
with the resized image (``utils/image_io.py``: ``resize_bilinear``,
``apply_colormap_jet``, ``add_weighted``). Writes ``heatmap_l<level>.png``.
Runs on the card (``--device cpu`` for the CPU).
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np
import torch

IMAGENET_NORM = dict(mean=[123.675, 116.28, 103.53],
                     std=[58.395, 57.12, 57.375], to_rgb=True)


def heatmap(bundle, img_path: str, level: int = 0,
            reduce: str = 'mean') -> np.ndarray:
    """The blended ``(H_pad, W_pad, 3)`` uint8 BGR heatmap of ``img_path``
    through ``bundle``'s backbone."""
    from ..apis.inference import _prep_image
    from ..utils.image_io import (add_weighted, apply_colormap_jet, imread,
                                  resize_bilinear)
    img = _prep_image(img_path, IMAGENET_NORM)
    pad = bundle.cfg.get('pad_size') or (1024, 1024)
    canvas = np.zeros((pad[0], pad[1], 3), np.float32)
    h, w = min(img.shape[0], pad[0]), min(img.shape[1], pad[1])
    canvas[:h, :w] = img[:h, :w]
    x = torch.from_numpy(canvas[None]).to(bundle.device).permute(0, 3, 1, 2)
    with torch.inference_mode():
        feats = bundle.detector.backbone(x.to(bundle.dtype))
    fmap = feats[min(level, len(feats) - 1)][0].float().cpu().numpy()
    heat = fmap.mean(0) if reduce == 'mean' else fmap.max(0)
    heat = (heat - heat.min()) / max(heat.max() - heat.min(), 1e-6)
    heat8 = (heat * 255).astype(np.uint8)
    color = apply_colormap_jet(resize_bilinear(heat8, (pad[1], pad[0])))
    base = resize_bilinear(imread(img_path), (pad[1], pad[0]))
    return add_weighted(base, 0.5, color, 0.5, 0)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Backbone feature heatmap')
    p.add_argument('config')
    p.add_argument('img')
    p.add_argument('checkpoint', nargs='?', default=None)
    p.add_argument('--out-dir', default='heatmaps')
    p.add_argument('--level', type=int, default=0)
    p.add_argument('--reduce', default='mean', choices=['mean', 'max'])
    p.add_argument('--device', default='cuda',
                   help='cuda (the default) or cpu')
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..apis.inference import init_detector
    from ..utils.image_io import imwrite
    from .train import load_config
    bundle = init_detector(load_config(args.config, []), args.checkpoint,
                           device=args.device)
    overlay = heatmap(bundle, args.img, args.level, args.reduce)
    os.makedirs(args.out_dir, exist_ok=True)
    out = osp.join(args.out_dir, f'heatmap_l{args.level}.png')
    imwrite(out, overlay)
    print(f'wrote {out}')
    return out


if __name__ == '__main__':
    main()
