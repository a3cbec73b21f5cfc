"""Huge-image demo by sliding windows (counterpart of
``demo/huge_image_demo.py``; reference ``demo/huge_image_demo.py:60-75``).

    python -m orientedobjectdetection_torch.tools.huge_image_demo <img> \\
        <config> [ckpt] --patch-sizes 1024 --patch-steps 824

Detects on windows of one PNG, JPEG, BMP or TIFF with
``inference_detector_by_patches`` (the windows batched, their detections
merged by per-class rotated NMS on the card) and writes it with the
detections drawn (an ``--out-file`` ending in ``.jpg`` is a JPEG). Runs on the card (``--device cpu`` for the CPU).
"""

from __future__ import annotations

import argparse

from ..core.visualization import PALETTES


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Detect on a huge image')
    p.add_argument('img')
    p.add_argument('config')
    p.add_argument('checkpoint', nargs='?', default=None)
    p.add_argument('--patch-sizes', type=int, nargs='+', default=[1024])
    p.add_argument('--patch-steps', type=int, nargs='+', default=[824])
    p.add_argument('--img-ratios', type=float, nargs='+', default=[1.0])
    p.add_argument('--merge-iou-thr', type=float, default=0.1)
    p.add_argument('--out-file', default='huge_demo_out.png')
    p.add_argument('--score-thr', type=float, default=0.3)
    p.add_argument('--palette', default='dota', choices=PALETTES)
    p.add_argument('--device', default='cuda',
                   help='cuda (the default) or cpu')
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..apis.inference import (inference_detector_by_patches,
                                  init_detector)
    from ..core.visualization import imshow_det_rbboxes
    bundle = init_detector(args.config, args.checkpoint, device=args.device)
    result = inference_detector_by_patches(
        bundle, args.img, sizes=args.patch_sizes, steps=args.patch_steps,
        ratios=args.img_ratios, merge_iou_thr=args.merge_iou_thr)
    imshow_det_rbboxes(args.img, result, score_thr=args.score_thr,
                       palette=args.palette, out_file=args.out_file)
    print(f'wrote {args.out_file}')
    return result


if __name__ == '__main__':
    main()
