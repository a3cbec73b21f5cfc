"""Single-image demo (counterpart of ``demo/image_demo.py``; reference
``demo/image_demo.py:28-40``).

    python -m orientedobjectdetection_torch.tools.image_demo <img> \\
        <config> [ckpt] --out-file demo_out.png --score-thr 0.3

Detects on one PNG, JPEG, BMP or TIFF with ``inference_detector`` and
writes it with the detections drawn (``core/visualization.py:
imshow_det_rbboxes``; in the format the ``--out-file``'s extension names,
``.jpg`` a JPEG, ``.tif`` a TIFF). Runs on the card
(``--device cpu`` for the CPU).
"""

from __future__ import annotations

import argparse

from ..core.visualization import PALETTES


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Detect on one image')
    p.add_argument('img')
    p.add_argument('config')
    p.add_argument('checkpoint', nargs='?', default=None)
    p.add_argument('--out-file', default='demo_out.png')
    p.add_argument('--score-thr', type=float, default=0.3)
    p.add_argument('--palette', default='dota', choices=PALETTES)
    p.add_argument('--device', default='cuda',
                   help='cuda (the default) or cpu')
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..apis.inference import inference_detector, init_detector
    from ..core.visualization import imshow_det_rbboxes
    bundle = init_detector(args.config, args.checkpoint, device=args.device)
    result = inference_detector(bundle, args.img)
    imshow_det_rbboxes(args.img, result, score_thr=args.score_thr,
                       palette=args.palette, out_file=args.out_file)
    print(f'wrote {args.out_file}')
    return result


if __name__ == '__main__':
    main()
