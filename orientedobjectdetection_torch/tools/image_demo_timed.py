"""Timed single-image demo (counterpart of ``demo/image_demo_timed.py``;
reference ``demo/image_demo_jy.py:36-88``): the model's load time, the
first inference (the kernels' build or load included), the steady-state
latency and the card's memory.

    python -m orientedobjectdetection_torch.tools.image_demo_timed \\
        <img|random> <config> [ckpt] --iters 20 [--bf16]

``random`` detects on a seeded 1024 x 1024 noise image. Each timed call
ends when its detections are on the host. Runs on the card (``--device
cpu`` for the CPU, where no memory is reported).
"""

from __future__ import annotations

import argparse
import time

from ..core.visualization import PALETTES


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Time detection on one image')
    p.add_argument('img', help='image file, or "random" for a seeded one')
    p.add_argument('config')
    p.add_argument('checkpoint', nargs='?', default=None)
    p.add_argument('--out-file', default=None)
    p.add_argument('--score-thr', type=float, default=0.3)
    p.add_argument('--palette', default='dota', choices=PALETTES)
    p.add_argument('--iters', type=int, default=20,
                   help='steady-state timing iterations')
    p.add_argument('--bf16', action='store_true')
    p.add_argument('--device', default='cuda',
                   help='cuda (the default) or cpu')
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import numpy as np
    import torch
    from ..apis.inference import inference_detector, init_detector
    from ..utils.image_io import imread

    t0 = time.perf_counter()
    bundle = init_detector(args.config, args.checkpoint, device=args.device,
                           dtype=torch.bfloat16 if args.bf16
                           else torch.float32)
    print(f'model load+init: {time.perf_counter() - t0:.2f}s')
    if args.img == 'random':
        img = np.random.default_rng(0).integers(0, 255, (1024, 1024, 3),
                                                np.uint8)
    else:
        img = imread(args.img)

    t0 = time.perf_counter()
    result = inference_detector(bundle, img)
    print(f'first inference (kernel build or load + run): '
          f'{time.perf_counter() - t0:.2f}s')
    t0 = time.perf_counter()
    for _ in range(args.iters):
        result = inference_detector(bundle, img)
    steady = (time.perf_counter() - t0) / max(args.iters, 1)
    print(f'steady-state inference: {steady * 1e3:.1f} ms/img '
          f'({1.0 / steady:.1f} imgs/s)')
    if bundle.device.type == 'cuda':
        gib = 2 ** 30
        print(f'device memory: '
              f'{torch.cuda.memory_allocated(bundle.device) / gib:.2f} GiB '
              f'in use, '
              f'{torch.cuda.max_memory_allocated(bundle.device) / gib:.2f} '
              f'GiB peak')
    print(f'detections: {sum(len(r) for r in result)}')
    if args.out_file:
        from ..core.visualization import imshow_det_rbboxes
        imshow_det_rbboxes(img, result, score_thr=args.score_thr,
                           palette=args.palette, out_file=args.out_file)
        print(f'wrote {args.out_file}')
    return result


if __name__ == '__main__':
    main()
