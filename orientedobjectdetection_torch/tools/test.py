"""Evaluation command line (counterpart of ``tools/test.py``).

    python -m orientedobjectdetection_torch.tools.test <config> <ckpt> \\
        --eval mAP --bf16
    python -m orientedobjectdetection_torch.tools.test <config> <ckpt> \\
        --format-only --submission-dir out/

Runs on the card (``--device cpu`` for the CPU). ``--format-only`` detects
on the config's test split and writes the DOTA Task1 submission files and
their zip (``DOTADataset.format_results``); ``--tta`` detects each image
with its horizontal and vertical flips (``inference_detector_tta``).
``--data-parallel``, ``--collect-dir``, ``--show`` and ``--show-dir`` are
ROADMAP A.13.
"""

from __future__ import annotations

import argparse
import os.path as osp
import pickle

from .train import load_config


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Test a rotated detector')
    p.add_argument('config')
    p.add_argument('checkpoint', nargs='?', default=None)
    p.add_argument('--eval', default=None, choices=[None, 'mAP'])
    p.add_argument('--format-only', action='store_true')
    p.add_argument('--submission-dir', default=None)
    p.add_argument('--out', default=None, help='pickle results path')
    p.add_argument('--bf16', action='store_true')
    p.add_argument('--device', default='cuda',
                   help='cuda (the default) or cpu')
    p.add_argument('--max-images', type=int, default=None)
    p.add_argument('--batch-size', type=int, default=8,
                   help='images per inference batch')
    p.add_argument('--data-parallel', action='store_true')
    p.add_argument('--tta', action='store_true')
    p.add_argument('--collect-dir', default=None)
    p.add_argument('--show', action='store_true')
    p.add_argument('--show-dir', default=None)
    p.add_argument('--show-score-thr', type=float, default=0.3)
    p.add_argument('--cfg-options', nargs='+', default=[])
    return p.parse_args(argv)


NOT_PORTED = (
    ('data_parallel', 'data-parallel evaluation is ROADMAP A.13'),
    ('collect_dir', 'gathering results across processes is ROADMAP A.13'),
    ('show', 'drawing detections (--show) is ROADMAP A.13'),
    ('show_dir', 'drawing detections (--show-dir) is ROADMAP A.13'),
)


def main(argv=None):
    args = parse_args(argv)
    for flag, reason in NOT_PORTED:
        if getattr(args, flag):
            raise NotImplementedError(reason)
    import torch
    from ..apis.eval import _default_norm, batched_eval
    from ..apis.inference import inference_detector_tta, init_detector
    from ..datasets import build_dataset

    cfg = load_config(args.config, args.cfg_options)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    device_norm = _default_norm(cfg) if \
        cfg.data.get('normalize_on_device', True) else None
    bundle = init_detector(cfg, args.checkpoint, device=args.device,
                           dtype=dtype, device_norm=device_norm)
    split = 'test' if args.format_only else 'val'
    dataset = build_dataset(dict(cfg.data[split], test_mode=True,
                                 filter_empty_gt=False))
    n = len(dataset) if args.max_images is None else \
        min(args.max_images, len(dataset))
    if args.tta:
        version = cfg.model.get('bbox_head', {}).get(
            'version', cfg.get('angle_version', 'le90'))
        results = []
        for i in range(n):
            path = osp.join(dataset.img_prefix,
                            dataset.data_infos[i]['filename'])
            results.append(inference_detector_tta(bundle, path,
                                                  version=version))
            if (i + 1) % 20 == 0:
                print(f'tta eval {i + 1}/{n}')
    else:
        results = batched_eval(bundle, dataset, batch_size=args.batch_size,
                               max_images=n)
    if args.out:
        with open(args.out, 'wb') as f:
            pickle.dump(results, f)
    if args.format_only:
        path = dataset.format_results(results,
                                      submission_dir=args.submission_dir,
                                      device=bundle.device)
        print(f'submission written to {path}')
    metrics = None
    if args.eval:
        dataset.data_infos = dataset.data_infos[:n]
        metrics = dataset.evaluate(results, metric=args.eval,
                                   device=bundle.device)
        print(metrics)
    return metrics


if __name__ == '__main__':
    main()
