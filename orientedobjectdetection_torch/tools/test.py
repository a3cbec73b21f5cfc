"""Evaluation command line (counterpart of ``tools/test.py``).

    python -m orientedobjectdetection_torch.tools.test <config> <ckpt> \\
        --eval mAP --bf16
    python -m orientedobjectdetection_torch.tools.test <config> <ckpt> \\
        --format-only --submission-dir out/
    python -m torch.distributed.run --nproc_per_node 2 \\
        -m orientedobjectdetection_torch.tools.test <config> <ckpt> \\
        --eval mAP --collect-dir work/collect

Runs on the card (``--device cpu`` for the CPU). ``--format-only`` detects
on the config's test split and writes the DOTA Task1 submission files and
their zip (``DOTADataset.format_results``); ``--tta`` detects each image
with its horizontal and vertical flips (``inference_detector_tta``).
``--data-parallel`` keeps one replica on each local card and splits every
batch over them (``DetectorBundle(devices=...)``; two replicas with
``--device cpu``). Launched as several
processes, each rank evaluates every ``WORLD_SIZE``-th image and the ranks
gather their results through ``--collect-dir``, a directory they all see;
rank 0 writes and prints. ``--show-dir`` writes each image with its
detections above ``--show-score-thr`` drawn
(``core/visualization.py:imshow_det_rbboxes``); ``--show`` does the same
into ``--show-dir`` or ``show/``, since the port opens no window.
"""

from __future__ import annotations

import argparse
import os
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
    p.add_argument('--data-parallel', action='store_true',
                   help='a replica on every local card, each batch split '
                        'over them')
    p.add_argument('--tta', action='store_true')
    p.add_argument('--collect-dir', default=None,
                   help='a directory every rank sees, for the gather of '
                        'the ranks\' results')
    p.add_argument('--show', action='store_true',
                   help='draw the detections into --show-dir (default '
                        'show/): the port opens no window')
    p.add_argument('--show-dir', default=None,
                   help='directory for the images with their detections '
                        'drawn')
    p.add_argument('--show-score-thr', type=float, default=0.3)
    p.add_argument('--cfg-options', nargs='+', default=[])
    return p.parse_args(argv)


def show_results(dataset, results, show_dir: str, score_thr: float,
                 version: str) -> None:
    """Each image with its detections drawn, written to ``show_dir`` under
    its file name (JAX ``tools/test.py:_show_results``; reference
    ``show_result`` -> ``imshow_det_rbboxes``)."""
    from ..core.visualization import imshow_det_rbboxes
    os.makedirs(show_dir, exist_ok=True)
    for info, result in zip(dataset.data_infos, results):
        imshow_det_rbboxes(osp.join(dataset.img_prefix, info['filename']),
                           result, class_names=dataset.CLASSES,
                           score_thr=score_thr, version=version,
                           out_file=osp.join(show_dir, info['filename']))
    print(f'annotated images written to {show_dir}')


def main(argv=None):
    args = parse_args(argv)
    import torch
    from ..apis.eval import _default_norm, batched_eval
    from ..apis.inference import inference_detector_tta, init_detector
    from ..datasets import build_dataset
    from ..parallel import mesh

    cfg = load_config(args.config, args.cfg_options)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    device_norm = _default_norm(cfg) if \
        cfg.data.get('normalize_on_device', True) else None
    device = torch.device(args.device)
    if mesh.init_distributed(device):
        device = mesh.rank_device(device)
    devices = None
    if args.data_parallel:
        # every local card; on the CPU two replicas (the split, tested)
        devices = [torch.device('cuda', i)
                   for i in range(torch.cuda.device_count())] \
            if device.type == 'cuda' else [device, device]
    bundle = init_detector(cfg, args.checkpoint, device=device,
                           dtype=dtype, device_norm=device_norm,
                           devices=devices)
    lead = mesh.rank() == 0
    split = 'test' if args.format_only else 'val'
    dataset = build_dataset(dict(cfg.data[split], test_mode=True,
                                 filter_empty_gt=False))
    n = len(dataset) if args.max_images is None else \
        min(args.max_images, len(dataset))
    if args.tta:
        if mesh.is_distributed():
            raise SystemExit('--tta runs in one process')
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
                               max_images=n, collect_dir=args.collect_dir)
    if not lead:                          # rank 0 writes and prints
        return None
    version = cfg.model.get('bbox_head', {}).get(
        'version', cfg.get('angle_version', 'le90'))
    if args.show or args.show_dir:
        dataset.data_infos = dataset.data_infos[:n]
        show_results(dataset, results, args.show_dir or 'show',
                     args.show_score_thr, version)
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
