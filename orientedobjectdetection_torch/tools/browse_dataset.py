"""Samples after the train pipeline, drawn (counterpart of
``tools/misc/browse_dataset.py``).

    python -m orientedobjectdetection_torch.tools.browse_dataset <config> \\
        --output-dir browse_out --num 8

Each of the first ``--num`` samples of the train split, through its
pipeline (augmentation included), un-normalized and written as
``sample_<i>.png`` with its gts drawn in their classes' colors
(``core/visualization.py:imshow_det_rbboxes``). Runs on the host.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np


def draw_sample(sample: dict, num_classes: int, class_names,
                version: str, out_file: str, norm=None) -> np.ndarray:
    """One pipeline output with its gts drawn, written to ``out_file``; the
    image un-normalized with the sample's ``img_norm_cfg``, else with
    ``norm`` (the pipeline's ``Normalize``, which ``Collect`` drops)."""
    from ..core.visualization import imshow_det_rbboxes
    img = np.asarray(sample['img'], np.float32)
    norm = sample.get('img_norm_cfg', norm)
    if norm is not None:                       # un-normalize for display
        img = img * norm['std'] + norm['mean']
        if norm.get('to_rgb'):
            img = img[..., ::-1]
    img = np.ascontiguousarray(np.clip(img, 0, 255).astype(np.uint8))
    boxes = np.asarray(sample.get('gt_bboxes', np.zeros((0, 5))),
                       np.float32).reshape(-1, 5)
    labels = np.asarray(sample.get('gt_labels', np.zeros((0,))),
                        np.int64).reshape(-1)
    per_cls = []
    for c in range(num_classes):
        m = labels == c
        per_cls.append(np.concatenate([boxes[m], np.ones((m.sum(), 1))], -1))
    return imshow_det_rbboxes(img, per_cls, class_names=class_names,
                              score_thr=0, version=version,
                              out_file=out_file)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Draw train samples')
    p.add_argument('config')
    p.add_argument('--output-dir', default='browse_out')
    p.add_argument('--num', type=int, default=8)
    p.add_argument('--cfg-options', nargs='+', default=[])
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..datasets import build_dataset, strip_host_normalize
    from .train import load_config
    cfg = load_config(args.config, args.cfg_options)
    dataset = build_dataset(cfg.data['train'])
    _, norm = strip_host_normalize(cfg.data['train'])
    os.makedirs(args.output_dir, exist_ok=True)
    version = cfg.data['train'].get('version', 'oc')
    n = min(args.num, len(dataset))
    for i in range(n):
        draw_sample(dataset[i], len(dataset.CLASSES), dataset.CLASSES,
                    version, osp.join(args.output_dir, f'sample_{i}.png'),
                    norm)
    print(f'wrote {n} samples to {args.output_dir}')
    return n


if __name__ == '__main__':
    main()
