"""The DOTA huge-image flow on synthetic scenes with the port's tools
(counterpart of ``tools/data/synth/tiled_eval_demo.py``): six 1024 px
scenes from :mod:`.generate_synth`, tiled by :mod:`.img_split` at 256 px
with a 64 px gap (``--ms``: at rates 0.5, 1.0 and 2.0, windows of 512, 256
and 128 px on a 512 px canvas), detected tile by tile with a trained
checkpoint (``batched_eval``), merged back and written as the Task1
submission (``format_results``), and scored against the scenes' own
annotations: the original-frame mAP. The same scenes detected whole, on a
canvas of their size, give the mAP the tiling is held against.

    python -m orientedobjectdetection_torch.tools.tiled_eval_demo \\
        configs/rotated_retinanet/rotated_retinanet_tiny_synth.py \\
        work_dirs/tiny/ckpt_00002500.pth --root _data/tiled [--ms]

Runs on the card (``--device cpu`` for the CPU).
"""

from __future__ import annotations

import argparse
import os.path as osp
import zipfile

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Tiled DOTA evaluation demo')
    p.add_argument('config')
    p.add_argument('checkpoint')
    p.add_argument('--root', required=True,
                   help='directory for the scenes, tiles and submission')
    p.add_argument('--ms', action='store_true',
                   help='the multi-scale split (rates 0.5 1.0 2.0)')
    p.add_argument('--num-images', type=int, default=6)
    p.add_argument('--size', type=int, default=1024)
    p.add_argument('--bf16', action='store_true')
    p.add_argument('--device', default='cuda',
                   help='cuda (the default) or cpu')
    p.add_argument('--cfg-options', nargs='+', default=[])
    return p.parse_args(argv)


def main(argv=None) -> float:
    """Run the flow; returns the original-frame mAP."""
    args = parse_args(argv)
    import torch
    from ..apis.eval import _default_norm, batched_eval
    from ..apis.inference import init_detector
    from ..core.eval_map import eval_rbbox_map
    from ..datasets import build_dataset
    from . import img_split
    from .generate_synth import generate_synth
    from .train import load_config

    big = osp.join(args.root, 'big')
    split = osp.join(args.root, 'split_ms' if args.ms else 'split')
    generate_synth(big, num_images=args.num_images, size=args.size, seed=7,
                   split='test', max_objs=18)
    rates = ['0.5', '1.0', '2.0'] if args.ms else ['1.0']
    n_tiles = img_split.main([
        '--img-dirs', f'{big}/test/images', '--ann-dirs',
        f'{big}/test/annfiles', '--save-dir', split, '--sizes', '256',
        '--gaps', '64', '--rates', *rates])

    cfg = load_config(args.config, args.cfg_options)
    if args.ms:                  # a canvas for the largest (512 px) window
        cfg.merge_from_dict({'pad_size': (512, 512),
                             'data.pad_size': (512, 512)})
    spec = dict(cfg.data['test'], test_mode=True, filter_empty_gt=False,
                ann_file=f'{split}/annfiles/', img_prefix=f'{split}/images/')
    dataset = build_dataset(spec)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    bundle = init_detector(cfg, args.checkpoint, device=args.device,
                           dtype=dtype, device_norm=_default_norm(cfg))
    results = batched_eval(bundle, dataset, batch_size=8, progress=False)
    zip_path = dataset.format_results(
        results, submission_dir=osp.join(args.root, 'submission'),
        device=bundle.device)
    with zipfile.ZipFile(zip_path) as zf:
        names = zf.namelist()
        lines = sum(len(zf.read(n).decode().splitlines()) for n in names)
    print(f'{n_tiles} tiles; submission {zip_path}: {names}, {lines} '
          f'detections')

    ids, merged = dataset.merge_det(results, device=bundle.device)
    orig = build_dataset(dict(spec, ann_file=f'{big}/test/annfiles/',
                              img_prefix=f'{big}/test/images/'))
    by_id = {osp.splitext(info['filename'])[0]: info['ann']
             for info in orig.data_infos}
    annotations = [dict(bboxes=by_id[i]['bboxes'], labels=by_id[i]['labels'],
                        bboxes_ignore=np.zeros((0, 5), np.float32),
                        labels_ignore=np.zeros((0,), np.int64))
                   for i in ids]
    mean_ap, _ = eval_rbbox_map(merged, annotations, iou_thr=0.5,
                                dataset=orig.CLASSES, device=bundle.device)
    print(f'ORIGINAL-FRAME tiled-merge mAP: {mean_ap:.4f}', flush=True)

    whole_cfg = cfg.copy()
    whole_cfg.merge_from_dict({'pad_size': (args.size, args.size)})
    whole = init_detector(whole_cfg, args.checkpoint, device=args.device,
                          dtype=dtype, device_norm=_default_norm(cfg))
    whole_ap = orig.evaluate(batched_eval(whole, orig, batch_size=8,
                                          progress=False),
                             device=whole.device)['mAP']
    print(f'WHOLE-IMAGE mAP of the same scenes: {whole_ap:.4f}', flush=True)
    return mean_ap


if __name__ == '__main__':
    main()
