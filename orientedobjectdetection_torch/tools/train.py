"""Training command line (counterpart of ``tools/train.py``; reference
``tools/train.py:25-190``).

    python -m orientedobjectdetection_torch.tools.train \\
        configs/rotated_retinanet/rotated_retinanet_tiny_synth.py \\
        --work-dir work_dirs/exp --bf16 --cfg-options data_root=...

Trains on the card (``--device cpu`` for the CPU). Several processes train
one data-parallel model under ``python -m torch.distributed.run
--nproc_per_node N -m orientedobjectdetection_torch.tools.train <config>``
(``tools/__init__.py``).
"""

from __future__ import annotations

import argparse
import ast
import os
import os.path as osp


def parse_cfg_options(items):
    """``a.b.c=value`` strings -> a dict for ``Config.merge_from_dict``;
    values are Python literals where they parse as one."""
    opts = {}
    for item in items:
        key, _, val = item.partition('=')
        try:
            val = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            pass
        opts[key] = val
    return opts


def load_config(path, cfg_options):
    """The config at ``path`` with ``--cfg-options`` merged in. A
    ``data_root`` option also rewrites the dataset paths the config built
    from its own ``data_root`` (configs join it into ``ann_file`` and
    ``img_prefix`` when they load)."""
    from ..utils import Config
    cfg = Config.fromfile(path)
    opts = parse_cfg_options(cfg_options)
    new_root = opts.get('data_root')
    if new_root is not None and cfg.get('data_root'):
        old_root = cfg.data_root
        for split in ('train', 'val', 'test'):
            ds = cfg.data.get(split)
            for key in ('ann_file', 'img_prefix'):
                if ds and isinstance(ds.get(key), str) and \
                        ds[key].startswith(old_root):
                    opts[f'data.{split}.{key}'] = osp.join(
                        new_root, ds[key][len(old_root):])
    if opts:
        cfg.merge_from_dict(opts)
    return cfg


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Train a rotated detector')
    p.add_argument('config')
    p.add_argument('--work-dir', default=None)
    p.add_argument('--resume-from', default=None)
    p.add_argument('--auto-resume', action='store_true')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--max-steps', type=int, default=None)
    p.add_argument('--log-interval', type=int, default=50)
    p.add_argument('--bf16', action='store_true',
                   help='bf16 autocast (float32 master weights)')
    p.add_argument('--device', default='cuda',
                   help='cuda (the default) or cpu')
    p.add_argument('--profile-dir', default=None,
                   help='write a torch.profiler trace of the whole run')
    p.add_argument('--cfg-options', nargs='+', default=[])
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch
    from ..apis.train import train_detector

    cfg = load_config(args.config, args.cfg_options)
    work_dir = args.work_dir or osp.join(
        'work_dirs', osp.splitext(osp.basename(args.config))[0])
    dtype = torch.bfloat16 if args.bf16 else torch.float32

    def run():
        return train_detector(cfg, work_dir, resume=args.auto_resume,
                              resume_from=args.resume_from,
                              max_steps=args.max_steps,
                              log_interval=args.log_interval, dtype=dtype,
                              seed=args.seed, device=args.device)

    if not args.profile_dir:
        return run()
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.device(args.device).type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        state = run()
    os.makedirs(args.profile_dir, exist_ok=True)
    prof.export_chrome_trace(osp.join(args.profile_dir, 'trace.json'))
    return state


if __name__ == '__main__':
    main()
