"""The synth-hard protocol on the port (counterpart of
``tools/data/synth/run_hard_protocol.sh``, ``run_families_oneproc.py`` and
``hard_summary_table.py``): 15 DOTA classes, 100-600 crowded 8-32 px
objects a 512² scene, near-touching same-class rows and overlapping twins,
more objects than the loader's ``max_gt=256`` (the overflow goes to
``gt_ignore``). Every ``*_hard_synth.py`` family trains in this one
process, one after another, and the spread of their val mAP is the result.

    python -m orientedobjectdetection_torch.tools.hard_protocol \\
        [configs ...] [--data-root DIR] [--work-root DIR] [--epochs 12] \\
        [--seed 0] [--device cuda]

- The data (120 trainval scenes at seed 0, 24 val scenes at seed 7, 512²)
  is written with :func:`.generate_synth.generate_synth_hard` where the
  data root holds fewer images; a root other than the configs'
  ``/tmp/synth_hard/`` goes through ``tools/train.py``'s ``data_root``
  rewrite.
- Each family trains with :func:`..apis.train.train_detector` in bf16
  with auto-resume for ``epochs`` epochs, evaluating and writing a
  checkpoint every 4, into ``<work root>/<config stem>/``. A family whose
  ``train_log.jsonl`` holds the ``"epoch": <epochs>, "mode": "val"`` record
  is skipped.
- A family that raises has its traceback in its ``run.log`` (which holds
  all of its output) and the runner goes on to the next; at the end it
  raises :class:`ProtocolFailed` naming every family that failed, and the
  command exits with 1.
- ``summary.json`` in the work root and the printed table give each
  family's best val mAP and its epoch, the final mAP, the trajectory, the
  median train imgs/s after step 50, the wall seconds, and the
  reference's best mAP read from ``work_dirs/hard/<family>/train_log.jsonl``.

Runs on the card; ``--device cpu`` (float32) for the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import os.path as osp
import shutil
import sys
import time
import traceback
from typing import Dict, List, Optional, Sequence

import torch

REPO = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
DATA_ROOT = '/tmp/synth_hard/'            # the configs' data_root
WORK_ROOT = 'work_dirs/hard_torch'
REFERENCE_ROOT = osp.join(REPO, 'work_dirs', 'hard')
# the reference's table in its order, then the families it left unfinished
FAMILIES = (
    'rotated_faster_rcnn/rotated_faster_rcnn_hard_synth.py',
    'rotated_fcos/rotated_fcos_hard_synth.py',
    'r3det/r3det_hard_synth.py',
    's2anet/s2anet_hard_synth.py',
    'rotated_reppoints/rotated_reppoints_hard_synth.py',
    'kld/kld_hard_synth.py',
    'rotated_retinanet/rotated_retinanet_hard_synth.py',
    'kfiou/kfiou_hard_synth.py',
    'gwd/gwd_hard_synth.py',
    'g_reppoints/g_reppoints_hard_synth.py',
    'csl/csl_hard_synth.py',
    'oriented_rcnn/oriented_rcnn_hard_synth.py',
    'gliding_vertex/gliding_vertex_hard_synth.py',
    'roi_trans/roi_trans_hard_synth.py',
    'cfa/cfa_hard_synth.py',
    'oriented_reppoints/oriented_reppoints_hard_synth.py',
    'redet/redet_hard_synth.py',
    'sasm_reppoints/sasm_hard_synth.py',
    'jy/rotated_yolov8_hard_synth.py',
)
CONFIGS = tuple(osp.join(REPO, 'configs', f) for f in FAMILIES)
# the sets run_hard_protocol.sh writes: (split, images, seed)
SPLITS = (('trainval', 120, 0), ('val', 24, 7))
EVAL_INTERVAL = 4                          # epochs, as the reference's runs
IPS_AFTER_STEP = 50                        # hard_summary_table.py's cut


class ProtocolFailed(RuntimeError):
    """Families raised; ``summary`` is what the run wrote."""

    def __init__(self, failed: Sequence[str], summary: dict):
        super().__init__(f'{len(failed)} families failed: '
                         f'{", ".join(failed)} (tracebacks in their run.log)')
        self.failed = list(failed)
        self.summary = summary


def count_images(root: str, split: str) -> int:
    folder = osp.join(root, split, 'images')
    return len(os.listdir(folder)) if osp.isdir(folder) else 0


def ensure_data(data_root: str, splits=SPLITS, size: int = 512) -> bool:
    """Write the protocol's scenes where ``data_root`` holds fewer than a
    split asks for (a dead run leaves a partial folder: the split is
    written again whole). Returns whether anything was written."""
    from .generate_synth import generate_synth_hard
    wrote = False
    for split, num, seed in splits:
        if count_images(data_root, split) >= num:
            continue
        shutil.rmtree(osp.join(data_root, split), ignore_errors=True)
        generate_synth_hard(data_root, num, size, seed, split)
        wrote = True
    return wrote


def read_log(path: str) -> List[dict]:
    """The JSON records of a ``train_log.jsonl`` (a line cut by a dead run
    is passed over)."""
    if not osp.exists(path):
        return []
    records = []
    with open(path) as f:
        for line in f:
            try:
                records.append(json.loads(line))
            except ValueError:
                continue
    return records


def val_records(records) -> List[tuple]:
    return [(int(r.get('epoch', -1)), float(r['mAP'])) for r in records
            if r.get('mode') == 'val' and 'mAP' in r]


def is_done(work_dir: str, epochs: int) -> bool:
    return any(epoch == epochs for epoch, _ in
               val_records(read_log(osp.join(work_dir, 'train_log.jsonl'))))


def reference_best(name: str) -> Optional[float]:
    """The reference's best val mAP of ``name`` (its train_log.jsonl, mAP
    records only), None where it logged none."""
    vals = val_records(read_log(osp.join(REFERENCE_ROOT, name,
                                         'train_log.jsonl')))
    return max(m for _, m in vals) if vals else None


def family_row(name: str, work_dir: str, wall_s: Optional[float]) -> dict:
    """One family's summary from its log, as ``hard_summary_table.py``
    reads it: best and final val mAP with their epochs, the trajectory,
    the median imgs/s of the records after step 50."""
    records = read_log(osp.join(work_dir, 'train_log.jsonl'))
    vals = val_records(records)
    ips = sorted(float(r['imgs_per_sec']) for r in records
                 if 'imgs_per_sec' in r and
                 r.get('step', 0) > IPS_AFTER_STEP)
    row = dict(name=name, best=None, best_epoch=None, final=None,
               final_epoch=None, trajectory={},
               imgs_per_sec=ips[len(ips) // 2] if ips else None,
               wall_s=wall_s, reference_best=reference_best(name))
    if vals:
        best_epoch, best = max(vals, key=lambda v: v[1])
        row.update(best=best, best_epoch=best_epoch, final=vals[-1][1],
                   final_epoch=vals[-1][0],
                   trajectory={str(e): m for e, m in vals})
    return row


def format_table(rows: List[dict]) -> str:
    def num(v, fmt):
        return 'n/a' if v is None else format(v, fmt)

    lines = ['| family | best val mAP | @epoch | final (ep) | trajectory | '
             'train imgs/s | wall s | reference best | status |',
             '|---|---|---|---|---|---|---|---|---|']
    for r in sorted(rows, key=lambda r: -(r['best'] if r['best'] is not None
                                          else -1.0)):
        traj = ' / '.join(f'{m:.3f}' for m in r['trajectory'].values())
        lines.append(
            f"| {r['name'].replace('_hard_synth', '')} | "
            f"{num(r['best'], '.4f')} | {num(r['best_epoch'], 'd')} | "
            f"{num(r['final'], '.4f')} ({num(r['final_epoch'], 'd')}) | "
            f"{traj or 'n/a'} | {num(r['imgs_per_sec'], '.2f')} | "
            f"{num(r['wall_s'], '.1f')} | {num(r['reference_best'], '.4f')} "
            f"| {r['status']} |")
    return '\n'.join(lines)


class _Tee:
    """Writes to a stream and a log file both."""

    def __init__(self, stream, logf):
        self.stream, self.logf = stream, logf

    def write(self, text):
        self.stream.write(text)
        self.logf.write(text)
        return len(text)

    def flush(self):
        self.stream.flush()
        self.logf.flush()


def load_family(config: str, data_root: str, epochs: int):
    """``config`` with the protocol's schedule, its data under
    ``data_root``."""
    from .train import load_config
    interval = min(EVAL_INTERVAL, epochs)
    return load_config(config, [f'runner.max_epochs={epochs}',
                                f'evaluation.interval={interval}',
                                f'checkpoint_config.interval={interval}',
                                f'data_root={osp.join(data_root, "")}'])


def run_protocol(configs: Optional[Sequence[str]] = None,
                 work_root: str = WORK_ROOT,
                 data_root: str = DATA_ROOT, epochs: int = 12,
                 device='cuda', dtype=torch.bfloat16, seed: int = 0,
                 splits=None, image_size: int = 512,
                 log_interval: int = 50) -> Dict:
    """Train every config of ``configs`` (default: all 19 families in the
    reference table's order) for ``epochs`` epochs into
    ``work_root/<config stem>/``, skipping the families already done, and
    write ``summary.json``. Returns the summary (``families``: a row a
    family; ``failed``; ``trained``: the families that took a step here);
    raises :class:`ProtocolFailed` after the summary where a family
    raised. ``splits``: (split, images, seed) of the data it writes where
    they are missing (``SPLITS``)."""
    if torch.device(device).type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('hard_protocol: no CUDA device is available; '
                           'pass device="cpu" to run on the CPU')
    from ..apis.train import train_detector
    from ..utils.checkpoint import find_latest_checkpoint
    configs = list(configs or CONFIGS)
    os.makedirs(work_root, exist_ok=True)
    summary_path = osp.join(work_root, 'summary.json')
    old = {}
    if osp.exists(summary_path):
        with open(summary_path) as f:
            old = {r['name']: r for r in json.load(f).get('families', [])}
    if ensure_data(data_root, splits or SPLITS, image_size):
        print(f'wrote the synth-hard scenes under {data_root}', flush=True)
    rows, failed, trained = [], [], []

    def write_summary():
        # after every family: a run that dies keeps what it finished
        summary = dict(epochs=epochs, seed=seed, device=str(device),
                       dtype=str(dtype).split('.')[-1], families=rows,
                       failed=failed, trained=trained)
        with open(summary_path, 'w') as f:
            json.dump(summary, f, indent=1)
        return summary

    for config in configs:
        name = osp.splitext(osp.basename(config))[0]
        work_dir = osp.join(work_root, name)
        wall = old.get(name, {}).get('wall_s')
        if is_done(work_dir, epochs):
            print(f'==== {name} (already done, skipping) ====', flush=True)
            rows.append(dict(family_row(name, work_dir, wall),
                             status='done'))
            write_summary()
            continue
        print(f'==== {name} ====', flush=True)
        os.makedirs(work_dir, exist_ok=True)
        log_path = osp.join(work_dir, 'train_log.jsonl')
        if find_latest_checkpoint(work_dir) is None:
            # nothing to resume from: a log left by a run that wrote no
            # checkpoint moves aside, and the family starts afresh
            if osp.exists(log_path):
                os.replace(log_path, osp.join(work_dir,
                                              'train_log.stale.jsonl'))
            wall = None
        status = 'trained'
        t0 = time.time()
        with open(osp.join(work_dir, 'run.log'), 'a') as logf, \
                contextlib.redirect_stdout(_Tee(sys.stdout, logf)), \
                contextlib.redirect_stderr(_Tee(sys.stderr, logf)):
            try:
                cfg = load_family(config, data_root, epochs)
                train_detector(cfg, work_dir, resume=True, dtype=dtype,
                               seed=seed, device=device,
                               log_interval=log_interval)
                trained.append(name)
                print(f'==== {name} finished in {time.time() - t0:.1f} s '
                      f'====', flush=True)
            except Exception:       # noqa: BLE001 -- named at the end
                traceback.print_exc()
                print(f'!!!! {name} FAILED after {time.time() - t0:.1f} s',
                      flush=True)
                failed.append(name)
                status = 'failed'
        wall = (wall or 0.0) + time.time() - t0
        rows.append(dict(family_row(name, work_dir, wall), status=status))
        write_summary()
    summary = write_summary()
    print(format_table(rows), flush=True)
    if failed:
        raise ProtocolFailed(failed, summary)
    return summary


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('configs', nargs='*',
                   help='hard configs (default: all 19 families)')
    p.add_argument('--data-root', default=DATA_ROOT)
    p.add_argument('--work-root', default=None,
                   help=f'default {WORK_ROOT}, {WORK_ROOT}_seed<N> for a '
                   'seed other than 0')
    p.add_argument('--epochs', type=int, default=12)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--device', default='cuda',
                   help='cuda (the default, bf16) or cpu (float32)')
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    work_root = args.work_root or (
        WORK_ROOT if args.seed == 0 else f'{WORK_ROOT}_seed{args.seed}')
    on_card = torch.device(args.device).type == 'cuda'
    try:
        run_protocol(args.configs or None, work_root, args.data_root,
                     args.epochs, args.device,
                     torch.bfloat16 if on_card else torch.float32,
                     args.seed)
    except ProtocolFailed as err:
        print(f'hard_protocol: {err}', file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())
