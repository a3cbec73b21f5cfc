"""Checkpoint save / restore and auto-resume for the port's train state
(counterpart of ``orientedobjectdetection_tpu/utils/checkpoint.py``).

A checkpoint is one ``torch.save`` of the model's ``state_dict`` (mmrotate
names), the optimizer's ``state_dict`` and the step, written to a temporary
file and renamed, so a reader never sees half a file. File names follow the
JAX package's pattern with a ``.pth`` suffix: ``ckpt_00000042.pth``.
"""

from __future__ import annotations

import os
import os.path as osp
import re
from typing import List, Optional

import torch

SUFFIX = '.pth'


def _ckpt_path(work_dir: str, step: int, prefix: str = 'ckpt') -> str:
    return osp.join(osp.abspath(work_dir), f'{prefix}_{step:08d}{SUFFIX}')


def _with_prefix(work_dir: str, prefix: str) -> List[str]:
    if not osp.isdir(work_dir):
        return []
    pattern = rf'{re.escape(prefix)}_\d{{8}}{re.escape(SUFFIX)}'
    return sorted(osp.join(osp.abspath(work_dir), n)
                  for n in os.listdir(work_dir) if re.fullmatch(pattern, n))


def save_checkpoint(work_dir: str, state, step: int, keep: int = 3,
                    prefix: str = 'ckpt') -> str:
    """Save ``state`` (a ``TrainState``) as step ``step``; of the rotating
    ``ckpt`` files the newest ``keep`` stay. ``prefix='best'`` saves a
    best-mAP checkpoint outside the rotation and keeps only the newest of
    that prefix (the reference EvalHook's ``save_best``)."""
    os.makedirs(work_dir, exist_ok=True)
    path = _ckpt_path(work_dir, step, prefix)
    tmp = path + '.tmp'
    torch.save(dict(model=state.model.state_dict(),
                    optimizer=state.optimizer.state_dict(),
                    step=int(step)), tmp)
    os.replace(tmp, path)  # atomic
    stale = _with_prefix(work_dir, prefix)
    for old in stale[:-keep] if prefix == 'ckpt' else stale[:-1]:
        os.remove(old)
    return path


def find_checkpoints(work_dir: str) -> List[str]:
    return _with_prefix(work_dir, 'ckpt')


def find_latest_checkpoint(work_dir: str) -> Optional[str]:
    ckpts = find_checkpoints(work_dir)
    return ckpts[-1] if ckpts else None


def load_checkpoint(path: str, target):
    """Restore ``path`` into ``target`` (a ``TrainState``: its model and
    optimizer are loaded in place, on their own devices) and return it."""
    payload = torch.load(path, map_location='cpu', weights_only=True)
    target.model.load_state_dict(payload['model'])
    target.optimizer.load_state_dict(payload['optimizer'])
    target.step = int(payload['step'])
    return target
