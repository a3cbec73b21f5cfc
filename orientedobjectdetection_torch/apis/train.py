"""Config-driven training loop (counterpart of
``orientedobjectdetection_tpu/apis/train.py``; the reference's mmcv runner
stack, ``apis/train.py:16-144``).

One process a device: the DOTA-layout dataset and its pipeline feed
the prefetching :class:`DataLoader`, each batch goes through
``make_train_step``, a JSONL line is logged every ``log_interval`` steps
(``train_log.jsonl``), a checkpoint is written every
``checkpoint_config.interval`` epochs and at the end, and every
``evaluation.interval`` epochs the val split's mAP is measured through one
persistent :class:`DetectorBundle`, with a ``best`` checkpoint on a new
best mAP.

Several processes (``WORLD_SIZE > 1``, launched by
``python -m torch.distributed.run --nproc_per_node N -m
orientedobjectdetection_torch.tools.train <config>``) train one model on
a global batch of ``samples_per_gpu x WORLD_SIZE``: each rank loads its
shard of every epoch, the step is data-parallel (``make_train_step`` inside
the process group that :func:`..parallel.mesh.init_distributed` joins), the
evaluation splits the images over the ranks
(``batched_eval(collect_dir=...)``), and only rank 0 writes the log and the
checkpoints.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..datasets import build_dataset
from ..datasets.loader import DataLoader, strip_host_normalize
from ..models import build_detector
from ..parallel import mesh
from ..parallel.train_state import (TrainState, build_lr_schedule,
                                    build_optimizer, create_train_state,
                                    make_train_step, sync_state)
from ..utils.checkpoint import (find_latest_checkpoint, load_checkpoint,
                                save_checkpoint)
from .eval import _default_norm, eval_from_state
from .inference import init_detector


@dataclass
class TrainingSetup:
    """What :func:`train_detector` runs: the prefetching loader over the
    train split, the LR schedule, the train state and the step."""
    loader: DataLoader
    batch_size: int
    steps_per_epoch: int
    total_steps: int
    sched: Callable
    state: TrainState
    step_fn: Callable


def setup_training(cfg, max_steps: Optional[int] = None,
                   dtype=torch.float32, seed: int = 0,
                   device='cuda') -> TrainingSetup:
    """Build ``cfg``'s training: the device-normalization strip, the
    dataset and loader (this rank's shard in a process group), the
    detector, the LR schedule from ``steps_per_epoch``, the optimizer with
    grad clip and frozen stages, a fresh train state on ``device`` (rank
    0's weights on every rank) and the train step, data-parallel in a
    process group. ``batch_size`` is the rank's, ``samples_per_gpu``."""
    # the pipeline's Normalize moves into the step: uint8 host batches
    train_cfg = dict(cfg.data['train'])
    device_norm = None
    if cfg.data.get('normalize_on_device', True):
        train_cfg, device_norm = strip_host_normalize(train_cfg)
    dataset = build_dataset(train_cfg, seed=seed)
    batch_size = int(cfg.data.get('samples_per_gpu', 2))
    loader = DataLoader(
        dataset, batch_size=batch_size,
        max_gt=int(cfg.data.get('max_gt', 512)),
        pad_size=cfg.data.get('pad_size'),
        num_workers=int(cfg.data.get('workers_per_gpu', 2)) * 4,
        worker_type=cfg.data.get('worker_type', 'thread'), seed=seed,
        shard_id=mesh.rank(), num_shards=mesh.world_size())
    steps_per_epoch = len(loader)
    if steps_per_epoch == 0:
        raise ValueError(f'{len(dataset)} training images make no batch of '
                         f'{batch_size}')
    max_epochs = int(cfg.runner.get('max_epochs', 12))
    total_steps = max_steps or steps_per_epoch * max_epochs

    detector = build_detector(dict(cfg.model))
    sched = build_lr_schedule(dict(cfg.lr_config),
                              float(cfg.optimizer['lr']), steps_per_epoch,
                              total_steps=total_steps)
    frozen = int(cfg.model.get('backbone', {}).get('frozen_stages', -1))
    grad_clip = (cfg.get('optimizer_config') or {}).get('grad_clip')
    tx = build_optimizer(dict(cfg.optimizer), sched,
                         dict(grad_clip) if grad_clip else None,
                         frozen_stages=frozen)
    state = create_train_state(detector, tx, device=device, seed=seed)
    norm_eval = bool(cfg.model.get('backbone', {}).get('norm_eval', True))
    step_fn = make_train_step(detector, tx, norm_eval=norm_eval,
                              device_norm=device_norm, dtype=dtype)
    return TrainingSetup(loader, batch_size, steps_per_epoch, total_steps,
                         sched, state, step_fn)


def train_detector(cfg, work_dir: str, resume: bool = False,
                   resume_from: Optional[str] = None,
                   max_steps: Optional[int] = None, log_interval: int = 50,
                   dtype=torch.float32, seed: int = 0, device='cuda'):
    """Train ``cfg``'s detector on ``cfg.data.train`` into ``work_dir`` and
    return the :class:`TrainState`.

    ``max_steps`` caps the run (default: ``runner.max_epochs`` epochs);
    ``resume`` continues from the newest ``ckpt_*.pth`` of ``work_dir``,
    ``resume_from`` from that file; ``dtype=torch.bfloat16`` trains under
    autocast on float32 master weights and evaluates in bf16. ``device``
    defaults to the card and raises without one, unless ``'cpu'`` is asked
    for.

    Under ``torch.distributed.run`` (``WORLD_SIZE > 1``) the process joins
    the group (``parallel/mesh.py:init_distributed``: NCCL on the cards,
    gloo for ``device='cpu'``) and trains on ``cuda:<LOCAL_RANK>``. Each
    rank takes ``samples_per_gpu`` images a step, so the global batch is
    ``samples_per_gpu x WORLD_SIZE``: the JAX package's is
    ``samples_per_gpu x local_device_count`` a process, one program over
    all of them; here a process drives one card, and the step's losses,
    gradient and update are the same global batch's. Only rank 0 writes
    the JSONL log, the checkpoints and the ``best`` checkpoint (the JAX
    package's ``process_index() == 0``)."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('train_detector: no CUDA device is available; '
                           'pass device="cpu" to run on the CPU')
    mesh.init_distributed(device)
    device = mesh.rank_device(device) if mesh.is_distributed() else device
    lead = mesh.rank() == 0
    os.makedirs(work_dir, exist_ok=True)
    log_path = osp.join(work_dir, 'train_log.jsonl')
    setup = setup_training(cfg, max_steps, dtype, seed, device)
    loader, batch_size, sched = setup.loader, setup.batch_size, setup.sched
    steps_per_epoch, total_steps = setup.steps_per_epoch, setup.total_steps
    state, step_fn = setup.state, setup.step_fn
    global_batch = batch_size * mesh.world_size()
    resumed = resume_from or (find_latest_checkpoint(work_dir) if resume
                              else None)
    if resumed:
        state = sync_state(load_checkpoint(resumed, state))
        print(f'resumed from {resumed} (step {state.step})')

    # in-training evaluation (the reference's EvalHook)
    eval_cfg = dict(cfg.get('evaluation') or {})
    eval_interval = int(eval_cfg.get('interval', 1))        # in epochs
    eval_dataset = eval_bundle = None
    if eval_cfg and cfg.data.get('val') and \
            eval_cfg.get('metric', 'mAP') == 'mAP':
        eval_dataset = build_dataset(dict(cfg.data['val'], test_mode=True,
                                          filter_empty_gt=False))
        if len(eval_dataset) == 0:
            print(f'no val images under {eval_dataset.ann_file}: '
                  'no in-training evaluation')
            eval_dataset = None

    def run_eval():
        nonlocal eval_bundle
        if eval_bundle is None:
            eval_norm = _default_norm(cfg) if \
                cfg.data.get('normalize_on_device', True) else None
            eval_bundle = init_detector(cfg, state.model.state_dict(),
                                        device=device, dtype=dtype,
                                        device_norm=eval_norm)
        return eval_from_state(
            eval_bundle, state.model.state_dict(), eval_dataset,
            batch_size=int(eval_cfg.get('samples_per_gpu', 8)),
            max_images=eval_cfg.get('max_images'),
            collect_dir=osp.join(work_dir, 'eval_collect')
            if mesh.is_distributed() else None)

    ckpt_interval = int(dict(cfg.get('checkpoint_config')
                             or {}).get('interval', 1))     # in epochs
    best_map = -1.0
    step = state.step
    t0 = time.time()
    with (open(log_path, 'a') if lead else open(os.devnull, 'w')) as logf:
        def log(record):
            logf.write(json.dumps(record) + '\n')
            logf.flush()

        while step < total_steps:
            for batch in loader:
                batch = {k: v for k, v in batch.items() if k != 'img_metas'}
                state, metrics = step_fn(state, batch)
                step = state.step
                if step % log_interval == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    m.update(step=step, epoch=step // steps_per_epoch,
                             lr=float(sched(step)),
                             imgs_per_sec=global_batch * log_interval /
                             (time.time() - t0))
                    t0 = time.time()
                    log(m)
                    if lead:
                        print(f'step {step}/{total_steps} ' +
                              ' '.join(f'{k}={v:.4f}' for k, v in m.items()
                                       if isinstance(v, float)), flush=True)
                if step % steps_per_epoch == 0:
                    epoch = step // steps_per_epoch
                    if lead and epoch % ckpt_interval == 0:
                        save_checkpoint(work_dir, state, step)
                    if eval_dataset is not None and \
                            epoch % eval_interval == 0:
                        ev = run_eval()
                        log(dict(step=step, epoch=epoch, mode='val',
                                 **{k: float(v) for k, v in ev.items()}))
                        if lead:
                            print(f'epoch {epoch} val: {ev}', flush=True)
                        if float(ev.get('mAP', -1)) > best_map:
                            best_map = float(ev['mAP'])
                            if lead:
                                save_checkpoint(work_dir, state, step,
                                                prefix='best')
                        t0 = time.time()
                if step >= total_steps:
                    break
    loader.close()
    if lead:
        save_checkpoint(work_dir, state, step)
    mesh.barrier()
    return state
