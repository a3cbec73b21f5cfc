"""Optimizer, LR schedule and the train step (counterpart of
``orientedobjectdetection_tpu/parallel/train_state.py``).

- SGD momentum or AdamW, weight decay on every trainable parameter, clip by
  global norm (``schedule_1x.py``: lr 0.0025, momentum 0.9, wd 1e-4,
  max_norm 35);
- step or cosine LR with linear warmup, a pure function of the step;
- backbone stage freezing (``ResNet.frozen_stages``): frozen parameters get
  no gradient and no update;
- the step itself: device-side normalization of raw uint8 images, forward,
  loss, backward, clip, update, with no host synchronisation inside.

Where the JAX package returns a new immutable state, the port updates the
model and the optimizer in place and returns the same :class:`TrainState`.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Union

import torch
from torch import nn
from torch.profiler import record_function

from ..core.assigners import SampleKey
from ..models.blocks import live_batch_norm
from . import mesh


@dataclass
class TrainState:
    step: int                          # optimizer steps taken so far
    model: nn.Module
    optimizer: torch.optim.Optimizer


def build_lr_schedule(lr_config: dict, base_lr: float, steps_per_epoch: int,
                      total_steps: Optional[int] = None
                      ) -> Callable[[int], float]:
    """Step-decay or cosine schedule with linear warmup (reference
    ``lr_config``): ``schedule(step) -> lr`` for the update that follows
    ``step`` earlier ones (the first update uses ``schedule(0)``).
    ``total_steps`` feeds cosine annealing when the config does not pin
    ``max_steps``."""
    policy = lr_config.get('policy', 'step')
    warmup_iters = int(lr_config.get('warmup_iters', 0) or 0)
    warmup_ratio = float(lr_config.get('warmup_ratio', 1.0))

    if policy == 'step':
        milestones = [int(e) * steps_per_epoch for e in lr_config['step']]
        gamma = float(lr_config.get('gamma', 0.1))

        def base(step):
            return base_lr * gamma ** sum(step >= m for m in milestones)
    elif policy in ('CosineAnnealing', 'cosine'):
        total = int(lr_config.get('max_steps') or total_steps or
                    steps_per_epoch * 12)
        min_ratio = float(lr_config.get('min_lr_ratio', 0.0))

        def base(step):
            t = min(max(step / max(total, 1), 0.0), 1.0)
            cos = 0.5 * (1 + math.cos(math.pi * t))
            return base_lr * (min_ratio + (1 - min_ratio) * cos)
    else:
        raise ValueError(policy)

    def schedule(step: int) -> float:
        if step < warmup_iters:
            alpha = min(max(step / warmup_iters, 0.0), 1.0)
            return base_lr * (warmup_ratio + (1 - warmup_ratio) * alpha)
        return base(step)

    return schedule


def frozen_mask(model: nn.Module, frozen_stages: int = -1) -> Dict[str, bool]:
    """``{parameter name: trainable}`` over ``model.named_parameters()``.
    ``frozen_stages >= 0`` freezes the ResNet stem (``backbone.conv1``,
    ``backbone.bn1``) and the first ``frozen_stages`` stages (reference
    ``ResNet._freeze_stages``; ``frozen_stages=1`` in every R50 config),
    the names the JAX package's ``frozen_mask`` matches: a backbone whose
    ``freeze_stem`` is False (ReResNet, whose JAX stem has other names)
    keeps its stem trainable, and Swin's and ConvNeXt's names match none."""
    frozen = []
    if frozen_stages >= 0:
        if getattr(getattr(model, 'backbone', None), 'freeze_stem', True):
            frozen += ['backbone.conv1.', 'backbone.bn1.']
        frozen += [f'backbone.layer{s}.' for s in range(1, frozen_stages + 1)]
    return {name: not name.startswith(tuple(frozen))
            for name, _ in model.named_parameters()}


class Transform:
    """What ``build_optimizer`` returns (the JAX package's optax ``tx``):
    the recipe of one update. :meth:`init` makes the ``torch.optim``
    optimizer over a model's trainable parameters; :meth:`update` applies
    clip -> weight decay -> momentum (or Adam) -> ``-lr(step)``, optax's
    order."""

    def __init__(self, optimizer_cfg: dict, lr_schedule, grad_clip,
                 frozen_stages: int):
        self.opt_type = optimizer_cfg.get('type', 'sgd').lower()
        if self.opt_type not in ('sgd', 'adamw'):
            raise ValueError(self.opt_type)
        self.cfg = dict(optimizer_cfg)
        self.lr_schedule = lr_schedule if callable(lr_schedule) \
            else (lambda step, lr=float(lr_schedule): lr)
        self.max_norm = float(grad_clip.get('max_norm', 35)) \
            if grad_clip else None
        self.frozen_stages = frozen_stages

    def init(self, model: nn.Module) -> torch.optim.Optimizer:
        """Freeze what ``frozen_mask`` says (``requires_grad = False``, so
        backward stops short of the frozen stages) and build the optimizer
        over the rest, with zero momentum."""
        mask = frozen_mask(model, self.frozen_stages)
        params = []
        for name, p in model.named_parameters():
            p.requires_grad_(mask[name])
            if mask[name]:
                params.append(p)
        lr = self.lr_schedule(0)
        wd = float(self.cfg.get('weight_decay', 0.0))
        if self.opt_type == 'sgd':
            return torch.optim.SGD(
                params, lr=lr, momentum=float(self.cfg.get('momentum', 0.9)),
                weight_decay=wd)
        betas = self.cfg.get('betas', (0.9, 0.999))
        return torch.optim.AdamW(params, lr=lr, weight_decay=wd, eps=1e-8,
                                 betas=(float(betas[0]), float(betas[1])))

    @torch.no_grad()
    def update(self, state: TrainState, reduce_grads=None) -> torch.Tensor:
        """One update from the gradients that ``backward`` left on the
        trainable parameters. Returns their global norm before the clip, a
        0-d tensor on the device. optax's clip: scale by
        ``max_norm / norm`` where ``norm >= max_norm`` (no epsilon). A
        trainable parameter that the loss does not reach (a backbone
        out-norm whose level the FPN skips) takes a zero gradient, so that
        it is decayed and carries its momentum as optax's update does.
        ``reduce_grads`` (a data-parallel step's
        ``parallel/mesh.py:all_reduce_grads``) sums the gradients across
        ranks after that, over the same tensors on every rank, so the norm,
        the clip and the update see the global batch's gradient."""
        optimizer = state.optimizer
        grads: List[torch.Tensor] = []
        for group in optimizer.param_groups:
            for p in group['params']:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                grads.append(p.grad)
        if reduce_grads is not None:
            reduce_grads(grads)
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        if self.max_norm is not None:
            scale = torch.where(norm < self.max_norm, torch.ones_like(norm),
                                self.max_norm / norm)
            torch._foreach_mul_(grads, scale)
        lr = self.lr_schedule(state.step)
        for group in optimizer.param_groups:
            group['lr'] = lr
        optimizer.step()
        return norm


def build_optimizer(optimizer_cfg: dict,
                    lr_schedule: Union[Callable[[int], float], float],
                    grad_clip: Optional[dict] = None,
                    frozen_stages: int = -1) -> Transform:
    """SGD or AdamW + weight decay + clip, mirroring the reference
    ``optimizer_config``. The weight decay reaches every trainable
    parameter, BN affine terms and biases included, as the JAX package's
    unmasked ``add_decayed_weights`` does."""
    return Transform(optimizer_cfg, lr_schedule, grad_clip, frozen_stages)


def create_train_state(detector: nn.Module, tx: Transform,
                       device: Union[str, torch.device] = 'cuda',
                       seed: int = 0, state_dict=None) -> TrainState:
    """Seeded weights (``detector.init_weights(seed)``), ``state_dict``
    loaded over them when given, the detector moved to ``device`` with
    float32 master weights, and a fresh optimizer at step 0. In a process
    group (``parallel/mesh.py``) every rank then takes rank 0's
    parameters and buffers.

    Raises RuntimeError when ``device`` is a CUDA device and none is
    present: it never falls back to the CPU."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('create_train_state: no CUDA device is '
                           'available; pass device="cpu" to run on the CPU')
    detector.init_weights(seed)
    if state_dict is not None:
        detector.load_state_dict(
            {k: torch.as_tensor(v) for k, v in state_dict.items()})
    detector.float().to(device)
    mesh.broadcast_module(detector)
    return TrainState(step=0, model=detector, optimizer=tx.init(detector))


def sync_state(state: TrainState) -> TrainState:
    """Rank 0's parameters, buffers and optimizer state on every rank (after
    a resume, whose checkpoint every rank read); the identity in one
    process."""
    mesh.broadcast_module(state.model)
    mesh.broadcast_optimizer(state.optimizer)
    return state


def normalize_images(images: torch.Tensor, norm: dict) -> torch.Tensor:
    """Raw (uint8) BGR ``(B, H, W, 3)`` images -> normalized float32, on the
    images' device: the pipeline's ``Normalize`` step moved after the copy,
    so the host sends a quarter of the bytes. ``norm`` is the config's
    ``img_norm_cfg`` (mean/std in BGR order as mmcv's; ``to_rgb`` flips the
    channel axis first)."""
    x = images.to(torch.float32)
    if norm.get('to_rgb', True):
        x = x.flip(-1)
    mean = x.new_tensor(norm['mean'])
    inv_std = 1.0 / x.new_tensor(norm['std'])
    return (x - mean) * inv_std


def make_train_step(detector: nn.Module, tx: Transform,
                    loss_weights: Optional[Dict] = None,
                    norm_eval: bool = True,
                    device_norm: Optional[dict] = None,
                    dtype: torch.dtype = torch.float32):
    """Returns ``train_step(state, batch, rng=None) -> (state, metrics)``.

    ``batch`` is the padded batch of ``models/detectors/single_stage.py``;
    its tensors may lie on the host (pinned memory makes the copies
    asynchronous). ``device_norm``: the ``img_norm_cfg`` dict when the batch
    carries raw uint8 images, normalized here on the device.
    ``dtype=torch.bfloat16`` runs the network under ``torch.autocast`` on
    float32 master weights; targets and losses stay float32.
    ``loss_weights`` is accepted and unused, as in the JAX package.
    ``norm_eval=False`` puts every BatchNorm of the detector in live mode
    for the step's forward (``models/blocks.py:live_batch_norm``):
    batch statistics, the gradient through them, and the running
    statistics updated in place, which serving and evaluation read
    afterwards and a checkpoint keeps (the JAX package's ``batch_stats``).

    ``rng``: the :class:`SampleKey` of the step's random sampling (a
    two-stage detector's RoI sampler; a single-stage detector takes none);
    by default ``SampleKey(step=state.step)``, the counterpart of the JAX
    package's ``fold_in(PRNGKey(0), step)``, hashed on the device. The
    detector is called as ``detector(images, batch=batch, train=True,
    rng=rng)``.

    ``metrics``: the detector's losses (``loss_cls`` and ``loss_bbox``; a
    two-stage detector adds ``loss_rpn_cls`` and ``loss_rpn_bbox``, Gliding
    Vertex ``loss_fix`` and ``loss_ratio``, and RoI Transformer names each
    stage's ``s{i}_loss_cls`` and ``s{i}_loss_bbox``),
    ``loss`` and ``grad_norm``, as 0-d tensors on the device; nothing in
    the step waits for them.
    ``grad_norm`` is the global norm of the trainable parameters' gradients
    before the clip. The step's four parts carry ``torch.profiler`` ranges
    (``train.forward``, ``train.loss``, ``train.backward``,
    ``train.update``).

    Inside a process group (``parallel/mesh.py``; a group of one rank
    included) the step is data-parallel: each rank passes its own rows of
    the global batch, and the step's losses, metrics, gradient,
    ``grad_norm`` and update on every rank are those of one process on the
    whole global batch, as under the JAX package's SPMD program. The rank
    runs the network on its rows, with live BatchNorm's statistics summed
    across ranks (:attr:`..models.blocks.FrozenBatchNorm.reduce`) and the
    sampling keys of its images' places in the global batch
    (:class:`SampleKey` ``offset`` / ``total``); the outputs and the gts of
    every rank are gathered (``mesh.gather_batch``, whose backward hands
    each rank its rows of the gradient), every rank computes the losses of
    the whole batch with its normalizers, and the gradients are summed
    across ranks (``mesh.all_reduce_grads``) before the clip."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'dtype must be float32 or bfloat16, got {dtype}')

    def train_step(state: TrainState, batch: dict,
                   rng: Optional[SampleKey] = None):
        if state.model is not detector:
            raise ValueError('the state was created for another detector')
        if rng is None:
            rng = SampleKey(step=state.step)
        device = next(detector.parameters()).device
        batch = {k: v.to(device, non_blocking=True)
                 for k, v in batch.items()}
        local = batch['images'].shape[0]
        data_parallel = mesh.is_distributed()
        if data_parallel and rng.gt_bboxes is None:
            offset, total = mesh.batch_offset(local)
            rng = rng._replace(offset=offset, total=total)
        with record_function('train.forward'):
            images = batch['images']
            if device_norm is not None:
                images = normalize_images(images, device_norm)
            images = images.float().permute(0, 3, 1, 2)
            with torch.autocast(device.type, dtype=torch.bfloat16,
                                enabled=dtype == torch.bfloat16), \
                    (contextlib.nullcontext() if norm_eval
                     else live_batch_norm(
                         detector,
                         mesh.all_reduce_sum if data_parallel else None)):
                outputs = detector(images, batch=batch, train=True,
                                   rng=rng)
        with record_function('train.loss'):
            if data_parallel:
                outputs = mesh.gather_batch(outputs, local)
                batch = mesh.gather_batch(
                    {k: v for k, v in batch.items() if k != 'images'},
                    local)
            losses = detector.loss_from_outputs(outputs, batch)
            total = sum(losses.values())
        with record_function('train.backward'):
            state.optimizer.zero_grad(set_to_none=True)
            total.backward()
        with record_function('train.update'):
            grad_norm = tx.update(
                state, mesh.all_reduce_grads if data_parallel else None)
        state.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics.update(loss=total.detach(), grad_norm=grad_norm)
        return state, metrics

    return train_step
