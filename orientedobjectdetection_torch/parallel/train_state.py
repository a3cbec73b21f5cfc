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

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Union

import torch
from torch import nn
from torch.profiler import record_function


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
    ``ResNet._freeze_stages``; ``frozen_stages=1`` in every R50 config)."""
    frozen = []
    if frozen_stages >= 0:
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
    def update(self, state: TrainState) -> torch.Tensor:
        """One update from the gradients that ``backward`` left on the
        trainable parameters. Returns their global norm before the clip, a
        0-d tensor on the device. optax's clip: scale by
        ``max_norm / norm`` where ``norm >= max_norm`` (no epsilon)."""
        optimizer = state.optimizer
        grads: List[torch.Tensor] = [
            p.grad for group in optimizer.param_groups
            for p in group['params'] if p.grad is not None]
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
    float32 master weights, and a fresh optimizer at step 0.

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
    return TrainState(step=0, model=detector, optimizer=tx.init(detector))


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
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch`` is the padded batch of ``models/detectors/single_stage.py``;
    its tensors may lie on the host (pinned memory makes the copies
    asynchronous). ``device_norm``: the ``img_norm_cfg`` dict when the batch
    carries raw uint8 images, normalized here on the device.
    ``dtype=torch.bfloat16`` runs the network under ``torch.autocast`` on
    float32 master weights; targets and losses stay float32.
    ``loss_weights`` is accepted and unused, as in the JAX package.
    ``norm_eval=False`` (live BatchNorm) is not ported.

    ``metrics``: ``loss_cls``, ``loss_bbox``, ``loss`` and ``grad_norm`` as
    0-d tensors on the device; nothing in the step waits for them.
    ``grad_norm`` is the global norm of the trainable parameters' gradients
    before the clip. The step's four parts carry ``torch.profiler`` ranges
    (``train.forward``, ``train.loss``, ``train.backward``,
    ``train.update``)."""
    if not norm_eval:
        raise NotImplementedError('norm_eval=False (live BatchNorm) is not '
                                  'ported')
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'dtype must be float32 or bfloat16, got {dtype}')

    def train_step(state: TrainState, batch: dict):
        if state.model is not detector:
            raise ValueError('the state was created for another detector')
        device = next(detector.parameters()).device
        batch = {k: v.to(device, non_blocking=True)
                 for k, v in batch.items()}
        with record_function('train.forward'):
            images = batch['images']
            if device_norm is not None:
                images = normalize_images(images, device_norm)
            images = images.float().permute(0, 3, 1, 2)
            with torch.autocast(device.type, dtype=torch.bfloat16,
                                enabled=dtype == torch.bfloat16):
                outputs = detector(images)
        with record_function('train.loss'):
            losses = detector.loss_from_outputs(outputs, batch)
            total = sum(losses.values())
        with record_function('train.backward'):
            state.optimizer.zero_grad(set_to_none=True)
            total.backward()
        with record_function('train.update'):
            grad_norm = tx.update(state)
        state.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics.update(loss=total.detach(), grad_norm=grad_norm)
        return state, metrics

    return train_step
