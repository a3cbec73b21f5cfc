"""Process groups and the collectives of data parallelism (counterpart of
``orientedobjectdetection_tpu/parallel/mesh.py``).

The JAX package runs one SPMD program over a named device mesh: the batch
axis is sharded, the parameters replicated, and XLA inserts the reductions.
The port runs one process per card instead (``torch.distributed``, launched
by ``python -m torch.distributed.run``), and this module is the only one
that calls ``torch.distributed``:

- :func:`init_distributed` joins the process group that the launcher's
  environment describes (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
  ``MASTER_ADDR`` / ``MASTER_PORT``);
- :func:`rank`, :func:`world_size`, :func:`local_rank`;
- :func:`shard_batch` cuts a host batch to this rank's rows;
- :func:`gather_batch` gathers the per-image tensors of every rank along
  the batch axis (and refuses a tensor that is not per image), with a
  backward that hands each rank its own rows of the gradient (every rank
  computes the same loss on the gathered batch, so that gradient is the
  same on every rank);
- :func:`all_reduce_sum` sums across ranks with autograd (the backward sums
  the gradients), for statistics that each rank's forward only partly
  sees (live BatchNorm);
- :func:`all_reduce_grads` sums gradients in place in flat buckets;
  :func:`broadcast_module` copies rank 0's parameters and buffers;
  :func:`barrier`.

Outside a process group every function is the identity, and a single
process joins none; a group of one rank (asked for by name) runs the
collectives as any other.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import List, Optional, Sequence, Union

import torch
import torch.distributed as dist
from torch import nn

# the size of one bucket of all_reduce_grads, in elements
BUCKET_ELEMENTS = 1 << 23


def init_distributed(device: Union[str, torch.device, None] = None,
                     backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     timeout_s: float = 600.0) -> bool:
    """Join the process group when there is more than one process (or when
    the caller names ``world_size``, 1 included), and return whether a
    group is joined.

    ``rank`` and ``world_size`` default to the launcher's ``RANK`` and
    ``WORLD_SIZE``, ``init_method`` to ``env://`` (``MASTER_ADDR`` and
    ``MASTER_PORT``). The backend is NCCL for a CUDA ``device`` (the
    default) and gloo only where the caller asks for ``device='cpu'`` or
    names ``backend='gloo'``; it is never switched on its own. A second
    call, once the group exists, returns True and changes nothing. A CUDA
    rank uses the card ``LOCAL_RANK`` (``cuda:<LOCAL_RANK>`` becomes its
    current device)."""
    if is_distributed():
        return True
    world = int(world_size if world_size is not None
                else os.environ.get('WORLD_SIZE', '1'))
    if world <= 1 and world_size is None:
        return False
    if not dist.is_available():
        raise RuntimeError('init_distributed: this PyTorch has no '
                           'torch.distributed')
    me = int(rank if rank is not None else os.environ['RANK'])
    device = torch.device(device if device is not None else 'cuda')
    if backend is None:
        backend = 'nccl' if device.type == 'cuda' else 'gloo'
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError('init_distributed: no CUDA device is '
                               'available; pass device="cpu" to run on '
                               'the CPU')
        if device.index is None:
            torch.cuda.set_device(local_rank())
        else:
            torch.cuda.set_device(device)
    dist.init_process_group(backend=backend,
                            init_method=init_method or 'env://',
                            rank=me, world_size=world,
                            timeout=timedelta(seconds=timeout_s))
    return True


def is_distributed() -> bool:
    """Whether a process group is joined (of one rank or more)."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def local_rank() -> int:
    return int(os.environ.get('LOCAL_RANK', '0'))


def rank_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` for this rank: a bare ``'cuda'`` is the rank's card
    ``cuda:<LOCAL_RANK>``; anything else is returned as it is."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        return torch.device('cuda', local_rank())
    return device


def destroy() -> None:
    """Leave the process group, if one was joined."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def shard_batch(batch: dict) -> dict:
    """This rank's rows of a global host batch: the ``world_size`` equal
    contiguous blocks of the leading axis, block ``rank`` (the JAX
    package's batch sharding over its mesh). Lists (``img_metas``) are cut
    in the same way."""
    r, w = rank(), world_size()
    out = {}
    for k, v in batch.items():
        n = len(v)
        if n % w:
            raise ValueError(f'shard_batch: {k} has {n} rows, not a '
                             f'multiple of {w} ranks')
        per = n // w
        out[k] = v[r * per:(r + 1) * per]
    return out


def batch_offset(local_batch: int):
    """``(offset, total)``: this rank's first image in the global batch and
    the global batch size, when every rank holds ``local_batch`` images."""
    return rank() * local_batch, local_batch * world_size()


class _GatherRows(torch.autograd.Function):
    """All-gather along dim 0; the backward returns this rank's rows of the
    gradient, which every rank computed whole and alike."""

    @staticmethod
    def forward(ctx, tensor):
        ctx.rows = tensor.shape[0]
        parts = [torch.empty_like(tensor) for _ in range(world_size())]
        dist.all_gather(parts, tensor.contiguous())
        return torch.cat(parts, 0)

    @staticmethod
    def backward(ctx, grad):
        start = rank() * ctx.rows
        return grad[start:start + ctx.rows]


def gather_rows(tensor: torch.Tensor) -> torch.Tensor:
    """Every rank's ``tensor`` concatenated along dim 0 in rank order. A
    tensor that requires grad gets the backward of :class:`_GatherRows`
    (this rank's rows of a gradient that every rank computes whole)."""
    if not is_distributed():
        return tensor
    if tensor.requires_grad:
        return _GatherRows.apply(tensor)
    flag = tensor.dtype == torch.bool         # gloo gathers no bool
    part = tensor.to(torch.uint8) if flag else tensor.contiguous()
    parts = [torch.empty_like(part) for _ in range(world_size())]
    dist.all_gather(parts, part)
    out = torch.cat(parts, 0)
    return out.bool() if flag else out


def gather_batch(tree, local_batch: int):
    """Nested dicts, lists and tuples with every tensor gathered across
    ranks along the batch axis by :func:`gather_rows`.

    Every tensor of a detector's training outputs (and of the batch's
    targets) is per image, its leading axis ``local_batch``: a tensor of
    one or more dimensions with another leading axis (a per-image output
    flattened to ``B * N``, or a tensor shared by the images) is refused
    with a ValueError rather than passed on as if it were the global
    batch's. A 0-d tensor becomes None, because a batch statistic of one
    rank (a clamped count) is not the global batch's: a loss reads such a
    statistic from the gathered per-image tensors. Other leaves (None,
    numbers, strings) pass through."""
    def gather(node, path):
        if isinstance(node, dict):
            return {k: gather(v, f'{path}[{k!r}]') for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(gather(v, f'{path}[{i}]')
                              for i, v in enumerate(node))
        if not torch.is_tensor(node):
            return node
        if node.dim() == 0:
            return None
        if node.shape[0] != local_batch:
            raise ValueError(f'gather_batch: {path or "the tree"} has shape '
                             f'{tuple(node.shape)}, not a leading axis of '
                             f'the {local_batch} images of this rank')
        return gather_rows(node)
    return gather(tree, '')


class _SumRanks(torch.autograd.Function):
    """``all_reduce`` (sum) whose backward sums the ranks' gradients (what
    ``torch.distributed.nn.functional.all_reduce`` does, without its
    deprecation)."""

    @staticmethod
    def forward(ctx, tensor):
        out = tensor.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, op=dist.ReduceOp.SUM)
        return grad


def all_reduce_sum(tensor: torch.Tensor) -> torch.Tensor:
    """The sum of ``tensor`` over ranks, differentiable: the backward sums
    the ranks' gradients, since each rank's loss reaches the sum through
    its own part of the network. The identity outside a process group."""
    if not is_distributed():
        return tensor
    return _SumRanks.apply(tensor)


@torch.no_grad()
def all_reduce_grads(grads: Sequence[torch.Tensor]) -> None:
    """Sum ``grads`` over ranks in place: tensors of one dtype packed into
    flat buckets of at most BUCKET_ELEMENTS elements (a larger tensor goes
    alone), one ``all_reduce`` a bucket. Every rank must pass the same
    tensors in the same order."""
    if not is_distributed():
        return
    groups: List[List[torch.Tensor]] = []
    size = 0
    for g in grads:
        if not groups or groups[-1][0].dtype != g.dtype or \
                size + g.numel() > BUCKET_ELEMENTS:
            groups.append([])
            size = 0
        groups[-1].append(g)
        size += g.numel()
    for group in groups:
        flat = torch.cat([g.reshape(-1) for g in group])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        offset = 0
        for g in group:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


@torch.no_grad()
def broadcast_module(module: nn.Module, src: int = 0) -> None:
    """Rank ``src``'s parameters and buffers on every rank."""
    if not is_distributed():
        return
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src)


@torch.no_grad()
def broadcast_optimizer(optimizer: torch.optim.Optimizer,
                        src: int = 0) -> None:
    """Rank ``src``'s optimizer state tensors on the parameters' device
    (momentum, Adam's moments) on every rank; every rank must hold the
    same state keys."""
    if not is_distributed():
        return
    for group in optimizer.param_groups:
        for p in group['params']:
            for v in optimizer.state.get(p, {}).values():
                if torch.is_tensor(v) and v.device == p.device:
                    dist.broadcast(v, src)


def barrier() -> None:
    if is_distributed():
        dist.barrier()
