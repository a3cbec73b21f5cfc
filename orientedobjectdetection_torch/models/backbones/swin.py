"""Swin Transformer backbone (counterpart of
``orientedobjectdetection_tpu/models/backbones/swin.py``; the reference
takes mmdet's SwinTransformer through the registry alias).

Module and parameter names are mmdet's: ``patch_embed.projection`` and
``patch_embed.norm``; ``stages.{i}.blocks.{j}`` with ``norm1``,
``attn.w_msa.{qkv, proj, relative_position_bias_table}``, ``norm2`` and
``ffn.layers.0.0`` / ``ffn.layers.1``; ``stages.{i}.downsample.{norm,
reduction}``, the patch merging at the end of stage i (the JAX package's
merge at the start of stage i + 1); ``norm{i}``, the out-norms.

The maps stay channels-last ``(B, H, W, C)`` inside the backbone and each
output is permuted to NCHW once. A block: LayerNorm, zero padding to a
multiple of the window, the cyclic shift (``torch.roll``) with the additive
mask of -1e9 across the shifted regions, attention in each window with the
relative position bias, the reverse, the residual; then LayerNorm, Linear
4C, GELU, Linear C and the residual. Attention is plain ``matmul`` and
``softmax``, as the JAX package's is ``einsum`` outside any Pallas kernel.

The window shrinks with the feature map: ``ws = min(window_size, H, W)``,
and the shift stays only while ``0 < shift < ws`` (a 4x4 map keeps the
shift of 3). The JAX package then builds a bias table of ``(2 ws - 1)^2``
rows; the port keeps the ``(2 window_size - 1)^2`` rows the module was
built with and reads its central block (offsets shifted by
``window_size - 1``), where ``utils/jax_weights.py`` carries a smaller JAX
table.

Patch merging unfolds 2x2 channel-major as mmdet does (index
``c * 4 + tap``), so that an mmdet ``reduction.weight`` loads as it is; the
carry permutes the JAX package's tap-major tensors.

The flax defaults hold (``models/blocks.py``): LayerNorm epsilon 1e-6, the
tanh GELU, ``'SAME'`` padding of the patch embedding. ``drop_path_rate``,
``drop_rate``, ``attn_drop_rate``, ``with_cp``, ``frozen_stages``,
``convert_weights``, ``pretrain_img_size`` and ``init_cfg`` are accepted
and not used, as in the JAX package (the optimizer's stage freezing
matches none of Swin's names there either).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core.anchors import cached
from ...utils.registry import BACKBONES
from ..blocks import LayerNorm, SameConv2d, gelu

ARCHS = {
    'tiny': dict(embed_dims=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24)),
    'small': dict(embed_dims=96, depths=(2, 2, 18, 2),
                  num_heads=(3, 6, 12, 24)),
    'base': dict(embed_dims=128, depths=(2, 2, 18, 2),
                 num_heads=(4, 8, 16, 32)),
}


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nW, ws * ws, C), windows row-major."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.transpose(2, 3).reshape(-1, ws * ws, c)


def window_reverse(wins: torch.Tensor, ws: int, h: int, w: int):
    """The inverse of :func:`window_partition`."""
    b = wins.shape[0] // ((h // ws) * (w // ws))
    x = wins.reshape(b, h // ws, w // ws, ws, ws, -1)
    return x.transpose(2, 3).reshape(b, h, w, -1)


def _rel_pos_index(ws: int, table_ws: int = None) -> np.ndarray:
    """(ws^2, ws^2) rows of a ``(2 table_ws - 1)^2`` bias table: the
    offsets of the window's token pairs, each shifted by ``table_ws - 1``
    (JAX ``_rel_pos_index`` where ``table_ws == ws``)."""
    table_ws = ws if table_ws is None else table_ws
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing='ij')).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]          # (2, N, N)
    rel = rel.transpose(1, 2, 0) + (table_ws - 1)
    return rel[..., 0] * (2 * table_ws - 1) + rel[..., 1]  # (N, N)


def _shift_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """(nW, ws^2, ws^2) additive mask of a shifted window layout of the
    padded ``h`` x ``w`` map: -1e9 between tokens of other regions (JAX
    ``_shift_mask``; mmdet uses -100)."""
    img = np.zeros((h, w), np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    wins = img.reshape(h // ws, ws, w // ws, ws).transpose(
        0, 2, 1, 3).reshape(-1, ws * ws)
    return ((wins[:, :, None] != wins[:, None, :]) * -1e9).astype(np.float32)


class WindowMSA(nn.Module):
    """Multi-head self-attention inside each window, with a relative
    position bias table of ``(2 window_size - 1)^2`` rows (mmdet's
    ``WindowMSA``); a smaller window reads its central block."""

    def __init__(self, dim: int, num_heads: int, window_size: int):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        # zero until trained or loaded (seeded weights leave it so)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self._cache = {}

    def bias(self, ws: int, device) -> torch.Tensor:
        index = cached(self._cache, (ws, str(device)),
                       lambda: torch.from_numpy(_rel_pos_index(
                           ws, self.window_size)).to(device))
        return self.relative_position_bias_table[index].permute(2, 0, 1)

    def forward(self, x, ws: int, mask: Optional[torch.Tensor] = None):
        """x (B * nW, ws^2, C); mask (nW, ws^2, ws^2) or None."""
        bw, n, c = x.shape
        qkv = self.qkv(x).reshape(bw, n, 3, self.num_heads, -1)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)     # (bw, H, N, d)
        attn = (q @ k.transpose(-2, -1)) / math.sqrt(q.shape[-1])
        attn = attn + self.bias(ws, x.device)[None].to(attn.dtype)
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(bw // nw, nw, self.num_heads, n, n)
                    + mask[None, :, None].to(attn.dtype)
                    ).reshape(bw, self.num_heads, n, n)
        out = torch.softmax(attn, -1) @ v
        return self.proj(out.transpose(1, 2).reshape(bw, n, c))


class ShiftWindowMSA(nn.Module):
    """Holds ``w_msa`` (mmdet's names); :class:`SwinBlock` shifts."""

    def __init__(self, dim: int, num_heads: int, window_size: int):
        super().__init__()
        self.w_msa = WindowMSA(dim, num_heads, window_size)


class FFN(nn.Module):
    """mmcv's FFN names: ``layers.0.0`` the first Linear, ``layers.1`` the
    second."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.layers = nn.Sequential(nn.Sequential(nn.Linear(dim, hidden)),
                                    nn.Linear(hidden, dim))

    def forward(self, x):
        return self.layers[1](gelu(self.layers[0](x)))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 shift: int = 0):
        super().__init__()
        self.window_size = window_size
        self.shift = shift
        self.norm1 = LayerNorm(dim)
        self.attn = ShiftWindowMSA(dim, num_heads, window_size)
        self.norm2 = LayerNorm(dim)
        self.ffn = FFN(dim, 4 * dim)
        self._cache = {}

    def forward(self, x):
        """x (B, H, W, C) -> (B, H, W, C)."""
        b, h, w, c = x.shape
        ws = min(self.window_size, h, w)
        shift = self.shift if 0 < self.shift < ws else 0
        y = self.norm1(x)
        ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
        if ph or pw:
            y = F.pad(y, (0, 0, 0, pw, 0, ph))
        hp, wp = h + ph, w + pw
        mask = None
        if shift:
            y = torch.roll(y, (-shift, -shift), (1, 2))
            mask = cached(self._cache, (hp, wp, ws, shift, str(x.device)),
                          lambda: torch.from_numpy(
                              _shift_mask(hp, wp, ws, shift)).to(x.device))
        y = self.attn.w_msa(window_partition(y, ws), ws, mask)
        y = window_reverse(y, ws, hp, wp)
        if shift:
            y = torch.roll(y, (shift, shift), (1, 2))
        if ph or pw:
            y = y[:, :h, :w]
        x = x + y
        return x + self.ffn(self.norm2(x))


class PatchMerging(nn.Module):
    """2x2 space-to-depth (zero padding of an odd side at the bottom or
    right), channel-major as mmdet's ``nn.Unfold``: LayerNorm over 4C, then
    a Linear to ``out_dim`` without bias."""

    def __init__(self, dim: int, out_dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, out_dim, bias=False)

    def forward(self, x):
        b, h, w, c = x.shape
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
            h, w = h + h % 2, w + w % 2
        # (b, h/2, kh, w/2, kw, c) -> (b, h/2, w/2, c, kh, kw)
        x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4)
        return self.reduction(self.norm(x.reshape(b, h // 2, w // 2, 4 * c)))


class SwinStage(nn.Module):
    def __init__(self, dim: int, depth: int, num_heads: int,
                 window_size: int, downsample_dim: Optional[int]):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, window_size,
                      0 if j % 2 == 0 else window_size // 2)
            for j in range(depth))
        self.downsample = PatchMerging(dim, downsample_dim) \
            if downsample_dim else None


class PatchEmbed(nn.Module):
    def __init__(self, in_channels: int, dim: int):
        super().__init__()
        self.projection = SameConv2d(in_channels, dim, 4, 4)
        self.norm = LayerNorm(dim)

    def forward(self, x):
        return self.norm(self.projection(x).permute(0, 2, 3, 1))


@BACKBONES.register_module()
class SwinTransformer(nn.Module):
    """Input NCHW; returns the ``out_indices`` stages' normed outputs, NCHW
    (contiguous). ``arch`` names a spec that ``embed_dims``, ``depths`` and
    ``num_heads`` override, as mmdet configs give them. As in the JAX
    package, the MLP is 4x wide, qkv has a bias and the patch embedding is
    normed whatever ``mlp_ratio``, ``qkv_bias`` and ``patch_norm`` say
    (every config gives 4, True and True)."""

    def __init__(self, arch: str = 'tiny', window_size: int = 7,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 frozen_stages: int = -1, drop_path_rate: float = 0.0,
                 convert_weights: bool = False,
                 embed_dims: Optional[int] = None,
                 depths: Optional[Sequence[int]] = None,
                 num_heads: Optional[Sequence[int]] = None,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 patch_norm: bool = True, with_cp: bool = False,
                 pretrain_img_size: int = 224,
                 init_cfg: Optional[dict] = None, in_channels: int = 3):
        super().__init__()
        spec = dict(ARCHS[arch])
        if embed_dims is not None:
            spec['embed_dims'] = embed_dims
        if depths is not None:
            spec['depths'] = tuple(depths)
        if num_heads is not None:
            spec['num_heads'] = tuple(num_heads)
        dims = [spec['embed_dims'] * 2 ** i
                for i in range(len(spec['depths']))]
        self.frozen_stages = frozen_stages
        self.out_indices = tuple(out_indices)
        self.patch_embed = PatchEmbed(in_channels, dims[0])
        self.stages = nn.ModuleList(
            SwinStage(dims[i], depth, heads, window_size,
                      dims[i + 1] if i + 1 < len(dims) else None)
            for i, (depth, heads) in enumerate(zip(spec['depths'],
                                                   spec['num_heads'])))
        for i in self.out_indices:
            self.add_module(f'norm{i}', LayerNorm(dims[i]))

    def forward(self, x):
        x = self.patch_embed(x)
        outs = []
        for i, stage in enumerate(self.stages):
            for block in stage.blocks:
                x = block(x)
            if i in self.out_indices:
                outs.append(getattr(self, f'norm{i}')(x).permute(
                    0, 3, 1, 2).contiguous())
            if stage.downsample is not None:
                x = stage.downsample(x)
        return tuple(outs)


@BACKBONES.register_module()
class Swin(SwinTransformer):
    """The mmdet registry alias."""
