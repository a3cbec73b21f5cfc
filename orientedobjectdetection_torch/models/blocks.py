"""Shared building blocks (counterpart of
``orientedobjectdetection_tpu/models/blocks.py``), and the flax defaults
that the transformer and ConvNeXt backbones take from the JAX package:
LayerNorm with epsilon 1e-6, computed in float32; the tanh approximation of
GELU; and ``'SAME'`` padding of a strided convolution.

Two convolution modules live here. :class:`ConvModule` is mmcv's without a
norm (a conv and an optional ReLU), which the FPN and the refine heads use.
:class:`YOLOConvModule` is the JAX package's YOLO ``ConvModule``: a conv
without bias, BatchNorm, then SiLU (or its depthwise form), the unit of the
YOLO block set below (``DarknetBottleneck``, ``CSPNeXtBlock``,
``ChannelAttention``, ``CSPLayer``, ``SPPFBottleneck``,
``CSPLayerWithTwoConv``). The YOLO modules keep the JAX package's module
names (``conv`` / ``bn``, ``main_conv``, ``block_0``...), so a flax tree
maps onto them name for name. Unlike flax, a PyTorch module is built with
its input width: each takes ``cin`` first.

Every BatchNorm of the port is :class:`FrozenBatchNorm`, here because its
mode is the detector's: :func:`live_batch_norm` puts all of a model's
BatchNorms in live mode for a train step's forward
(``make_train_step(norm_eval=False)``). ``backbones/resnet.py`` re-exports
both names.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn


class ConvModule(nn.Module):
    """mmcv's ConvModule without a norm: holds ``conv`` (so checkpoints
    name it ``<parent>.conv.weight``), optionally followed by ReLU."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int = 0, relu: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride=stride, padding=padding)
        self.relu = relu

    def forward(self, x):
        x = self.conv(x)
        return F.relu(x) if self.relu else x


class LayerNorm(nn.LayerNorm):
    """flax's ``nn.LayerNorm`` over the last axis: epsilon 1e-6 (torch's
    default is 1e-5), statistics and affine in float32, the result in the
    input's dtype."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-6)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


class LayerNorm2d(LayerNorm):
    """:class:`LayerNorm` over the channels of an NCHW map (mmcls's
    ``LayerNorm2d``); returns NCHW in the input's memory format."""

    def forward(self, x):
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def gelu(x):
    """flax's ``nn.gelu``: the tanh approximation (0.841192 at 1, where
    the exact GELU gives 0.841345)."""
    return F.gelu(x, approximate='tanh')


def same_padding(size: int, kernel: int, stride: int) -> tuple:
    """XLA's ``'SAME'`` padding of one axis: ``ceil(size / stride)``
    outputs, the extra row split with the larger half after."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """A convolution with flax's default ``'SAME'`` padding: a 4x4 stride-4
    patch embedding or a 2x2 stride-2 downsample of a side that the stride
    does not divide pads it with zeros (before the conv, as XLA does)."""

    def forward(self, x):
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        top, bottom = same_padding(x.shape[-2], kh, sh)
        left, right = same_padding(x.shape[-1], kw, sw)
        if top or bottom or left or right:
            x = F.pad(x, (left, right, top, bottom))
        return super().forward(x)


class FrozenBatchNorm(nn.Module):
    """BatchNorm, frozen by default: a per-channel affine computed in
    float32 and applied in the input's dtype (the reference's
    ``norm_eval=True`` BN). ``weight`` and ``bias`` are parameters and train
    outside the frozen stages, as the JAX package's ``scale`` / ``bias``
    do. ``num_batches_tracked`` in a checkpoint is accepted and ignored.

    ``live = True`` (set by ``make_train_step(norm_eval=False)`` for the
    forward of a step, :func:`live_batch_norm`) is the JAX package's
    mutable ``batch_stats`` mode: the layer normalizes with the batch's
    float32 mean and biased variance over (N, H, W), the gradient flowing
    through both, and updates its running statistics as ``(1 - momentum) *
    old + momentum * batch`` with that same biased variance (not
    ``F.batch_norm``'s unbiased one). A layer in a frozen stage updates
    its statistics too; its parameters stay fixed.

    ``reduce`` (set with ``live``, :func:`live_batch_norm`): a
    differentiable sum across the ranks of a data-parallel step
    (``parallel/mesh.py:all_reduce_sum``). The mean and biased variance are
    then those of the global batch, as under the JAX package's sharded
    program: each rank's count and mean are summed into the global mean,
    then each rank's ``count * (var + (mean - global mean)^2)`` into the
    global variance, both in float32 and carrying the gradient. What
    ``torch.nn.SyncBatchNorm`` would give instead is the unbiased variance
    in the running statistics."""

    momentum = 0.1
    reduce = None

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.live = False
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer('running_mean', torch.zeros(num_features))
        self.register_buffer('running_var', torch.ones(num_features))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + 'num_batches_tracked', None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean, var = self.running_mean, self.running_var
        if self.live:
            xf = x.float()
            mean = xf.mean((0, 2, 3))
            var = xf.var((0, 2, 3), unbiased=False)
            if self.reduce is not None:
                mean, var = self._global_stats(xf, mean, var)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(m * mean.detach())
                self.running_var.mul_(1 - m).add_(m * var.detach())
        scale = self.weight / torch.sqrt(var + self.eps)
        bias = self.bias - mean * scale
        return (x * scale.to(x.dtype)[:, None, None]
                + bias.to(x.dtype)[:, None, None])

    def _global_stats(self, xf, mean, var):
        """The global batch's mean and biased variance from this rank's."""
        count = xf.new_full((1,), float(xf.numel() // xf.shape[1]))
        sums = self.reduce(torch.cat([count * mean, count]))
        total = sums[-1]
        g_mean = sums[:-1] / total
        g_var = self.reduce(count * (var + (mean - g_mean) ** 2)) / total
        return g_mean, g_var


@contextlib.contextmanager
def live_batch_norm(model: nn.Module, reduce=None):
    """Every :class:`FrozenBatchNorm` of ``model`` in live mode (batch
    statistics, running-statistics update) while the context is open;
    ``reduce``, a differentiable sum across ranks, makes the statistics
    those of the global batch (:attr:`FrozenBatchNorm.reduce`)."""
    norms = [m for m in model.modules() if isinstance(m, FrozenBatchNorm)]
    for m in norms:
        m.live = True
        m.reduce = reduce
    try:
        yield
    finally:
        for m in norms:
            m.live = False
            m.reduce = None


# ---- the YOLO block set -----------------------------------------------------
class YOLOConvModule(nn.Module):
    """conv (no bias) -> BatchNorm -> SiLU, the JAX package's YOLO
    ``ConvModule``. Its BatchNorm is always :class:`FrozenBatchNorm` with
    epsilon 1e-5 and momentum 0.1, and its activation SiLU: the configs'
    ``norm_cfg`` (eps 1e-3, momentum 0.03) and ``act_cfg`` are not read, as
    in the JAX package. ``use_depthwise``: a depthwise ``kernel_size``
    conv (``dw``, ``dw_bn``) then a pointwise one (``pw``, ``pw_bn``), each
    with its norm and SiLU."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 1,
                 stride: int = 1, use_depthwise: bool = False):
        super().__init__()
        k, pad = kernel_size, kernel_size // 2
        self.use_depthwise = use_depthwise
        if use_depthwise:
            self.dw = nn.Conv2d(cin, cin, k, stride, pad, groups=cin,
                                bias=False)
            self.dw_bn = FrozenBatchNorm(cin)
            self.pw = nn.Conv2d(cin, cout, 1, bias=False)
            self.pw_bn = FrozenBatchNorm(cout)
        else:
            self.conv = nn.Conv2d(cin, cout, k, stride, pad, bias=False)
            self.bn = FrozenBatchNorm(cout)

    def forward(self, x):
        if self.use_depthwise:
            x = F.silu(self.dw_bn(self.dw(x)))
            return F.silu(self.pw_bn(self.pw(x)))
        return F.silu(self.bn(self.conv(x)))


class DarknetBottleneck(nn.Module):
    """``kernel_size[0]`` conv to ``int(cout * expansion)`` channels, then
    ``kernel_size[1]`` conv to ``cout``, plus the input when
    ``add_identity`` and ``cin == cout``."""

    def __init__(self, cin: int, cout: int, expansion: float = 0.5,
                 add_identity: bool = True, kernel_size=(1, 3)):
        super().__init__()
        hidden = int(cout * expansion)
        self.conv1 = YOLOConvModule(cin, hidden, kernel_size[0])
        self.conv2 = YOLOConvModule(hidden, cout, kernel_size[1])
        self.identity = add_identity and cin == cout

    def forward(self, x):
        out = self.conv2(self.conv1(x))
        return out + x if self.identity else out


class CSPNeXtBlock(nn.Module):
    """3x3 conv to ``int(cout * expansion)``, then a depthwise
    ``kernel_size`` conv module to ``cout``, plus the input when
    ``add_identity`` and ``cin == cout``."""

    def __init__(self, cin: int, cout: int, expansion: float = 0.5,
                 add_identity: bool = True, kernel_size: int = 5):
        super().__init__()
        hidden = int(cout * expansion)
        self.conv1 = YOLOConvModule(cin, hidden, 3)
        self.conv2 = YOLOConvModule(hidden, cout, kernel_size,
                                    use_depthwise=True)
        self.identity = add_identity and cin == cout

    def forward(self, x):
        out = self.conv2(self.conv1(x))
        return out + x if self.identity else out


class ChannelAttention(nn.Module):
    """Global average pool -> 1x1 conv (with bias) -> hardsigmoid
    (``clip(x / 6 + 0.5, 0, 1)``) -> gate on the input."""

    def __init__(self, channels: int):
        super().__init__()
        self.fc = nn.Conv2d(channels, channels, 1)

    def forward(self, x):
        g = self.fc(x.mean((2, 3), keepdim=True))
        return x * F.hardsigmoid(g)


class CSPLayer(nn.Module):
    """Cross Stage Partial layer: ``main_conv`` -> ``num_blocks`` blocks
    (``CSPNeXtBlock`` or ``DarknetBottleneck``), concatenated with
    ``short_conv``, optional :class:`ChannelAttention`, ``final_conv``."""

    def __init__(self, cin: int, cout: int, expand_ratio: float = 0.5,
                 num_blocks: int = 1, add_identity: bool = True,
                 use_cspnext_block: bool = False,
                 channel_attention: bool = False):
        super().__init__()
        mid = int(cout * expand_ratio)
        block = CSPNeXtBlock if use_cspnext_block else DarknetBottleneck
        self.main_conv = YOLOConvModule(cin, mid, 1)
        self.short_conv = YOLOConvModule(cin, mid, 1)
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f'block_{i}', block(mid, mid,
                                                add_identity=add_identity))
        self.attn = ChannelAttention(2 * mid) if channel_attention else None
        self.final_conv = YOLOConvModule(2 * mid, cout, 1)

    def forward(self, x):
        main = self.main_conv(x)
        for i in range(self.num_blocks):
            main = getattr(self, f'block_{i}')(main)
        out = torch.cat([main, self.short_conv(x)], 1)
        if self.attn is not None:
            out = self.attn(out)
        return self.final_conv(out)


class SPPFBottleneck(nn.Module):
    """SPPF: 1x1 conv to ``cin // 2``, three chained stride-1
    ``kernel_size`` max pools, the four maps concatenated, 1x1 conv to
    ``cout``. The pools pad with -inf, as flax's ``max_pool`` does."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 5):
        super().__init__()
        mid = cin // 2
        self.kernel_size = kernel_size
        self.conv1 = YOLOConvModule(cin, mid, 1)
        self.conv2 = YOLOConvModule(4 * mid, cout, 1)

    def forward(self, x):
        k = self.kernel_size
        x = self.conv1(x)
        p1 = F.max_pool2d(x, k, 1, k // 2)
        p2 = F.max_pool2d(p1, k, 1, k // 2)
        p3 = F.max_pool2d(p2, k, 1, k // 2)
        return self.conv2(torch.cat([x, p1, p2, p3], 1))


class CSPLayerWithTwoConv(nn.Module):
    """YOLOv8's C2f: ``main_conv`` to ``2 * mid`` channels split in two
    halves, ``num_blocks`` 3x3-3x3 bottlenecks chained on the second half,
    every map concatenated, ``final_conv`` to ``cout``."""

    def __init__(self, cin: int, cout: int, expand_ratio: float = 0.5,
                 num_blocks: int = 1, add_identity: bool = True):
        super().__init__()
        mid = int(cout * expand_ratio)
        self.main_conv = YOLOConvModule(cin, 2 * mid, 1)
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f'block_{i}', DarknetBottleneck(
                mid, mid, expansion=1.0, add_identity=add_identity,
                kernel_size=(3, 3)))
        self.final_conv = YOLOConvModule((2 + num_blocks) * mid, cout, 1)

    def forward(self, x):
        outs = list(self.main_conv(x).chunk(2, 1))
        cur = outs[-1]
        for i in range(self.num_blocks):
            cur = getattr(self, f'block_{i}')(cur)
            outs.append(cur)
        return self.final_conv(torch.cat(outs, 1))


def make_divisible(x: float, widen_factor: float = 1.0,
                   divisor: int = 8) -> int:
    """mmyolo's ``make_divisible``: scale, then round to the divisor."""
    v = x * widen_factor
    return max(divisor, int(v + divisor / 2) // divisor * divisor) \
        if v > 1 else int(max(round(v), 1))


def make_round(x: float, deepen_factor: float = 1.0) -> int:
    return max(round(x * deepen_factor), 1) if x > 1 else int(x)
