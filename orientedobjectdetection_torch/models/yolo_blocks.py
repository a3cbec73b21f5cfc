"""The YOLO-family block library (counterpart of
``orientedobjectdetection_tpu/models/yolo_blocks.py``; reference
``models/blocks/yolo_blocks.py``): RepVGG re-parameterizable convolutions,
the CSP and SPP variants, the channel and spatial gates (CBAM, ESE), the
large-kernel blocks (LSK, LSKA), the two-input and multi-level fusions (AFF,
ASFF, BiFusion), PSA attention, the text-guided blocks of YOLO-World
(MaxSigmoid, image pooling) and the deformable fusions.

Maps are NCHW. flax infers each input's width, PyTorch cannot: every class
takes the width(s) of its input(s) first, as ``in_channels`` (an int, or a
sequence for a block of several inputs), and decides from them at
construction the branches that the JAX package decides from
``x.shape[-1]`` (:class:`RepVGGBlock`'s identity, :class:`BottleRep`'s
residual, :class:`MaxSigmoidAttnBlock`'s ``embed_conv``), so that the state
dict has the keys of the flax tree. Module and parameter names are the JAX
package's (``rbr_dense``, ``id_scale``, ``compress_{i}``, ``Dense_0``...),
so ``utils/jax_weights.py:mirror_from_jax`` carries a flax tree name for
name.

flax's defaults hold: GELU is the tanh approximation
(:func:`..blocks.gelu`), LayerNorm has epsilon 1e-6 (:class:`..blocks.
LayerNorm`, :class:`..blocks.LayerNorm2d` on maps), max pools pad with
-inf, ``nn.avg_pool`` floors. ASFF's resize is ``jax.image.resize``'s
half-pixel nearest (``mode='nearest-exact'``): shrinking a finer level by 2
reads rows 1, 3, 5, ..., not 0, 2, 4. The attention products are plain
``torch.matmul``, as they are plain ``jnp.einsum`` in the JAX package.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.feature_align import bilinear_sample
from .backbones.jy_modules import DAttentionBaseline
from .blocks import (ChannelAttention, CSPLayerWithTwoConv,  # noqa: F401
                     DarknetBottleneck, LayerNorm, LayerNorm2d,
                     SPPFBottleneck, YOLOConvModule, gelu)

Widths = Union[int, Sequence[int]]


def _widths(in_channels: Widths, n: int) -> Tuple[int, ...]:
    """``in_channels`` as ``n`` input widths (an int stands for all)."""
    if isinstance(in_channels, int):
        return (in_channels,) * n
    if len(in_channels) != n:
        raise ValueError(f'{len(in_channels)} widths for {n} inputs')
    return tuple(in_channels)


def _max_pool(x, k):
    """flax's stride-1 ``nn.max_pool`` with ``k // 2`` padding (-inf)."""
    return F.max_pool2d(x, k, 1, k // 2)


def _chw(v, dtype):
    """A per-channel vector broadcast over an NCHW map."""
    return v.to(dtype)[:, None, None]


def _mean_max(x):
    """(B, 2, H, W): the channel mean and the channel max of ``x``."""
    return torch.cat([x.mean(1, keepdim=True), x.amax(1, keepdim=True)], 1)


def _attend(q, k, v, scale):
    """Softmax attention of per-head channel-major maps: ``q`` (B, h, d,
    Nq), ``k`` (B, h, d, Nk), ``v`` (B, h, dv, Nk) -> (B, h, dv, Nq), the
    logits ``q . k / scale``."""
    attn = (q.transpose(-1, -2) @ k) / scale
    return v @ attn.softmax(-1).transpose(-1, -2)


class NormalConv2d(nn.Conv2d):
    """A convolution whose seeded weights are ``normal(0, std)`` (flax's
    ``nn.initializers.normal``) and bias zero."""

    def __init__(self, *args, std: float, **kwargs):
        super().__init__(*args, **kwargs)
        self.std = std

    @torch.no_grad()
    def init_seeded(self, gen: torch.Generator) -> None:
        self.weight.copy_(torch.randn(self.weight.shape, generator=gen)
                          * self.std)
        self.bias.zero_()


# ---- RepVGG -----------------------------------------------------------------
class RepVGGBlock(nn.Module):
    """3x3 conv + 1x1 conv (each with BN, no activation) + the identity
    branch, summed, then ReLU. The three branches stay three (the reference
    folds them into one 3x3 at deploy). The identity is a learned per-channel
    ``id_scale`` / ``id_bias`` pair, present when ``stride == 1`` and the
    widths match."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1):
        super().__init__()
        self.rbr_dense = YOLOConvModule(in_channels, out_channels, 3, stride,
                                        act=None)
        self.rbr_1x1 = YOLOConvModule(in_channels, out_channels, 1, stride,
                                      act=None)
        self.identity = stride == 1 and in_channels == out_channels
        if self.identity:
            self.id_scale = nn.Parameter(torch.ones(out_channels))
            self.id_bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x):
        y = self.rbr_dense(x) + self.rbr_1x1(x)
        if self.identity:
            y = y + x * _chw(self.id_scale, y.dtype) + _chw(self.id_bias,
                                                            y.dtype)
        return F.relu(y)


class RepStageBlock(nn.Module):
    """``num_blocks`` chained RepVGG blocks (the YOLOv6 stage body)."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_blocks: int = 1):
        super().__init__()
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f'block_{i}', RepVGGBlock(
                in_channels if i == 0 else out_channels, out_channels))

    def forward(self, x):
        for i in range(self.num_blocks):
            x = getattr(self, f'block_{i}')(x)
        return x


class BottleRep(nn.Module):
    """Two chained RepVGG blocks plus the input where the widths match,
    weighted by a learned ``alpha`` (initially 1) when ``adaptive_weight``."""

    def __init__(self, in_channels: int, out_channels: int,
                 adaptive_weight: bool = False):
        super().__init__()
        self.conv1 = RepVGGBlock(in_channels, out_channels)
        self.conv2 = RepVGGBlock(out_channels, out_channels)
        self.residual = in_channels == out_channels
        self.adaptive = adaptive_weight and self.residual
        if self.adaptive:
            self.alpha = nn.Parameter(torch.ones(1))

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        if not self.residual:
            return y
        if self.adaptive:
            return y + self.alpha.to(y.dtype) * x
        return y + x


class ConvWrapper(nn.Module):
    """A convolution with bias and no norm, then SiLU (YOLOv6's
    fuse-ready conv)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride,
                              kernel_size // 2)

    def forward(self, x):
        return F.silu(self.conv(x))


class BepC3StageBlock(nn.Module):
    """YOLOv6's CSP block over adaptive-weight BottleReps: ``conv1`` (1x1,
    ReLU) to ``int(out * hidden_ratio)``, ``max(num_blocks // 2, 1)``
    BottleReps, then ``conv3`` (1x1, ReLU), over the concat with ``conv2``
    (1x1, ReLU) of the input when ``concat_all_layer``."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_blocks: int = 1, hidden_ratio: float = 0.5,
                 concat_all_layer: bool = True):
        super().__init__()
        mid = int(out_channels * hidden_ratio)
        self.conv1 = YOLOConvModule(in_channels, mid, 1, act='relu')
        self.num_reps = max(num_blocks // 2, 1)
        for i in range(self.num_reps):
            self.add_module(f'rep_{i}', BottleRep(mid, mid,
                                                  adaptive_weight=True))
        self.concat_all_layer = concat_all_layer
        if concat_all_layer:
            self.conv2 = YOLOConvModule(in_channels, mid, 1, act='relu')
        self.conv3 = YOLOConvModule(2 * mid if concat_all_layer else mid,
                                    out_channels, 1, act='relu')

    def forward(self, x):
        a = self.conv1(x)
        for i in range(self.num_reps):
            a = getattr(self, f'rep_{i}')(a)
        if not self.concat_all_layer:
            return self.conv3(a)
        return self.conv3(torch.cat([a, self.conv2(x)], 1))


# ---- CSP and SPP variants ---------------------------------------------------
class SPPBottleneck(nn.Module):
    """SPP with parallel pools: 1x1 conv to ``out // 2``, stride-1 max pools
    of each of ``kernel_sizes`` side by side with the map, 1x1 conv."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_sizes: Sequence[int] = (5, 9, 13)):
        super().__init__()
        mid = out_channels // 2
        self.kernel_sizes = tuple(kernel_sizes)
        self.conv1 = YOLOConvModule(in_channels, mid, 1)
        self.conv2 = YOLOConvModule((1 + len(self.kernel_sizes)) * mid,
                                    out_channels, 1)

    def forward(self, x):
        x = self.conv1(x)
        return self.conv2(torch.cat(
            [x] + [_max_pool(x, k) for k in self.kernel_sizes], 1))


class CSPSPPFBottleneck(nn.Module):
    """CSP-wrapped SPPF: a 1x1 ``short`` branch beside ``main1`` (1x1),
    ``main2`` (3x3), ``main3`` (1x1), three chained pools, ``main4`` (1x1)
    and ``main5`` (3x3), all ``out // 2`` wide; ``final`` 1x1 over both."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 5):
        super().__init__()
        mid = out_channels // 2
        self.kernel_size = kernel_size
        self.short = YOLOConvModule(in_channels, mid, 1)
        self.main1 = YOLOConvModule(in_channels, mid, 1)
        self.main2 = YOLOConvModule(mid, mid, 3)
        self.main3 = YOLOConvModule(mid, mid, 1)
        self.main4 = YOLOConvModule(4 * mid, mid, 1)
        self.main5 = YOLOConvModule(mid, mid, 3)
        self.final = YOLOConvModule(2 * mid, out_channels, 1)

    def forward(self, x):
        k = self.kernel_size
        y = self.main3(self.main2(self.main1(x)))
        p1 = _max_pool(y, k)
        p2 = _max_pool(p1, k)
        p3 = _max_pool(p2, k)
        y = self.main5(self.main4(torch.cat([y, p1, p2, p3], 1)))
        return self.final(torch.cat([self.short(x), y], 1))


class C3(nn.Module):
    """YOLOv5's CSP bottleneck with three convs: ``cv1`` -> ``num_blocks``
    DarknetBottlenecks (``m_{i}``), beside ``cv2``; ``cv3`` over both."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_blocks: int = 1, add_identity: bool = True,
                 expand_ratio: float = 0.5):
        super().__init__()
        mid = int(out_channels * expand_ratio)
        self.cv1 = YOLOConvModule(in_channels, mid, 1)
        self.cv2 = YOLOConvModule(in_channels, mid, 1)
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f'm_{i}', self._block(mid, add_identity))
        self.cv3 = YOLOConvModule(2 * mid, out_channels, 1)

    def _block(self, mid, add_identity):
        return DarknetBottleneck(mid, mid, add_identity=add_identity)

    def forward(self, x):
        a = self.cv1(x)
        for i in range(self.num_blocks):
            a = getattr(self, f'm_{i}')(a)
        return self.cv3(torch.cat([a, self.cv2(x)], 1))


class C3k(C3):
    """:class:`C3` whose bottlenecks are ``kernel_size`` x ``kernel_size``
    twice, at expansion 1."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_blocks: int = 1, add_identity: bool = True,
                 expand_ratio: float = 0.5, kernel_size: int = 3):
        self.kernel_size = kernel_size
        super().__init__(in_channels, out_channels, num_blocks, add_identity,
                         expand_ratio)

    def _block(self, mid, add_identity):
        k = self.kernel_size
        return DarknetBottleneck(mid, mid, expansion=1.0,
                                 add_identity=add_identity,
                                 kernel_size=(k, k))


class C3K2(nn.Module):
    """YOLOv11's C2f whose inner blocks are 2-deep :class:`C3k` units:
    ``main`` to ``2 * mid`` split in halves, ``c3k_{i}`` chained on the
    last part, every part concatenated into ``final``."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_blocks: int = 1, expand_ratio: float = 0.5,
                 add_identity: bool = True):
        super().__init__()
        mid = int(out_channels * expand_ratio)
        self.mid = mid
        self.main = YOLOConvModule(in_channels, 2 * mid, 1)
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f'c3k_{i}', C3k(mid, mid, num_blocks=2,
                                            add_identity=add_identity))
        self.final = YOLOConvModule((2 + num_blocks) * mid, out_channels, 1)

    def forward(self, x):
        y = self.main(x)
        parts = [y[:, :self.mid], y[:, self.mid:]]
        for i in range(self.num_blocks):
            parts.append(getattr(self, f'c3k_{i}')(parts[-1]))
        return self.final(torch.cat(parts, 1))


# ---- channel and spatial gates ----------------------------------------------
class CBAM(nn.Module):
    """Convolutional block attention: a channel gate (one MLP, flax's
    ``Dense_0`` -> ReLU -> ``Dense_1``, on the average and on the max over
    the map, summed, sigmoid), then a spatial gate (a 7x7 conv ``spatial``
    over the channel mean and max, sigmoid)."""

    def __init__(self, in_channels: int, reduction: int = 16):
        super().__init__()
        c = in_channels
        hidden = max(c // reduction, 8)
        self.Dense_0 = nn.Linear(c, hidden)
        self.Dense_1 = nn.Linear(hidden, c)
        self.spatial = nn.Conv2d(2, 1, 7, padding=3)

    def _mlp(self, v):
        return self.Dense_1(F.relu(self.Dense_0(v)))

    def forward(self, x):
        gate = torch.sigmoid(self._mlp(x.mean((2, 3)))
                             + self._mlp(x.amax((2, 3))))
        x = x * gate[:, :, None, None]
        return x * torch.sigmoid(self.spatial(_mean_max(x)))


class ESEAttn(nn.Module):
    """Effective squeeze-excite: a 1x1 conv ``fc`` on the global average,
    sigmoid, gate on the input."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.fc = nn.Conv2d(in_channels, in_channels, 1)

    def forward(self, x):
        return x * torch.sigmoid(self.fc(x.mean((2, 3), keepdim=True)))


class ESE(nn.Module):
    """:class:`ESEAttn` whose ``fc`` starts from ``normal(0.001)``, then a
    1x1 conv module ``conv``."""

    def __init__(self, in_channels: int):
        super().__init__()
        c = in_channels
        self.fc = NormalConv2d(c, c, 1, std=0.001)
        self.conv = YOLOConvModule(c, c, 1)

    def forward(self, x):
        g = torch.sigmoid(self.fc(x.mean((2, 3), keepdim=True)))
        return self.conv(x * g)


class SpatialAttention(nn.Module):
    """CBAM's spatial gate alone: a ``kernel_size`` conv without bias over
    the channel mean and max, sigmoid."""

    def __init__(self, in_channels: int, kernel_size: int = 7):
        super().__init__()
        self.conv = nn.Conv2d(2, 1, kernel_size, padding=kernel_size // 2,
                              bias=False)

    def forward(self, x):
        return x * torch.sigmoid(self.conv(_mean_max(x)))


class C2fCBAM(nn.Module):
    """:class:`CSPLayerWithTwoConv` (``c2f``) followed by :class:`CBAM`
    (``cbam``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_blocks: int = 1):
        super().__init__()
        self.c2f = CSPLayerWithTwoConv(in_channels, out_channels,
                                       num_blocks=num_blocks)
        self.cbam = CBAM(out_channels)

    def forward(self, x):
        return self.cbam(self.c2f(x))


# ---- large-kernel blocks ----------------------------------------------------
class LSKBlock(nn.Module):
    """Large selective kernel: depthwise 5x5 (``dw5``), then depthwise 7x7
    dilated 3 (``dw7d3``); each projected to half the width (``pw1``,
    ``pw2``); a 7x7 conv ``select`` over their channel mean and max gives
    two sigmoid gates; their mix projected back (``proj``) gates the
    input."""

    def __init__(self, in_channels: int):
        super().__init__()
        c = in_channels
        self.dw5 = nn.Conv2d(c, c, 5, padding=2, groups=c)
        self.dw7d3 = nn.Conv2d(c, c, 7, padding=9, dilation=3, groups=c)
        self.pw1 = nn.Conv2d(c, c // 2, 1)
        self.pw2 = nn.Conv2d(c, c // 2, 1)
        self.select = nn.Conv2d(2, 2, 7, padding=3)
        self.proj = nn.Conv2d(c // 2, c, 1)

    def forward(self, x):
        a1 = self.dw5(x)
        a2 = self.dw7d3(a1)
        a1 = self.pw1(a1)
        a2 = self.pw2(a2)
        sel = torch.sigmoid(self.select(_mean_max(torch.cat([a1, a2], 1))))
        fused = a1 * sel[:, 0:1] + a2 * sel[:, 1:2]
        return x * self.proj(fused)


class LSKAttention(nn.Module):
    """``proj_1`` (1x1) -> GELU -> :class:`LSKBlock` (``lsk``) ->
    ``proj_2`` (1x1), plus the input."""

    def __init__(self, in_channels: int):
        super().__init__()
        c = in_channels
        self.proj_1 = nn.Conv2d(c, c, 1)
        self.lsk = LSKBlock(c)
        self.proj_2 = nn.Conv2d(c, c, 1)

    def forward(self, x):
        return x + self.proj_2(self.lsk(gelu(self.proj_1(x))))


class ConvMlp(nn.Module):
    """``fc1`` (1x1 to ``hidden_ratio`` times the width) -> depthwise 3x3
    ``dwconv`` -> GELU -> ``fc2`` (1x1 back)."""

    def __init__(self, in_channels: int, hidden_ratio: float = 4.0):
        super().__init__()
        c = in_channels
        hid = int(c * hidden_ratio)
        self.fc1 = nn.Conv2d(c, hid, 1)
        self.dwconv = nn.Conv2d(hid, hid, 3, padding=1, groups=hid)
        self.fc2 = nn.Conv2d(hid, c, 1)

    def forward(self, x):
        return self.fc2(gelu(self.dwconv(self.fc1(x))))


class LSKA(nn.Module):
    """A pre-norm block: ``x + layer_scale_1 * attn(norm1(x))``, then ``x +
    layer_scale_2 * mlp(norm2(x))`` (:class:`LSKAttention`,
    :class:`ConvMlp`; LayerNorm over the channels, epsilon 1e-6); the layer
    scales start at 1e-2."""

    def __init__(self, in_channels: int, mlp_ratio: float = 4.0):
        super().__init__()
        c = in_channels
        self.layer_scale_1 = nn.Parameter(torch.full((c,), 1e-2))
        self.layer_scale_2 = nn.Parameter(torch.full((c,), 1e-2))
        self.norm1 = LayerNorm2d(c)
        self.attn = LSKAttention(c)
        self.norm2 = LayerNorm2d(c)
        self.mlp = ConvMlp(c, mlp_ratio)

    def forward(self, x):
        x = x + _chw(self.layer_scale_1, x.dtype) * self.attn(self.norm1(x))
        return x + _chw(self.layer_scale_2, x.dtype) * self.mlp(
            self.norm2(x))


class ESELSKA(nn.Module):
    """:class:`ESE` (``ese``) then :class:`LSKA` (``lska``)."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.ese = ESE(in_channels)
        self.lska = LSKA(in_channels)

    def forward(self, x):
        return self.lska(self.ese(x))


# ---- two-input fusions ------------------------------------------------------
class AFF(nn.Module):
    """Attentional feature fusion of two maps of one width: the MS-CAM gate
    ``w = sigmoid(local + global)`` of ``x + y`` (``attn1_l1``, ``_l2``: 1x1
    convs with ReLU between; ``attn1_g1``, ``_g2``: the same on the global
    average; ``max(C // reduction, 8)`` wide inside), ``x w + y (1 - w)``;
    ``iterative`` (iAFF): a second gate (``attn2_*``) of that mix, applied
    to ``x`` and ``y`` again."""

    def __init__(self, in_channels: int, reduction: int = 4,
                 iterative: bool = False):
        super().__init__()
        self.iterative = iterative
        c = in_channels
        mid = max(c // reduction, 8)
        for stage in ('attn1', 'attn2') if self.iterative else ('attn1',):
            for branch in ('l', 'g'):
                self.add_module(f'{stage}_{branch}1', nn.Conv2d(c, mid, 1))
                self.add_module(f'{stage}_{branch}2', nn.Conv2d(mid, c, 1))

    def _ms_cam(self, z, name):
        conv = {k: getattr(self, f'{name}_{k}') for k in ('l1', 'l2', 'g1',
                                                          'g2')}
        local = conv['l2'](F.relu(conv['l1'](z)))
        glob = conv['g2'](F.relu(conv['g1'](z.mean((2, 3), keepdim=True))))
        return torch.sigmoid(local + glob)

    def forward(self, x, y):
        w = self._ms_cam(x + y, 'attn1')
        out = x * w + y * (1 - w)
        if self.iterative:
            w2 = self._ms_cam(out, 'attn2')
            out = x * w2 + y * (1 - w2)
        return out


class iAFF(AFF):
    """:class:`AFF` with the second, iterative gate."""

    def __init__(self, in_channels: int, reduction: int = 4,
                 iterative: bool = True):
        super().__init__(in_channels, reduction, iterative)


class AFF_CSP(nn.Module):
    """CSP-split attentional fusion: the first half of ``x`` (``C // 2``
    channels, ``in_channels`` = C) fuses with ``y`` (``C // 2`` channels)
    through :class:`AFF` (``aff``, reduction ``max(reduction // 2, 1)``),
    doubled; the second half rides through; ``final`` (1x1) to ``C //
    2``."""

    def __init__(self, in_channels: int, reduction: int = 4,
                 iterative: bool = False):
        super().__init__()
        half = in_channels // 2
        self.half = half
        self.aff = AFF(half, max(reduction // 2, 1), iterative)
        self.final = YOLOConvModule(in_channels, half, 1)

    def forward(self, x, y):
        fused = 2.0 * self.aff(x[:, :self.half], y)
        return self.final(torch.cat([fused, x[:, self.half:]], 1))


class iAFF_CSP(AFF_CSP):
    """:class:`AFF_CSP` over :class:`iAFF`."""

    def __init__(self, in_channels: int, reduction: int = 4,
                 iterative: bool = True):
        super().__init__(in_channels, reduction, iterative)


class ASFFDown(nn.Module):
    """Two-input spatial fusion: both projected to ``out_channels``
    (``conv1``, ``conv2``), a 1x1 ``proj1`` of their concat, a
    ``kernel_size`` conv ``saconv`` (no bias) over its channel mean and max,
    sigmoid: ``g x + (1 - g) y``. ``in_channels``: the widths of ``x`` and
    ``y``."""

    def __init__(self, in_channels: Widths, out_channels: int,
                 kernel_size: int = 7):
        super().__init__()
        cx, cy = _widths(in_channels, 2)
        self.conv1 = YOLOConvModule(cx, out_channels, 1)
        self.conv2 = YOLOConvModule(cy, out_channels, 1)
        self.proj1 = YOLOConvModule(2 * out_channels, out_channels, 1)
        self.saconv = nn.Conv2d(2, 1, kernel_size, padding=kernel_size // 2,
                                bias=False)

    def forward(self, x, y):
        x = self.conv1(x)
        y = self.conv2(y)
        z = self.proj1(torch.cat([x, y], 1))
        g = torch.sigmoid(self.saconv(_mean_max(z)))
        return g * x + (1.0 - g) * y


class BiFusion(nn.Module):
    """YOLOv6's BiFusion of the current level, the upsampled coarser one
    and the finer one: ``cv_cur`` and ``cv_fine`` (1x1), ``down`` (3x3
    stride 2) on the finer, ``cv_out`` (1x1) over ``[coarser_up, cur,
    finer]``. ``in_channels``: the widths of ``cur``, ``coarser_up`` and
    ``finer``."""

    def __init__(self, in_channels: Widths, out_channels: int):
        super().__init__()
        c_cur, c_coarse, c_fine = _widths(in_channels, 3)
        self.cv_cur = YOLOConvModule(c_cur, out_channels, 1)
        self.cv_fine = YOLOConvModule(c_fine, out_channels, 1)
        self.down = YOLOConvModule(out_channels, out_channels, 3, 2)
        self.cv_out = YOLOConvModule(c_coarse + 2 * out_channels,
                                     out_channels, 1)

    def forward(self, cur, coarser_up, finer):
        c0 = self.cv_cur(cur)
        c1 = self.down(self.cv_fine(finer))
        return self.cv_out(torch.cat([coarser_up, c0, c1], 1))


# ---- multi-level fusion -----------------------------------------------------
class ASFF(nn.Module):
    """Adaptively spatial feature fusion at ``level``: every input
    compressed to ``out_channels`` (``compress_{i}``, 1x1), resized to the
    level's size (``jax.image.resize``'s half-pixel nearest), weighted per
    location by a softmax over the levels (``weight_{i}``, 1x1 to 8
    channels each; ``weight_levels``, a 1x1 conv with bias), summed and
    expanded (``expand``, 3x3). ``in_channels``: each input's width,
    finest first."""

    def __init__(self, in_channels: Sequence[int], level: int = 0,
                 out_channels: int = 256):
        super().__init__()
        self.level = level
        self.num_levels = len(in_channels)
        for i, c in enumerate(in_channels):
            self.add_module(f'compress_{i}', YOLOConvModule(c, out_channels,
                                                            1))
            self.add_module(f'weight_{i}', YOLOConvModule(out_channels, 8, 1))
        self.weight_levels = nn.Conv2d(8 * self.num_levels, self.num_levels,
                                       1)
        self.expand = YOLOConvModule(out_channels, out_channels, 3)

    def forward(self, feats):
        if len(feats) != self.num_levels:
            raise ValueError(f'{len(feats)} maps for {self.num_levels} '
                             f'levels')
        size = feats[self.level].shape[-2:]
        resized = []
        for i, f in enumerate(feats):
            f = getattr(self, f'compress_{i}')(f)
            if f.shape[-2] != size[0]:
                f = F.interpolate(f, size=tuple(size), mode='nearest-exact')
            resized.append(f)
        logits = self.weight_levels(torch.cat(
            [getattr(self, f'weight_{i}')(f) for i, f in enumerate(resized)],
            1))
        attn = logits.softmax(1)                         # (B, L, H, W)
        fused = (torch.stack(resized, 1) * attn[:, :, None]).sum(1)
        return self.expand(fused)


# ---- PSA attention ----------------------------------------------------------
class PSAAttention(nn.Module):
    """Self-attention over all positions of the map: a 1x1 conv module
    ``qkv`` (no activation) gives ``q | k | v`` along the channels (heads
    outer, features inner; q and k ``int(head_dim * attn_ratio)`` a head);
    ``num_heads``-head attention; plus a depthwise 3x3 ``pe`` of ``v`` as a
    map; a 1x1 conv module ``proj``."""

    def __init__(self, in_channels: int, num_heads: int = 8,
                 attn_ratio: float = 0.5):
        super().__init__()
        c = in_channels
        self.num_heads = num_heads
        self.head_dim = c // num_heads
        self.key_dim = int(self.head_dim * attn_ratio)
        qk = 2 * self.key_dim * num_heads
        self.qkv = YOLOConvModule(c, qk + c, 1, act=None)
        self.pe = nn.Conv2d(c, c, 3, padding=1, groups=c)
        self.proj = YOLOConvModule(c, c, 1, act=None)

    def forward(self, x):
        b, c, h, w = x.shape
        heads, kd = self.num_heads, self.key_dim
        qkv = self.qkv(x)
        half = heads * kd
        q = qkv[:, :half].reshape(b, heads, kd, h * w)
        k = qkv[:, half:2 * half].reshape(b, heads, kd, h * w)
        v = qkv[:, 2 * half:]
        out = _attend(q, k, v.reshape(b, heads, self.head_dim, h * w),
                      kd ** 0.5).reshape(b, c, h, w)
        return self.proj(out + self.pe(v))


class PSABlock(nn.Module):
    """:class:`PSAAttention` (``attn``) and a conv FFN (``ffn1`` to twice
    the width, ``ffn2`` back; conv modules without activation), each with
    a shortcut when ``shortcut``."""

    def __init__(self, in_channels: int, attn_ratio: float = 0.5,
                 num_heads: int = 4, shortcut: bool = True):
        super().__init__()
        c = in_channels
        self.shortcut = shortcut
        self.attn = PSAAttention(c, num_heads, attn_ratio)
        self.ffn1 = YOLOConvModule(c, 2 * c, 1, act=None)
        self.ffn2 = YOLOConvModule(2 * c, c, 1, act=None)

    def forward(self, x):
        a = self.attn(x)
        x = x + a if self.shortcut else a
        f = self.ffn2(self.ffn1(x))
        return x + f if self.shortcut else f


class C2PSA(nn.Module):
    """CSP split of ``cv1`` (1x1 to ``2 * mid``, no activation): the second
    half through ``num_blocks`` :class:`PSABlock` (``psa_{i}``, ``max(mid //
    64, 1)`` heads); ``cv2`` (1x1, no activation) over both halves."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_blocks: int = 1, expand_ratio: float = 0.5):
        super().__init__()
        mid = int(out_channels * expand_ratio)
        self.mid = mid
        self.cv1 = YOLOConvModule(in_channels, 2 * mid, 1, act=None)
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f'psa_{i}', PSABlock(
                mid, num_heads=max(mid // 64, 1)))
        self.cv2 = YOLOConvModule(2 * mid, out_channels, 1, act=None)

    def forward(self, x):
        y = self.cv1(x)
        a, b = y[:, :self.mid], y[:, self.mid:]
        for i in range(self.num_blocks):
            b = getattr(self, f'psa_{i}')(b)
        return self.cv2(torch.cat([a, b], 1))


# ---- text-guided blocks -----------------------------------------------------
class MaxSigmoidAttnBlock(nn.Module):
    """Text-guided max-sigmoid gate: the guide tokens (B, n,
    ``guide_channels``) through ``guide_fc`` and the map's embedding (the
    map itself when it is ``embed_channels`` wide, else ``embed_conv``, a
    1x1 conv module without activation) meet per head (dot over
    ``embed_channels // num_heads``); the max over the tokens, over
    ``sqrt(out_channels // num_heads)``, plus a per-head ``bias``, sigmoid,
    times a per-head ``scale`` when ``with_scale``, gates the head's
    channels of the projection (``project_conv``, a 3x3 conv module without
    activation, or ``project_rep``, a :class:`RepVGGBlock`, when
    ``rep_proj``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 guide_channels: int, embed_channels: int,
                 num_heads: int = 1, with_scale: bool = False,
                 rep_proj: bool = False):
        super().__init__()
        self.rep_proj = rep_proj
        self.num_heads = num_heads
        self.out_channels = out_channels
        self.embed_channels = embed_channels
        self.with_scale = with_scale
        self.guide_fc = nn.Linear(guide_channels, embed_channels)
        if embed_channels != in_channels:
            self.embed_conv = YOLOConvModule(in_channels, embed_channels, 1,
                                             act=None)
        else:
            self.embed_conv = None
        self.bias = nn.Parameter(torch.zeros(num_heads))
        if with_scale:
            self.scale = nn.Parameter(torch.ones(num_heads))
        if self.rep_proj:
            self.project_rep = RepVGGBlock(in_channels, out_channels)
        else:
            self.project_conv = YOLOConvModule(in_channels, out_channels, 3,
                                               act=None)

    def forward(self, x, guide):
        b, _, h, w = x.shape
        heads = self.num_heads
        hc = self.out_channels // heads
        ec = self.embed_channels // heads
        g = self.guide_fc(guide).reshape(b, -1, heads, ec)
        embed = x if self.embed_conv is None else self.embed_conv(x)
        e = embed.reshape(b, heads, ec, h * w)
        attn = torch.einsum('bhep,bnhe->bhpn', e, g).amax(-1)   # (B, h, HW)
        attn = attn / hc ** 0.5
        attn = torch.sigmoid(attn + self.bias.to(attn.dtype)[None, :, None])
        if self.with_scale:
            attn = attn * self.scale.to(attn.dtype)[None, :, None]
        proj = self.project_rep(x) if self.rep_proj else \
            self.project_conv(x)
        out = proj.reshape(b, heads, hc, h * w) * attn[:, :, None]
        return out.reshape(b, self.out_channels, h, w)


class RepConvMaxSigmoidAttnBlock(MaxSigmoidAttnBlock):
    """:class:`MaxSigmoidAttnBlock` with the RepVGG projection."""

    def __init__(self, *args, rep_proj: bool = True, **kwargs):
        super().__init__(*args, rep_proj=rep_proj, **kwargs)


class MaxSigmoidCSPLayerWithTwoConv(nn.Module):
    """C2f whose extra branch runs guided gates: ``main`` to ``2 * mid``
    split in halves, ``num_blocks`` DarknetBottlenecks (``block_{i}``)
    chained on the last part, then ``depth`` :class:`MaxSigmoidAttnBlock`
    (``attn_{i}``) on the last part, every part concatenated into
    ``final``."""

    def __init__(self, in_channels: int, out_channels: int,
                 guide_channels: int, embed_channels: int,
                 num_blocks: int = 1, num_heads: int = 1, depth: int = 3,
                 expand_ratio: float = 0.5, add_identity: bool = True,
                 with_scale: bool = False, rep_attn: bool = False):
        super().__init__()
        mid = int(out_channels * expand_ratio)
        self.mid = mid
        self.main = YOLOConvModule(in_channels, 2 * mid, 1)
        self.num_blocks, self.depth = num_blocks, depth
        for i in range(num_blocks):
            self.add_module(f'block_{i}', DarknetBottleneck(
                mid, mid, add_identity=add_identity))
        for i in range(depth):
            self.add_module(f'attn_{i}', MaxSigmoidAttnBlock(
                mid, mid, guide_channels, embed_channels, num_heads,
                with_scale, rep_proj=rep_attn))
        self.final = YOLOConvModule((3 + num_blocks) * mid, out_channels, 1)

    def forward(self, x, guide):
        y = self.main(x)
        parts = [y[:, :self.mid], y[:, self.mid:]]
        for i in range(self.num_blocks):
            parts.append(getattr(self, f'block_{i}')(parts[-1]))
        attn = parts[-1]
        for i in range(self.depth):
            attn = getattr(self, f'attn_{i}')(attn, guide)
        parts.append(attn)
        return self.final(torch.cat(parts, 1))


class RepConvMaxSigmoidCSPLayerWithTwoConv(MaxSigmoidCSPLayerWithTwoConv):
    """:class:`MaxSigmoidCSPLayerWithTwoConv` with RepVGG projections."""

    def __init__(self, *args, rep_attn: bool = True, **kwargs):
        super().__init__(*args, rep_attn=rep_attn, **kwargs)


class ImagePoolingAttentionModule(nn.Module):
    """Text tokens attend into pooled image features: each map projected to
    ``embed_channels`` (``proj_{i}``, a 1x1 conv module without activation)
    and max-pooled to ``pool_size`` x ``pool_size`` patches (torch's
    adaptive max pool: cell ``i`` covers rows ``[floor(i h / p), ceil((i +
    1) h / p))``, overlapping and never empty on a map smaller than the
    pool); queries from the text (``q_norm``, ``query``), keys and values
    from the patches (``k_norm``, ``key``; ``v_norm``, ``value``);
    ``num_heads``-head attention; ``proj`` back to ``text_channels``, times
    ``scale`` (initially 0) when ``with_scale``; plus the text.
    ``in_channels``: each map's width."""

    def __init__(self, in_channels: Sequence[int], text_channels: int,
                 embed_channels: int, num_heads: int = 8, pool_size: int = 3,
                 with_scale: bool = False):
        super().__init__()
        e = embed_channels
        self.num_levels = len(in_channels)
        self.num_heads = num_heads
        self.pool_size = pool_size
        self.with_scale = with_scale
        for i, c in enumerate(in_channels):
            self.add_module(f'proj_{i}', YOLOConvModule(c, e, 1, act=None))
        self.q_norm = LayerNorm(text_channels)
        self.query = nn.Linear(text_channels, e)
        self.k_norm = LayerNorm(e)
        self.key = nn.Linear(e, e)
        self.v_norm = LayerNorm(e)
        self.value = nn.Linear(e, e)
        self.proj = nn.Linear(e, text_channels)
        if with_scale:
            self.scale = nn.Parameter(torch.zeros(1))

    def forward(self, text, feats):
        if len(feats) != self.num_levels:
            raise ValueError(f'{len(feats)} maps for {self.num_levels} '
                             f'levels')
        b = text.shape[0]
        heads = self.num_heads
        patches = [F.adaptive_max_pool2d(getattr(self, f'proj_{i}')(f),
                                         self.pool_size).flatten(2)
                   for i, f in enumerate(feats)]
        img = torch.cat(patches, 2).transpose(1, 2)        # (B, L p^2, E)
        q = self.query(self.q_norm(text))
        k = self.key(self.k_norm(img))
        v = self.value(self.v_norm(img))
        hc = q.shape[-1] // heads

        def split(t):                                      # (B, h, hc, N)
            return t.reshape(b, -1, heads, hc).permute(0, 2, 3, 1)

        out = _attend(split(q), split(k), split(v), hc ** 0.5)
        out = self.proj(out.permute(0, 3, 1, 2).reshape(b, -1, heads * hc))
        if self.with_scale:
            out = out * self.scale.to(out.dtype)
        return text + out


# ---- deformable fusions -----------------------------------------------------
class DCAttention(nn.Module):
    """Deformable cross attention: queries ``proj_q`` (1x1) of ``x``; on a
    grid of stride ``stride``, offsets ``tanh(conv_offset(gelu(avg_pool(q))))
    * offset_range_factor * stride`` (``conv_offset`` 3x3 to 2, the y then
    the x offset); ``y`` bilinearly sampled there, projected to keys and
    values (``proj_k``, ``proj_v``); ``num_heads``-head attention;
    ``proj_out`` (1x1). Returns the output (B, C, H, W) and the sampling
    positions (B, N, 2) as (x, y) in ``y``'s cells. ``in_channels``: the
    widths of ``x`` and ``y``. ``n_groups`` is accepted and not read, as in
    the JAX package."""

    def __init__(self, in_channels: Widths, num_heads: int = 4,
                 n_groups: int = 4, stride: int = 4,
                 offset_range_factor: float = 2.0):
        super().__init__()
        c, cy = _widths(in_channels, 2)
        self.num_heads, self.stride = num_heads, stride
        self.offset_range_factor = offset_range_factor
        self.proj_q = nn.Conv2d(c, c, 1)
        self.conv_offset = nn.Conv2d(c, 2, 3, padding=1)
        self.proj_k = nn.Linear(cy, c)
        self.proj_v = nn.Linear(cy, c)
        self.proj_out = nn.Conv2d(c, c, 1)

    def forward(self, x, y):
        b, c, h, w = x.shape
        s = self.stride
        q = self.proj_q(x)
        rh, rw = h // s, w // s
        ref_y = (torch.arange(rh, device=x.device) + 0.5) * s
        ref_x = (torch.arange(rw, device=x.device) + 0.5) * s
        ry, rx = torch.meshgrid(ref_y, ref_x, indexing='ij')
        off = self.conv_offset(gelu(F.avg_pool2d(q, s, s)))
        off = torch.tanh(off) * self.offset_range_factor * s
        py = (ry[None] + off[:, 0]).reshape(b, -1)
        px = (rx[None] + off[:, 1]).reshape(b, -1)
        sampled = bilinear_sample(y, px, py).transpose(1, 2).to(x.dtype)
        heads = self.num_heads
        hd = c // heads

        def split(t):                                      # (B, h, hd, N)
            return t.reshape(b, -1, heads, hd).permute(0, 2, 3, 1)

        out = _attend(q.reshape(b, heads, hd, h * w),
                      split(self.proj_k(sampled)),
                      split(self.proj_v(sampled)), hd ** 0.5)
        out = self.proj_out(out.reshape(b, c, h, w))
        return out, torch.stack([px, py], -1)


class DASFF(nn.Module):
    """Two inputs projected to ``out_channels`` (``conv1``, ``conv2``),
    fused by ``proj1`` (1x1) and refined by deformable self-attention
    (``deformable_attn``: :class:`.backbones.jy_modules.DAttentionBaseline`,
    4 heads, stride 4), residually. ``in_channels``: the widths of ``x``
    and ``y``."""

    def __init__(self, in_channels: Widths, out_channels: int):
        super().__init__()
        cx, cy = _widths(in_channels, 2)
        self.conv1 = YOLOConvModule(cx, out_channels, 1)
        self.conv2 = YOLOConvModule(cy, out_channels, 1)
        self.proj1 = YOLOConvModule(2 * out_channels, out_channels, 1)
        self.deformable_attn = DAttentionBaseline(
            out_channels, dim=out_channels, num_heads=4, n_groups=4,
            stride=4)

    def forward(self, x, y):
        z = self.proj1(torch.cat([self.conv1(x), self.conv2(y)], 1))
        return z + self.deformable_attn(z)


class DCASFF(nn.Module):
    """Deformable cross-attention fusion: both inputs projected to
    ``out_channels`` (``conv1``, ``conv2``), :class:`DCAttention`
    (``deformable_cattn``) of ``x`` into ``y``, then ``sigmoid(alpha) out +
    sigmoid(beta) x`` with per-channel ``alpha`` and ``beta`` (initially
    0). ``in_channels``: the widths of ``x`` and ``y``."""

    def __init__(self, in_channels: Widths, out_channels: int):
        super().__init__()
        cx, cy = _widths(in_channels, 2)
        self.conv1 = YOLOConvModule(cx, out_channels, 1)
        self.conv2 = YOLOConvModule(cy, out_channels, 1)
        self.deformable_cattn = DCAttention(out_channels)
        self.alpha = nn.Parameter(torch.zeros(out_channels))
        self.beta = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x, y):
        x = self.conv1(x)
        out, _ = self.deformable_cattn(x, self.conv2(y))
        return (_chw(torch.sigmoid(self.alpha), out.dtype) * out
                + _chw(torch.sigmoid(self.beta), x.dtype) * x)


# the reference's other names for blocks of this library and of
# ``models/blocks.py`` (which re-exports ``CSPLayerWithTwoConv``,
# ``SPPFBottleneck`` and ``ChannelAttention`` above)
LSKModule = LSKBlock
CSPSPPFModule = CSPSPPFBottleneck
MMDarknetBottleneck = DarknetBottleneck

__all__ = [
    'RepVGGBlock', 'RepStageBlock', 'SPPBottleneck', 'CSPSPPFBottleneck',
    'C3', 'CBAM', 'ESEAttn', 'LSKBlock', 'AFF', 'iAFF', 'ASFF', 'BiFusion',
    'BottleRep', 'ConvWrapper', 'BepC3StageBlock', 'C3k', 'C3K2',
    'PSAAttention', 'PSABlock', 'C2PSA', 'MaxSigmoidAttnBlock',
    'RepConvMaxSigmoidAttnBlock', 'MaxSigmoidCSPLayerWithTwoConv',
    'RepConvMaxSigmoidCSPLayerWithTwoConv', 'ImagePoolingAttentionModule',
    'AFF_CSP', 'iAFF_CSP', 'SpatialAttention', 'C2fCBAM', 'ESE',
    'LSKAttention', 'ConvMlp', 'LSKA', 'ESELSKA', 'ASFFDown', 'DCAttention',
    'DASFF', 'DCASFF', 'LSKModule', 'CSPSPPFModule', 'MMDarknetBottleneck',
    'CSPLayerWithTwoConv', 'SPPFBottleneck', 'ChannelAttention',
]
