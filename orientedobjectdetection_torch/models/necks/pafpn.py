"""YOLOv8 PAFPN necks (counterpart of
``orientedobjectdetection_tpu/models/necks/pafpn.py``; reference
``necks/pafpn.py:192-`` on ``base_yolo_neck.py:19-269``): top-down,
nearest 2x upsample + concat + C2f; bottom-up, stride-2 conv + concat +
C2f; no reduce or out layers. ``YOLOv8PAFPN_E`` appends stride-2 levels.

The JAX neck never reads ``in_channels``: flax infers each input's width.
The port is built with the widths the backbone really produces
(``feat_widths``, from the backbone's ``out_widths``); without them it
takes ``make_divisible(in_channels, widen_factor)``. The C2f layers are
``make_divisible(out_channels, widen_factor)`` wide; ``out_widths`` lists
the returned maps' widths. ``YOLOv6RepPAFPN`` is not ported yet (ROADMAP
A.11b).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn

from ...utils.registry import NECKS
from ..blocks import (CSPLayerWithTwoConv, YOLOConvModule, make_divisible,
                      make_round)


def upsample2x(x):
    """Nearest 2x upsample (each cell repeated), NCHW."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


@NECKS.register_module()
class YOLOv8PAFPN(nn.Module):
    """Input: the backbone's maps, NCHW; returns one map a level, NCHW.
    ``norm_cfg``, ``act_cfg``, ``freeze_all`` and ``init_cfg`` are accepted
    and not read, as in the JAX package. Module names are the JAX
    package's (``top_down_{level}``, ``downsample_{i}``,
    ``bottom_up_{i}``)."""

    takes_widths = True

    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024),
                 out_channels: Union[Sequence[int], int] = (256, 512, 1024),
                 deepen_factor: float = 1.0, widen_factor: float = 1.0,
                 num_csp_blocks: int = 3, freeze_all: bool = False,
                 norm_cfg: Optional[dict] = None,
                 act_cfg: Optional[dict] = None,
                 init_cfg: Optional[dict] = None,
                 feat_widths: Optional[Sequence[int]] = None):
        super().__init__()
        wf = widen_factor
        n_levels = len(in_channels)
        if isinstance(out_channels, int):
            out_channels = [out_channels] * n_levels
        widths = list(feat_widths) if feat_widths is not None else \
            [make_divisible(c, wf) for c in in_channels]
        if len(widths) != n_levels:
            raise ValueError(f'{len(widths)} input maps for {n_levels} '
                             f'levels')
        self.num_levels = n_levels
        n_blocks = make_round(num_csp_blocks, deepen_factor)
        outs = [make_divisible(c, wf) for c in out_channels]
        inner = widths[-1]
        for idx in range(n_levels - 1, 0, -1):
            self.add_module(f'top_down_{idx - 1}', CSPLayerWithTwoConv(
                inner + widths[idx - 1], outs[idx - 1], num_blocks=n_blocks,
                add_identity=False))
            inner = outs[idx - 1]
        for idx in range(n_levels - 1):
            self.add_module(f'downsample_{idx}',
                            YOLOConvModule(outs[idx], outs[idx], 3, 2))
            skip = widths[-1] if idx + 1 == n_levels - 1 else outs[idx + 1]
            self.add_module(f'bottom_up_{idx}', CSPLayerWithTwoConv(
                outs[idx] + skip, outs[idx + 1], num_blocks=n_blocks,
                add_identity=False))
        self.out_widths = outs

    def forward(self, feats):
        n = self.num_levels
        if len(feats) != n:
            raise ValueError(f'{len(feats)} maps for {n} levels')
        inner = [feats[-1]]
        for idx in range(n - 1, 0, -1):
            cat = torch.cat([upsample2x(inner[0]), feats[idx - 1]], 1)
            inner.insert(0, getattr(self, f'top_down_{idx - 1}')(cat))
        outs = [inner[0]]
        for idx in range(n - 1):
            down = getattr(self, f'downsample_{idx}')(outs[-1])
            outs.append(getattr(self, f'bottom_up_{idx}')(
                torch.cat([down, inner[idx + 1]], 1)))
        return tuple(outs)


@NECKS.register_module()
class YOLOv8PAFPN_E(YOLOv8PAFPN):
    """:class:`YOLOv8PAFPN` with extra stride-2 levels (``extra_{i}``):
    one a width of ``expanded_down_feat_channels`` (``make_divisible``
    with the neck's ``widen_factor``), or ``num_extra_levels`` as wide as
    the last level."""

    def __init__(self, num_extra_levels: int = 1,
                 expanded_down_feat_channels: Optional[Sequence[int]] = None,
                 **kwargs):
        super().__init__(**kwargs)
        wf = kwargs.get('widen_factor', 1.0)
        extra = expanded_down_feat_channels
        n_extra = len(extra) if extra else num_extra_levels
        self.num_extra = n_extra
        cin = self.out_widths[-1]
        for i in range(n_extra):
            ch = make_divisible(extra[i], wf) if extra else cin
            self.add_module(f'extra_{i}', YOLOConvModule(cin, ch, 3, 2))
            self.out_widths = self.out_widths + [ch]
            cin = ch

    def forward(self, feats):
        outs = list(super().forward(feats))
        for i in range(self.num_extra):
            outs.append(getattr(self, f'extra_{i}')(outs[-1]))
        return tuple(outs)
