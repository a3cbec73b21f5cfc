"""CSPNeXt backbone, RTMDet-style (counterpart of
``orientedobjectdetection_tpu/models/backbones/cspnext.py``; reference
``backbones/cspnext.py:14-212``): a 3-conv stem, four P5 stages of [stride-2
conv, SPPF on the last, CSPLayer with channel attention], each ``int(c *
widen_factor)`` wide and ``max(round(n * deepen_factor), 1)`` blocks deep,
and ``stage_aux`` MSARC attention stages (prototype3).

Module names are the JAX package's (``stem_0``, ``stage1_conv``,
``stage4_spp``, ``stage1_csp``, ``stage1_aux``). ``out_widths`` lists the
widths of the returned maps, which the neck is built from.
"""

from __future__ import annotations

from typing import Optional, Sequence

from torch import nn

from ...utils.registry import BACKBONES
from ..blocks import CSPLayer, SPPFBottleneck, YOLOConvModule

# in_channels, out_channels, num_blocks, add_identity, use_spp
P5_ARCH = [
    [64, 128, 3, True, False],
    [128, 256, 6, True, False],
    [256, 512, 6, True, False],
    [512, 1024, 3, False, True],
]


@BACKBONES.register_module()
class CSPNeXt(nn.Module):
    """Input NCHW; returns the ``out_indices`` maps (0 the stem, i the
    output of stage i), NCHW. ``stage_aux``: an MSARC module after the
    first ``stage_aux`` stages (``reverse=True``) or the last
    (``reverse=False``). ``use_depthwise``, ``norm_cfg``, ``act_cfg``,
    ``norm_eval``, ``frozen_stages`` and ``init_cfg`` are accepted and not
    read, as in the JAX package (every BN is :class:`FrozenBatchNorm`, its
    mode the train step's)."""

    def __init__(self, arch: str = 'P5', deepen_factor: float = 1.0,
                 widen_factor: float = 1.0,
                 last_stage_out_channels: int = 1024,
                 out_indices: Sequence[int] = (2, 3, 4),
                 frozen_stages: int = -1, use_depthwise: bool = False,
                 expand_ratio: float = 0.5, channel_attention: bool = True,
                 norm_cfg: Optional[dict] = None,
                 act_cfg: Optional[dict] = None, norm_eval: bool = False,
                 stage_aux: Optional[int] = None, reverse: bool = True,
                 cspnext_block: bool = True,
                 init_cfg: Optional[dict] = None, in_channels: int = 3):
        super().__init__()
        from .jy_modules import MSARCModule
        arch_rows = [list(s) for s in P5_ARCH]
        arch_rows[-1][1] = last_stage_out_channels
        wf, df = widen_factor, deepen_factor
        self.frozen_stages = frozen_stages
        self.out_indices = tuple(out_indices)
        self.num_stages = len(arch_rows)
        stem_out = int(arch_rows[0][0] * wf)
        self.stem_0 = YOLOConvModule(in_channels, stem_out // 2, 3, 2)
        self.stem_1 = YOLOConvModule(stem_out // 2, stem_out // 2, 3, 1)
        self.stem_2 = YOLOConvModule(stem_out // 2, stem_out, 3, 1)
        widths = [stem_out]
        cin = stem_out
        for i, (_, cout, n_blocks, add_id, use_spp) in enumerate(arch_rows):
            cout = int(cout * wf)
            n = max(round(n_blocks * df), 1)
            self.add_module(f'stage{i + 1}_conv',
                            YOLOConvModule(cin, cout, 3, 2))
            if use_spp:
                self.add_module(f'stage{i + 1}_spp',
                                SPPFBottleneck(cout, cout, 5))
            self.add_module(f'stage{i + 1}_csp', CSPLayer(
                cout, cout, expand_ratio=expand_ratio, num_blocks=n,
                add_identity=add_id, use_cspnext_block=cspnext_block,
                channel_attention=channel_attention))
            if stage_aux is not None and (
                    i < stage_aux if reverse
                    else i >= len(arch_rows) - stage_aux):
                self.add_module(f'stage{i + 1}_aux', MSARCModule(cout, cout))
            widths.append(cout)
            cin = cout
        self.out_widths = [widths[i] for i in self.out_indices]

    def forward(self, x):
        x = self.stem_2(self.stem_1(self.stem_0(x)))
        outs = [x] if 0 in self.out_indices else []
        for i in range(1, self.num_stages + 1):
            for part in ('conv', 'spp', 'csp', 'aux'):
                module = getattr(self, f'stage{i}_{part}', None)
                if module is not None:
                    x = module(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)


@BACKBONES.register_module()
class CSPNeXtLarge(CSPNeXt):
    """prototype3's name for :class:`CSPNeXt` with ``stage_aux`` MSARC
    stages."""
