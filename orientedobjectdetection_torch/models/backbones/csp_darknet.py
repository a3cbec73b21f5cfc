"""YOLOv8 CSPDarknet backbone (counterpart of
``orientedobjectdetection_tpu/models/backbones/csp_darknet.py``; reference
``backbones/csp_darknet.py:21-176``): a single-conv stem, four stages of
[stride-2 conv, C2f], SPPF after the last stage. Module names are the JAX
package's (``stem``, ``stage1_conv``, ``stage1_csp``, ``stage4_sppf``).
"""

from __future__ import annotations

from typing import Optional, Sequence

from torch import nn

from ...utils.registry import BACKBONES
from ..blocks import CSPLayerWithTwoConv, SPPFBottleneck, YOLOConvModule

P5_DARKNET = [
    [64, 128, 3, True],
    [128, 256, 6, True],
    [256, 512, 6, True],
    [512, 1024, 3, True],
]


@BACKBONES.register_module()
class YOLOv8CSPDarknet(nn.Module):
    """Input NCHW; returns the ``out_indices`` maps (0 the stem), NCHW,
    ``out_widths`` wide. ``norm_cfg``, ``act_cfg`` and ``init_cfg`` are
    accepted and not read, as in the JAX package. The optimizer freezes
    none of it (``frozen_stages``)."""

    frozen_stages = -1

    def __init__(self, arch: str = 'P5', deepen_factor: float = 1.0,
                 widen_factor: float = 1.0,
                 last_stage_out_channels: int = 1024,
                 out_indices: Sequence[int] = (2, 3, 4),
                 norm_cfg: Optional[dict] = None,
                 act_cfg: Optional[dict] = None,
                 init_cfg: Optional[dict] = None, in_channels: int = 3):
        super().__init__()
        rows = [list(a) for a in P5_DARKNET]
        rows[-1][1] = last_stage_out_channels
        wf, df = widen_factor, deepen_factor
        self.out_indices = tuple(out_indices)
        self.num_stages = len(rows)
        cin = int(rows[0][0] * wf)
        self.stem = YOLOConvModule(in_channels, cin, 3, 2)
        widths = [cin]
        for i, (_, cout, n_blocks, add_id) in enumerate(rows):
            cout = int(cout * wf)
            n = max(round(n_blocks * df), 1)
            self.add_module(f'stage{i + 1}_conv',
                            YOLOConvModule(cin, cout, 3, 2))
            self.add_module(f'stage{i + 1}_csp', CSPLayerWithTwoConv(
                cout, cout, num_blocks=n, add_identity=add_id))
            if i == len(rows) - 1:
                self.add_module(f'stage{i + 1}_sppf',
                                SPPFBottleneck(cout, cout, 5))
            widths.append(cout)
            cin = cout
        self.out_widths = [widths[i] for i in self.out_indices]

    def forward(self, x):
        x = self.stem(x)
        outs = [x] if 0 in self.out_indices else []
        for i in range(1, self.num_stages + 1):
            for part in ('conv', 'csp', 'sppf'):
                module = getattr(self, f'stage{i}_{part}', None)
                if module is not None:
                    x = module(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)
