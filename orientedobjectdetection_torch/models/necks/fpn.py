"""Feature Pyramid Network (counterpart of
``orientedobjectdetection_tpu/models/necks/fpn.py``), mmdet names:
``lateral_convs.i.conv``, ``fpn_convs.i.conv``, and the extra levels in
``fpn_convs`` after the laterals. With ``add_extra_convs=False`` the extra
levels have no parameters: each is a 1x1 max pool with stride 2 of the
level before it, which is that level's every second row and column.
Otherwise each extra level is a 3x3 stride-2 conv, the first reading the
last input (``'on_input'``, or ``True``), the last lateral
(``'on_lateral'``) or the last output (``'on_output'``), each later one the
level before it (after a ReLU with ``relu_before_extra_convs``)."""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.registry import NECKS
from ..blocks import ConvModule


def upsample_nearest(x: torch.Tensor, target_hw) -> torch.Tensor:
    """Nearest upsample of NCHW ``x`` to ``target_hw``: source index
    ``floor(i * h / th)`` in integers, as the JAX package does."""
    h, w = x.shape[-2:]
    th, tw = target_hw
    rows = torch.arange(th, device=x.device) * h // th
    cols = torch.arange(tw, device=x.device) * w // tw
    return x.index_select(-2, rows).index_select(-1, cols)


@NECKS.register_module()
class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 5,
                 start_level: int = 0, end_level: int = -1,
                 add_extra_convs: Union[bool, str] = False,
                 relu_before_extra_convs: bool = False,
                 no_norm_on_lateral: bool = False,
                 upsample_cfg: Optional[dict] = None,
                 norm_cfg: Optional[dict] = None,
                 act_cfg: Optional[dict] = None,
                 init_cfg: Optional[dict] = None):
        super().__init__()
        if add_extra_convs is True:
            add_extra_convs = 'on_input'
        if add_extra_convs not in (False, 'on_input', 'on_lateral',
                                   'on_output'):
            raise ValueError(f'add_extra_convs={add_extra_convs!r}')
        self.add_extra_convs = add_extra_convs
        self.in_channels = list(in_channels)
        self.num_outs = num_outs
        self.start_level = start_level
        self.end = len(in_channels) if end_level in (-1, None) \
            else end_level + 1
        self.relu_before_extra_convs = relu_before_extra_convs
        used = self.in_channels[start_level:self.end]
        self.lateral_convs = nn.ModuleList(
            ConvModule(c, out_channels, 1) for c in used)
        convs = [ConvModule(out_channels, out_channels, 3, padding=1)
                 for _ in used]
        if self.add_extra_convs:
            for k in range(num_outs - len(used)):
                cin = used[-1] if k == 0 and add_extra_convs == 'on_input' \
                    else out_channels
                convs.append(ConvModule(cin, out_channels, 3, 2, 1))
        self.fpn_convs = nn.ModuleList(convs)

    def forward(self, inputs):
        if len(inputs) != len(self.in_channels):
            raise ValueError(f'{len(inputs)} inputs for '
                             f'{len(self.in_channels)} in_channels')
        used = list(inputs[self.start_level:self.end])
        n_lat = len(used)
        laterals = [conv(x) for conv, x in zip(self.lateral_convs, used)]
        for i in range(n_lat - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + upsample_nearest(
                laterals[i], laterals[i - 1].shape[-2:])
        outs = [self.fpn_convs[i](laterals[i]) for i in range(n_lat)]
        if not self.add_extra_convs:
            for _ in range(self.num_outs - n_lat):
                outs.append(outs[-1][:, :, ::2, ::2])
            return tuple(outs)
        src = {'on_input': used[-1], 'on_lateral': laterals[-1],
               'on_output': outs[-1]}[self.add_extra_convs]
        for k in range(self.num_outs - n_lat):
            if k > 0 and self.relu_before_extra_convs:
                src = F.relu(src)
            src = self.fpn_convs[n_lat + k](src)
            outs.append(src)
        return tuple(outs)
