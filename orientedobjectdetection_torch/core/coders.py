"""Rotated box coder (counterpart of
``orientedobjectdetection_tpu/core/coders.py:DeltaXYWHAOBBoxCoder``,
reference ``core/bbox/coder/delta_xywha_rbbox_coder.py:111-283``).
Element-wise over leading dims."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from ..ops.boxes import PI, norm_angle
from ..utils.registry import BBOX_CODERS


@BBOX_CODERS.register_module()
class DeltaXYWHAOBBoxCoder:
    """(cx,cy,w,h,a) <-> (dx,dy,dw,dh,da).

    ``proj_xy`` projects the center offset into the anchor's rotated frame;
    ``edge_swap`` picks the gt (w,h,angle) representation closest in angle to
    the anchor; ``norm_factor`` divides the angle delta by
    ``norm_factor * pi``."""

    encode_size = 5

    def __init__(self,
                 target_means: Sequence[float] = (0., 0., 0., 0., 0.),
                 target_stds: Sequence[float] = (1., 1., 1., 1., 1.),
                 angle_range: str = 'oc',
                 norm_factor: Optional[float] = None,
                 edge_swap: bool = False,
                 proj_xy: bool = False,
                 add_ctr_clamp: bool = False,
                 ctr_clamp: int = 32):
        if angle_range not in ('oc', 'le90', 'le135'):
            raise ValueError(f'unknown angle_range {angle_range!r}')
        self.means = tuple(float(m) for m in target_means)
        self.stds = tuple(float(s) for s in target_stds)
        self.angle_range = angle_range
        self.norm_factor = norm_factor
        self.edge_swap = edge_swap
        self.proj_xy = proj_xy
        self.add_ctr_clamp = add_ctr_clamp
        self.ctr_clamp = ctr_clamp

    def _stats(self, like: torch.Tensor):
        return (like.new_tensor(self.means), like.new_tensor(self.stds))

    def encode(self, bboxes: torch.Tensor,
               gt_bboxes: torch.Tensor) -> torch.Tensor:
        px, py, pw, ph, pa = bboxes.unbind(-1)
        gx, gy, gw, gh, ga = gt_bboxes.unbind(-1)
        if self.proj_xy:
            dx = (torch.cos(pa) * (gx - px) + torch.sin(pa) * (gy - py)) / pw
            dy = (-torch.sin(pa) * (gx - px) + torch.cos(pa) * (gy - py)) / ph
        else:
            dx = (gx - px) / pw
            dy = (gy - py) / ph
        if self.edge_swap:
            dtheta1 = norm_angle(ga - pa, self.angle_range)
            dtheta2 = norm_angle(ga - pa + PI / 2, self.angle_range)
            take1 = dtheta1.abs() < dtheta2.abs()
            gw_r = torch.where(take1, gw, gh)
            gh_r = torch.where(take1, gh, gw)
            da = torch.where(take1, dtheta1, dtheta2)
            dw = torch.log(gw_r / pw)
            dh = torch.log(gh_r / ph)
        else:
            da = norm_angle(ga - pa, self.angle_range)
            dw = torch.log(gw / pw)
            dh = torch.log(gh / ph)
        if self.norm_factor:
            da = da / (self.norm_factor * PI)
        deltas = torch.stack([dx, dy, dw, dh, da], -1)
        means, stds = self._stats(deltas)
        return (deltas - means) / stds

    def decode(self, bboxes: torch.Tensor, pred_deltas: torch.Tensor,
               max_shape=None, wh_ratio_clip: float = 16 / 1000
               ) -> torch.Tensor:
        means, stds = self._stats(pred_deltas)
        dx, dy, dw, dh, da = (pred_deltas * stds + means).unbind(-1)
        if self.norm_factor:
            da = da * self.norm_factor * PI
        px, py, pw, ph, pa = bboxes.unbind(-1)
        max_ratio = abs(math.log(wh_ratio_clip))
        if self.add_ctr_clamp:
            dx_w = torch.clamp(pw * dx, -self.ctr_clamp, self.ctr_clamp)
            dy_h = torch.clamp(ph * dy, -self.ctr_clamp, self.ctr_clamp)
            dw = torch.clamp(dw, max=max_ratio)
            dh = torch.clamp(dh, max=max_ratio)
        else:
            dx_w = pw * dx
            dy_h = ph * dy
            dw = torch.clamp(dw, -max_ratio, max_ratio)
            dh = torch.clamp(dh, -max_ratio, max_ratio)
        gw = pw * torch.exp(dw)
        gh = ph * torch.exp(dh)
        if self.proj_xy:
            gx = dx * pw * torch.cos(pa) - dy * ph * torch.sin(pa) + px
            gy = dx * pw * torch.sin(pa) + dy * ph * torch.cos(pa) + py
        else:
            gx = px + dx_w
            gy = py + dy_h
        ga = norm_angle(pa + da, self.angle_range)
        if max_shape is not None:
            gx = torch.clamp(gx, 0, max_shape[1] - 1)
            gy = torch.clamp(gy, 0, max_shape[0] - 1)
        if self.edge_swap:
            long_first = gw > gh
            w_r = torch.where(long_first, gw, gh)
            h_r = torch.where(long_first, gh, gw)
            a_r = norm_angle(torch.where(long_first, ga, ga + PI / 2),
                             self.angle_range)
            return torch.stack([gx, gy, w_r, h_r, a_r], -1)
        return torch.stack([gx, gy, gw, gh, ga], -1)
