"""Rotated box coders (counterparts of
``orientedobjectdetection_tpu/core/coders.py``): ``DeltaXYWHAOBBoxCoder``
(reference ``core/bbox/coder/delta_xywha_rbbox_coder.py:111-283``) and
Oriented R-CNN's ``MidpointOffsetCoder`` (reference
``delta_midpointoffset_rbbox_coder.py:13-232``). Element-wise over leading
dims."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from ..ops.boxes import PI, norm_angle, obb2poly
from ..utils.registry import BBOX_CODERS


def _stats_on(cache: dict, means, stds, like: torch.Tensor):
    """(means, stds) as tensors on ``like``'s device and dtype, kept in
    ``cache``: made once per device and dtype, because a copy from the host
    waits for the device, and the train step's targets should not."""
    key = (like.device, like.dtype)
    if key not in cache:
        cache[key] = (like.new_tensor(means), like.new_tensor(stds))
    return cache[key]


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
        self._stats_cache = {}
        self.angle_range = angle_range
        self.norm_factor = norm_factor
        self.edge_swap = edge_swap
        self.proj_xy = proj_xy
        self.add_ctr_clamp = add_ctr_clamp
        self.ctr_clamp = ctr_clamp

    def _stats(self, like: torch.Tensor):
        return _stats_on(self._stats_cache, self.means, self.stds, like)

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


@BBOX_CODERS.register_module()
class MidpointOffsetCoder:
    """Oriented R-CNN's 6-parameter midpoint-offset encoding against
    horizontal (xyxy) proposals: the gt's circumscribed HBB as
    (dx, dy, dw, dh), plus the normalized offsets (da, db) of the polygon's
    top-most and right-most vertices along the HBB's top and right edges."""

    encode_size = 6

    def __init__(self,
                 target_means: Sequence[float] = (0., 0., 0., 0., 0., 0.),
                 target_stds: Sequence[float] = (1., 1., 1., 1., 1., 1.),
                 angle_range: str = 'le90'):
        self.means = tuple(float(m) for m in target_means)
        self.stds = tuple(float(s) for s in target_stds)
        self._stats_cache = {}
        self.version = angle_range

    def _stats(self, like: torch.Tensor):
        return _stats_on(self._stats_cache, self.means, self.stds, like)

    def encode(self, hbb_proposals: torch.Tensor,
               gt_obbs: torch.Tensor) -> torch.Tensor:
        """hbb_proposals (..., 4) xyxy; gt_obbs (..., 5) -> (..., 6)."""
        px = (hbb_proposals[..., 0] + hbb_proposals[..., 2]) * 0.5
        py = (hbb_proposals[..., 1] + hbb_proposals[..., 3]) * 0.5
        pw = hbb_proposals[..., 2] - hbb_proposals[..., 0]
        ph = hbb_proposals[..., 3] - hbb_proposals[..., 1]

        polys = obb2poly(gt_obbs, self.version)
        pts = polys.reshape(polys.shape[:-1] + (4, 2))
        xs, ys = pts[..., 0], pts[..., 1]
        gx_min, gx_max = xs.amin(-1), xs.amax(-1)
        gy_min, gy_max = ys.amin(-1), ys.amax(-1)
        gx = (gx_min + gx_max) * 0.5
        gy = (gy_min + gy_max) * 0.5
        gw = gx_max - gx_min
        gh = gy_max - gy_min

        # x of the top-most vertex (min y), y of the right-most (max x);
        # the first of equal vertices, as jnp.argmin / argmax
        x_top = xs.gather(-1, ys.argmin(-1, keepdim=True))[..., 0]
        y_right = ys.gather(-1, xs.argmax(-1, keepdim=True))[..., 0]
        da = (x_top - gx) / gw.clamp(min=1e-6)
        db = (y_right - gy) / gh.clamp(min=1e-6)

        deltas = torch.stack([(gx - px) / pw, (gy - py) / ph,
                              torch.log(gw / pw), torch.log(gh / ph),
                              da, db], -1)
        means, stds = self._stats(deltas)
        return (deltas - means) / stds

    def decode(self, hbb_proposals: torch.Tensor, pred_deltas: torch.Tensor,
               max_shape=None, wh_ratio_clip: float = 16 / 1000
               ) -> torch.Tensor:
        """hbb_proposals (..., 4) xyxy; pred_deltas (..., 6) -> (..., 5)."""
        means, stds = self._stats(pred_deltas)
        dx, dy, dw, dh, da, db = (pred_deltas * stds + means).unbind(-1)
        px = (hbb_proposals[..., 0] + hbb_proposals[..., 2]) * 0.5
        py = (hbb_proposals[..., 1] + hbb_proposals[..., 3]) * 0.5
        pw = hbb_proposals[..., 2] - hbb_proposals[..., 0]
        ph = hbb_proposals[..., 3] - hbb_proposals[..., 1]
        max_ratio = abs(math.log(wh_ratio_clip))
        dw = dw.clamp(-max_ratio, max_ratio)
        dh = dh.clamp(-max_ratio, max_ratio)
        gx = px + pw * dx
        gy = py + ph * dy
        gw = pw * torch.exp(dw)
        gh = ph * torch.exp(dh)
        da = da.clamp(-0.5, 0.5)
        db = db.clamp(-0.5, 0.5)
        if max_shape is not None:
            gx = gx.clamp(0, max_shape[1] - 1)
            gy = gy.clamp(0, max_shape[0] - 1)
        # the midpoint-offset parallelogram: top (gx + da*gw, gy - gh/2),
        # right (gx + gw/2, gy + db*gh) and their reflections, then the
        # closest rectangle
        polys = torch.stack([gx + da * gw, gy - gh * 0.5,
                             gx + gw * 0.5, gy + db * gh,
                             gx - da * gw, gy + gh * 0.5,
                             gx - gw * 0.5, gy - db * gh], -1)
        obbs = poly2obb_from_parallelogram(polys)
        return torch.cat([obbs[..., :4],
                          norm_angle(obbs[..., 4:5], self.version)], -1)


def poly2obb_from_parallelogram(polys: torch.Tensor) -> torch.Tensor:
    """(..., 8) parallelogram (midpoint-offset vertices) -> (..., 5)
    rectangle, the Oriented R-CNN way: the shorter diagonal is extended to
    the longer one's length; the four half-diagonal end points (equal
    diagonals that bisect each other) form the rectangle, read out edge-wise
    with the long edge as w."""
    pts = polys.reshape(polys.shape[:-1] + (4, 2))
    ctr = pts.mean(-2)
    u = (pts[..., 0, :] - pts[..., 2, :]) * 0.5   # half-diagonal top->bottom
    v = (pts[..., 1, :] - pts[..., 3, :]) * 0.5   # half-diagonal right->left
    lu = torch.linalg.vector_norm(u, dim=-1, keepdim=True)
    lv = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    longest = torch.maximum(lu, lv)
    u2 = u * (longest / lu.clamp(min=1e-6))
    v2 = v * (longest / lv.clamp(min=1e-6))
    e1 = (ctr + v2) - (ctr + u2)
    e2 = (ctr - u2) - (ctr + v2)
    l1 = torch.linalg.vector_norm(e1, dim=-1)
    l2 = torch.linalg.vector_norm(e2, dim=-1)
    long_edge = torch.where((l1 >= l2)[..., None], e1, e2)
    ang = torch.atan2(long_edge[..., 1], long_edge[..., 0])
    return torch.stack([ctr[..., 0], ctr[..., 1], torch.maximum(l1, l2),
                        torch.minimum(l1, l2), ang], -1)
