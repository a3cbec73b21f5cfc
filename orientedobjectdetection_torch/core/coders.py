"""Rotated box coders (counterparts of
``orientedobjectdetection_tpu/core/coders.py``): ``DeltaXYWHAOBBoxCoder``
(reference ``core/bbox/coder/delta_xywha_rbbox_coder.py:111-283``),
Oriented R-CNN's ``MidpointOffsetCoder`` (reference
``delta_midpointoffset_rbbox_coder.py:13-232``), FCOS's
``DistanceAnglePointCoder`` (``distance_angle_point_coder.py:10-111``) and
the CSL angle coder ``CSLCoder`` (``angle_coder.py:11-114``), and for the
horizontal-proposal detectors mmdet's ``DeltaXYWHBBoxCoder``,
``DeltaXYWHAHBBoxCoder`` (``delta_xywha_hbbox_coder.py``) and Gliding
Vertex's ``GVFixCoder`` / ``GVRatioCoder`` (``gliding_vertex_coder.py``).
Element-wise over leading dims."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from ..ops.boxes import PI, norm_angle, obb2poly
from ..utils.registry import BBOX_CODERS
from .anchors import cached


def _stats_on(cache: dict, means, stds, like: torch.Tensor):
    """(means, stds) as tensors on ``like``'s device and dtype, kept in
    ``cache``: made once per device and dtype, because a copy from the host
    waits for the device, and the train step's targets should not."""
    return cached(cache, (like.device, like.dtype),
                  lambda: (like.new_tensor(means), like.new_tensor(stds)))


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
class DeltaXYWHAHBBoxCoder(DeltaXYWHAOBBoxCoder):
    """Horizontal rois (theta-0 rotated boxes) -> rotated boxes (reference
    ``delta_xywha_hbbox_coder.py``): the OBB coder's arithmetic with the
    roi angle 0, as the JAX package's subclass."""


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


@BBOX_CODERS.register_module()
class DistanceAnglePointCoder:
    """Point coder: ``(l, t, r, b, theta)``, the distances from a point to
    the box's four sides in the box's rotated frame, and its angle."""

    encode_size = 5

    def __init__(self, angle_range: str = 'le90'):
        self.angle_range = angle_range

    def encode(self, points: torch.Tensor, gt_bboxes: torch.Tensor,
               max_dis: Optional[float] = None, eps: float = 0.1
               ) -> torch.Tensor:
        """points (..., 2) and gt_bboxes (..., 5) -> (..., 5)."""
        gx, gy, gw, gh, ga = gt_bboxes.unbind(-1)
        cos_a, sin_a = torch.cos(ga), torch.sin(ga)
        dx = points[..., 0] - gx
        dy = points[..., 1] - gy
        ox = dx * cos_a + dy * sin_a
        oy = -dx * sin_a + dy * cos_a
        out = torch.stack([gw * 0.5 + ox, gh * 0.5 + oy, gw * 0.5 - ox,
                           gh * 0.5 - oy, ga], -1)
        if max_dis is not None:
            out = torch.cat([out[..., :4].clamp(0, max_dis - eps),
                             out[..., 4:]], -1)
        return out

    def decode(self, points: torch.Tensor, pred: torch.Tensor,
               max_shape=None) -> torch.Tensor:
        """points (..., 2) and pred (..., 5) ``(l, t, r, b, theta)`` ->
        (..., 5) boxes, the angle normalized to ``angle_range`` and the
        centre clipped to ``max_shape`` (h, w) when given."""
        left, top, right, bottom, a = pred.unbind(-1)
        cos_a, sin_a = torch.cos(a), torch.sin(a)
        ox = (right - left) * 0.5
        oy = (bottom - top) * 0.5
        cx = points[..., 0] + ox * cos_a - oy * sin_a
        cy = points[..., 1] + ox * sin_a + oy * cos_a
        if max_shape is not None:
            cx = cx.clamp(0, max_shape[1] - 1)
            cy = cy.clamp(0, max_shape[0] - 1)
        return torch.stack([cx, cy, left + right, top + bottom,
                            norm_angle(a, self.angle_range)], -1)


@BBOX_CODERS.register_module()
class CSLCoder:
    """Circular Smooth Label angle coder: ``omega``-degree bins over the
    version's span (90 degrees for ``oc``, else 180), smoothed by a
    circular ``gaussian``, ``triangle``, ``rect`` or ``pulse`` window of
    ``radius`` bins. ``decode`` is the argmax bin's centre, the lowest bin
    winning a tie."""

    _OFFSET = {'oc': 0, 'le90': 90, 'le135': 45}

    def __init__(self, angle_version: str = 'le90', omega: int = 1,
                 window: str = 'gaussian', radius: float = 6):
        if angle_version not in self._OFFSET:
            raise ValueError(f'angle_version {angle_version!r}')
        if window not in ('gaussian', 'triangle', 'rect', 'pulse'):
            raise ValueError(f'window {window!r}')
        self.angle_version = angle_version
        self.omega = omega
        self.window = window
        self.radius = radius
        self.angle_range = 90 if angle_version == 'oc' else 180
        self.angle_offset = self._OFFSET[angle_version]
        self.coding_len = self.angle_range // omega

    @property
    def encode_size(self) -> int:
        return self.coding_len

    def encode(self, angle_targets: torch.Tensor) -> torch.Tensor:
        """(..., 1) radians -> (..., coding_len) smooth labels."""
        deg = angle_targets[..., 0] * (180 / PI) + self.angle_offset
        bin_ctr = deg / self.omega
        idx = torch.arange(self.coding_len, dtype=torch.float32,
                           device=angle_targets.device)
        diff = (idx - bin_ctr[..., None]).abs()
        diff = torch.minimum(diff, self.coding_len - diff)
        if self.window == 'gaussian':
            return torch.exp(-(diff ** 2) / (2 * self.radius ** 2))
        if self.window == 'triangle':
            return (1 - diff / self.radius).clamp(min=0)
        if self.window == 'rect':
            return (diff <= self.radius).float()
        return (diff < 0.5).float()

    def decode(self, angle_preds: torch.Tensor) -> torch.Tensor:
        """(..., coding_len) logits or scores -> (...) radians."""
        idx = angle_preds.argmax(-1).float()
        deg = idx * self.omega + self.omega / 2 - self.angle_offset
        return deg * (PI / 180)


@BBOX_CODERS.register_module()
class DeltaXYWHBBoxCoder:
    """mmdet's 4-parameter axis-aligned delta coder over xyxy boxes, for
    the horizontal-proposal RPN (Gliding Vertex, Rotated Faster R-CNN, RoI
    Transformer) and the Gliding Vertex box branch. ``decode`` clips the
    corners to ``max_shape`` (h, w) when given."""

    encode_size = 4

    def __init__(self, target_means: Sequence[float] = (0., 0., 0., 0.),
                 target_stds: Sequence[float] = (1., 1., 1., 1.)):
        self.means = tuple(float(m) for m in target_means)
        self.stds = tuple(float(s) for s in target_stds)
        self._stats_cache = {}

    def _stats(self, like: torch.Tensor):
        return _stats_on(self._stats_cache, self.means, self.stds, like)

    def encode(self, bboxes: torch.Tensor,
               gt_bboxes: torch.Tensor) -> torch.Tensor:
        """bboxes, gt_bboxes (..., 4) xyxy -> deltas (..., 4)."""
        px = (bboxes[..., 0] + bboxes[..., 2]) * 0.5
        py = (bboxes[..., 1] + bboxes[..., 3]) * 0.5
        pw = bboxes[..., 2] - bboxes[..., 0]
        ph = bboxes[..., 3] - bboxes[..., 1]
        gx = (gt_bboxes[..., 0] + gt_bboxes[..., 2]) * 0.5
        gy = (gt_bboxes[..., 1] + gt_bboxes[..., 3]) * 0.5
        gw = gt_bboxes[..., 2] - gt_bboxes[..., 0]
        gh = gt_bboxes[..., 3] - gt_bboxes[..., 1]
        deltas = torch.stack([(gx - px) / pw, (gy - py) / ph,
                              torch.log(gw / pw), torch.log(gh / ph)], -1)
        means, stds = self._stats(deltas)
        return (deltas - means) / stds

    def decode(self, bboxes: torch.Tensor, pred: torch.Tensor,
               max_shape=None, wh_ratio_clip: float = 16 / 1000
               ) -> torch.Tensor:
        """bboxes (..., 4) xyxy; pred (..., 4) -> xyxy boxes (..., 4)."""
        means, stds = self._stats(pred)
        dx, dy, dw, dh = (pred * stds + means).unbind(-1)
        px = (bboxes[..., 0] + bboxes[..., 2]) * 0.5
        py = (bboxes[..., 1] + bboxes[..., 3]) * 0.5
        pw = bboxes[..., 2] - bboxes[..., 0]
        ph = bboxes[..., 3] - bboxes[..., 1]
        max_ratio = abs(math.log(wh_ratio_clip))
        gx = px + pw * dx
        gy = py + ph * dy
        gw = pw * torch.exp(dw.clamp(-max_ratio, max_ratio))
        gh = ph * torch.exp(dh.clamp(-max_ratio, max_ratio))
        x1, y1 = gx - gw / 2, gy - gh / 2
        x2, y2 = gx + gw / 2, gy + gh / 2
        if max_shape is not None:
            x1, x2 = x1.clamp(0, max_shape[1]), x2.clamp(0, max_shape[1])
            y1, y2 = y1.clamp(0, max_shape[0]), y2.clamp(0, max_shape[0])
        return torch.stack([x1, y1, x2, y2], -1)


def _edge_vertices(gt_obbs: torch.Tensor, version: str):
    """The gts' corner points (..., 4, 2) and the bounds of their
    circumscribed box."""
    pts = obb2poly(gt_obbs, version).reshape(gt_obbs.shape[:-1] + (4, 2))
    xs, ys = pts[..., 0], pts[..., 1]
    return xs, ys, xs.amin(-1), xs.amax(-1), ys.amin(-1), ys.amax(-1)


@BBOX_CODERS.register_module()
class GVFixCoder:
    """Gliding Vertex (reference ``gliding_vertex_coder.py``): a gt as the
    four gliding offsets of its vertices along the edges of its
    circumscribed box, each as a fraction of that edge: the top vertex's
    from the left end, the right's from the top, the bottom's from the
    right, the left's from the bottom. The vertex on an edge is the first
    of the corners at that extreme (an axis-aligned gt has two there), as
    ``jnp.argmin`` / ``argmax`` pick it."""

    encode_size = 4

    def __init__(self, angle_range: str = 'le90'):
        self.version = angle_range

    def encode(self, gt_obbs: torch.Tensor) -> torch.Tensor:
        """gt_obbs (..., 5) -> gliding offsets (..., 4)."""
        xs, ys, xmin, xmax, ymin, ymax = _edge_vertices(gt_obbs,
                                                        self.version)
        w = (xmax - xmin).clamp(min=1e-6)
        h = (ymax - ymin).clamp(min=1e-6)

        def at(v, idx):
            return v.gather(-1, idx[..., None])[..., 0]

        return torch.stack([(at(xs, ys.argmin(-1)) - xmin) / w,
                            (at(ys, xs.argmax(-1)) - ymin) / h,
                            (xmax - at(xs, ys.argmax(-1))) / w,
                            (ymax - at(ys, xs.argmin(-1))) / h], -1)

    def decode(self, hbbs: torch.Tensor,
               fix_deltas: torch.Tensor) -> torch.Tensor:
        """hbbs (..., 4) xyxy and offsets (..., 4) -> polygons (..., 8)."""
        x1, y1, x2, y2 = hbbs.unbind(-1)
        w, h = x2 - x1, y2 - y1
        dt, dr, db, dl = fix_deltas.unbind(-1)
        return torch.stack([x1 + w * dt, y1, x2, y1 + h * dr,
                            x2 - w * db, y2, x1, y2 - h * dl], -1)


@BBOX_CODERS.register_module()
class GVRatioCoder:
    """Gliding Vertex's rectangularity: the gt's area over that of its
    circumscribed box, (..., 1)."""

    encode_size = 1

    def __init__(self, angle_range: str = 'le90'):
        self.version = angle_range

    def encode(self, gt_obbs: torch.Tensor) -> torch.Tensor:
        _, _, xmin, xmax, ymin, ymax = _edge_vertices(gt_obbs, self.version)
        hbb_area = (xmax - xmin) * (ymax - ymin)
        obb_area = gt_obbs[..., 2] * gt_obbs[..., 3]
        return (obb_area / hbb_area.clamp(min=1e-6))[..., None]
