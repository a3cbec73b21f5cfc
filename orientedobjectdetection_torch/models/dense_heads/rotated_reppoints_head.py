"""The point-set heads: Rotated RepPoints (with CFA's reassignment),
Oriented RepPoints, SASM and G-RepPoints (counterpart of
``orientedobjectdetection_tpu/models/dense_heads/rotated_reppoints_head.py``;
reference ``rotated_reppoints_head.py``, ``oriented_reppoints_head.py``,
``sam_reppoints_head.py`` and ``configs/g_reppoints``).

Each location predicts 9 points in two stages: ``pts_init`` from the
regression tower, then a refinement from the tower's features sampled at
those points (a deformable convolution: ``ops.feature_align
.deform_conv_sample``, then the ``(C, C, 3, 3)`` weight and a bias), and
class scores from the classification tower sampled at the same points.
The sampling offset of tap t is point t itself (tap t reads ``grid_t +
p_t``), as in the JAX package. Point outputs are ``(dy, dx)`` pairs in
cells of the level's stride, relative to the location.

Targets and losses are batched over images with no data-dependent shape
and no wait for the host: the assigners take (B, N, G) matrices, the
reference's per-(gt, level) top-k loops are ranks within groups
(:func:`rank_in_group`, a stable lexicographic sort), and the convex IoU is
chunked (``ops.points.convex_iou``). Every tie goes to the lowest index, as
``jax.lax.top_k`` and the stable ``jnp`` sorts give it. Geometry (hulls,
clips, Gaussians, chamfer distances) runs in float32 whatever the
autocast: the loss casts the outputs first.

``torch.profiler`` ranges: ``reppoints.towers`` (the two towers and the
initial points), ``reppoints.sample`` (each deformable sampling),
``reppoints.heads`` (the deformable projections and the output
convolutions), ``reppoints.targets`` (assignment and selection, under
``torch.no_grad``), ``reppoints.loss`` and ``reppoints.decode_nms``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from ...core.anchors import MlvlPointGenerator, cached
from ...core.assigners import (_nan_mean_std_unbiased, SASAssigner,
                               level_candidates)
from ...core.gmm import gmm_fit
from ...ops.boxes import gaussian2bbox, gt2gaussian_poly, obb2poly, poly2obb
from ...ops.feature_align import deform_conv_sample
from ...ops.nms import multiclass_nms_rotated, topk_candidates
from ...ops.points import (_norm2, _sum, chamfer_distance, convex_giou,
                           convex_iou, min_area_polygons, points_in_polygons)
from ...utils.registry import BBOX_ASSIGNERS, HEADS, LOSSES
from ..losses.common import _one_hot, reduce_loss, sigmoid_focal_loss
from .rotated_anchor_head import check_exact_topk
from .rotated_fcos_head import ConvGN


# ---- assigners --------------------------------------------------------------
@BBOX_ASSIGNERS.register_module()
class ConvexAssigner:
    """Scale-matched nearest-point assignment (reference
    ``assigners/convex_assigner.py``), batched: each gt goes to the level
    ``(log2(w / scale) + log2(h / scale)) / 2`` (truncated, clipped to the
    levels) of its horizontal box, and claims the ``pos_num`` points of that
    level nearest its centre in units of its width and height (the lowest
    index on a tie); a point claimed by several gts goes to the nearest,
    the lowest index on a tie."""

    def __init__(self, scale: float = 4, pos_num: int = 3):
        self.scale = scale
        self.pos_num = pos_num

    @torch.no_grad()
    def __call__(self, points_xy, points_lvl, gt_polys, gt_labels, gt_mask,
                 num_classes: int):
        """points_xy (N, 2); points_lvl (N,) int; gt_polys (B, G, 8),
        gt_labels and gt_mask (B, G). Returns the nearest claiming gt (B,
        N), the positives (B, N) and the labels (``num_classes`` where not
        positive)."""
        xs, ys = gt_polys[..., 0::2], gt_polys[..., 1::2]
        x_lo, x_hi = xs.amin(-1), xs.amax(-1)
        y_lo, y_hi = ys.amin(-1), ys.amax(-1)
        cx, cy = (x_lo + x_hi) / 2, (y_lo + y_hi) / 2
        w = torch.clamp(x_hi - x_lo, min=1e-6)
        h = torch.clamp(y_hi - y_lo, min=1e-6)
        gt_lvl = ((torch.log2(w / self.scale) + torch.log2(h / self.scale))
                  / 2).to(torch.int32)
        gt_lvl = torch.clamp(gt_lvl, min=points_lvl.amin().to(torch.int32),
                             max=points_lvl.amax().to(torch.int32))
        dx = (points_xy[None, :, 0, None] - cx[:, None]) / w[:, None]
        dy = (points_xy[None, :, 1, None] - cy[:, None]) / h[:, None]
        dist = torch.sqrt(dx * dx + dy * dy)                   # (B, N, G)
        on_lvl = points_lvl[None, :, None] == gt_lvl[:, None]
        dist = torch.where(on_lvl & gt_mask[:, None], dist, float('inf'))
        top = torch.sort(dist, dim=1, stable=True).indices[:, :self.pos_num]
        claim = torch.zeros_like(dist, dtype=torch.bool).scatter_(1, top,
                                                                  True)
        cd = torch.where(claim & torch.isfinite(dist), dist, float('inf'))
        best = cd.argmin(-1)
        pos = torch.isfinite(cd.amin(-1))
        labels = torch.where(pos, gt_labels.long().gather(1, best),
                             num_classes)
        return best, pos, labels


@BBOX_ASSIGNERS.register_module()
class MaxConvexIoUAssigner:
    """MaxIoU assignment on convex-hull IoU (reference
    ``assigners/max_convex_iou_assigner.py``), batched: positive at or
    above ``pos_iou_thr`` to the argmax gt (lowest index on a tie),
    negative below ``neg_iou_thr``; each valid gt whose best IoU is at
    least ``min_pos_iou`` claims every point set at that IoU
    (``gt_max_assign_all``; else only the first), the highest claiming gt
    winning. Returns the whole (B, N, G) overlap matrix too (CFA reads
    it)."""

    def __init__(self, pos_iou_thr: float = 0.4, neg_iou_thr: float = 0.3,
                 min_pos_iou: float = 0.0, gt_max_assign_all: bool = True,
                 ignore_iof_thr: float = -1):
        self.pos_iou_thr = pos_iou_thr
        self.neg_iou_thr = neg_iou_thr
        self.min_pos_iou = min_pos_iou
        self.gt_max_assign_all = gt_max_assign_all

    @torch.no_grad()
    def __call__(self, pointsets, gt_polys, gt_labels, gt_mask,
                 num_classes: int):
        """pointsets (B, N, 2 P); gt_polys (B, G, 8). Returns (assigned gt,
        positives, negatives, labels, overlaps)."""
        overlaps = convex_iou(pointsets, gt_polys)             # (B, N, G)
        overlaps = torch.where(gt_mask[:, None], overlaps, 0.0)
        max_o = overlaps.amax(-1)
        arg = overlaps.argmax(-1)
        pos = max_o >= self.pos_iou_thr
        neg = max_o < self.neg_iou_thr
        gt_max = overlaps.amax(1)                              # (B, G)
        may_claim = (gt_max >= self.min_pos_iou) & gt_mask
        if self.gt_max_assign_all:
            claim = (overlaps == gt_max[:, None]) & may_claim[:, None]
        else:
            claim = torch.zeros_like(overlaps, dtype=torch.bool).scatter_(
                1, overlaps.argmax(1, keepdim=True), may_claim[:, None])
        gt_idx = torch.arange(overlaps.shape[-1], device=overlaps.device)
        claimed = torch.where(claim, gt_idx, -1).amax(-1)
        arg = torch.where(claimed >= 0, claimed, arg)
        pos = pos | (claimed >= 0)
        labels = torch.where(pos, gt_labels.long().gather(1, arg),
                             num_classes)
        return arg, pos, neg & ~pos, labels, overlaps


class ATSSKldPointsAssigner:
    """ATSS over point sets with a KLD quality (reference
    ``assigners/atss_kld_assigner.py:150-282``, G-RepPoints' refine
    stage), batched: quality ``1 / (2 + KL(fit(points) || gt))``
    (clamped at 1e-6), candidates the ``topk`` point sets a level whose
    mean point lies nearest the gt's horizontal-box centre, threshold the
    candidates' mean plus unbiased std, and a positive's mean point inside
    the gt polygon. The configs' ``ATSSKldAssigner`` maps here."""

    def __init__(self, topk: int = 9):
        self.topk = topk

    @torch.no_grad()
    def __call__(self, pointsets, num_level_points, gt_polys, gt_labels,
                 gt_mask, num_classes: int):
        b, n = pointsets.shape[:2]
        p = pointsets.reshape(b, n, -1, 2)
        _, mu_p, cov_p = gmm_fit(p, n_components=1, n_iter=2)
        mu_p, sp = mu_p[..., 0, :], cov_p[..., 0, :, :]       # (B, N, ...)
        mu_t, st = gt2gaussian_poly(gt_polys)                 # (B, G, ...)
        det_t = torch.clamp(st[..., 0, 0] * st[..., 1, 1] -
                            st[..., 0, 1] ** 2, min=1e-12)
        det_p = torch.clamp(sp[..., 0, 0] * sp[..., 1, 1] -
                            sp[..., 0, 1] ** 2, min=1e-12)
        i00 = (st[..., 1, 1] / det_t)[:, None]                # (B, 1, G)
        i01 = (-st[..., 0, 1] / det_t)[:, None]
        i11 = (st[..., 0, 0] / det_t)[:, None]
        dx = mu_p[:, :, None, 0] - mu_t[:, None, :, 0]        # (B, N, G)
        dy = mu_p[:, :, None, 1] - mu_t[:, None, :, 1]
        term1 = dx * (i00 * dx + i01 * dy) + dy * (i01 * dx + i11 * dy)
        tr = i00 * sp[:, :, None, 0, 0] + 2 * i01 * sp[:, :, None, 0, 1] + \
            i11 * sp[:, :, None, 1, 1]
        kld = 0.5 * (term1 + tr + torch.log(det_t)[:, None] -
                     torch.log(det_p)[:, :, None]) - 1.0
        overlaps = 1.0 / (2.0 + torch.clamp(kld, min=1e-6))
        valid = gt_mask[:, None]
        overlaps = torch.where(valid, overlaps, 0.0)

        xs, ys = gt_polys[..., 0::2], gt_polys[..., 1::2]
        gt_ctr = torch.stack([(xs.amin(-1) + xs.amax(-1)) / 2,
                              (ys.amin(-1) + ys.amax(-1)) / 2], -1)
        ctr = _sum(p, -2) / p.shape[-2]                       # (B, N, 2)
        dist = torch.where(valid, _norm2(ctr[:, :, None] - gt_ctr[:, None]),
                           1e9)
        is_cand = level_candidates(dist, num_level_points, self.topk)
        mean, std = _nan_mean_std_unbiased(
            torch.where(is_cand, overlaps, float('nan')), dim=1)
        inside = points_in_polygons(ctr, gt_polys)
        is_pos = is_cand & (overlaps >= (mean + std)[:, None]) & inside & \
            valid
        posq = torch.where(is_pos, overlaps, -1.0)
        pos = posq.amax(-1) > -1
        arg = posq.argmax(-1)
        labels = torch.where(pos, gt_labels.long().gather(1, arg),
                             num_classes)
        return arg, pos, ~pos, labels, overlaps


# ---- losses -----------------------------------------------------------------
@LOSSES.register_module()
class ConvexGIoULoss:
    """``1 - convex GIoU`` of predicted point sets (N, 2 P) against target
    polygons (N, 8) (reference ``losses/convex_giou_loss.py``)."""

    def __init__(self, reduction: str = 'mean', loss_weight: float = 1.0):
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred_pointsets, target_polys, weight=None,
                 avg_factor=None):
        loss = 1 - convex_giou(pred_pointsets, target_polys)
        return self.loss_weight * reduce_loss(loss, weight, self.reduction,
                                              avg_factor)


@LOSSES.register_module()
class BCConvexGIoULoss(ConvexGIoULoss):
    """Border-constrained convex GIoU (reference ``BCConvexGIoULoss``): the
    GIoU term plus ``0.1 x`` the L1 distance of the points outside the
    target polygon's axis-aligned bounds to those bounds, over the bounds'
    larger side (at least 1)."""

    def __call__(self, pred_pointsets, target_polys, weight=None,
                 avg_factor=None):
        giou = convex_giou(pred_pointsets, target_polys)
        pts = pred_pointsets.reshape(pred_pointsets.shape[:-1] + (-1, 2))
        poly = target_polys.reshape(target_polys.shape[:-1] + (-1, 2))
        lo = poly.amin(-2, keepdim=True)
        hi = poly.amax(-2, keepdim=True)
        zero = pts.new_zeros(())
        border = (torch.maximum(lo - pts, zero) +
                  torch.maximum(pts - hi, zero)).sum((-1, -2))
        scale = torch.clamp((hi - lo).amax((-1, -2)), min=1.0)
        loss = (1 - giou) + 0.1 * border / scale
        return self.loss_weight * reduce_loss(loss, weight, self.reduction,
                                              avg_factor)


# ---- selection --------------------------------------------------------------
def rank_in_group(group_id, quality, valid, num_groups: int):
    """Ascending-quality rank of each element within its group, (B, N)
    each: one stable lexicographic sort (group, then quality, then index)
    and a segmented offset. Elements not ``valid`` rank N."""
    n = group_id.shape[-1]
    q = torch.where(valid, quality, float('inf'))
    gid = torch.where(valid, group_id, num_groups)
    by_q = torch.sort(q, dim=-1, stable=True).indices
    by_g = torch.sort(gid.gather(-1, by_q), dim=-1, stable=True).indices
    order = by_q.gather(-1, by_g)
    g_sorted = gid.gather(-1, order)
    pos = torch.arange(n, device=gid.device).expand_as(gid)
    is_start = torch.ones_like(valid)
    is_start[..., 1:] = g_sorted[..., 1:] != g_sorted[..., :-1]
    start_pos = torch.cummax(torch.where(is_start, pos, 0), dim=-1).values
    rank = torch.empty_like(pos).scatter_(-1, order, pos - start_pos)
    return torch.where(valid, rank, n)


def sampling_edge_points(polys, points_num: int = 10):
    """(..., 8) polygons -> (..., 4 points_num, 2) points spaced evenly along
    each edge, both ends included (reference
    ``oriented_reppoints_head.py:329-368``): at ``t = i / (points_num - 1)``,
    a float32 quotient, the same on every device, made on the polygons'
    device (no copy from the host, which would wait for it)."""
    p = polys.reshape(polys.shape[:-1] + (4, 2))
    nxt = torch.roll(p, -1, dims=-2)
    t = torch.arange(points_num, dtype=torch.float32,
                     device=polys.device) / (points_num - 1)
    pts = p[..., :, None, :] * (1 - t)[:, None] + \
        nxt[..., :, None, :] * t[:, None]
    return pts.reshape(polys.shape[:-1] + (4 * points_num, 2))


def chamfer_quality(polys_a, polys_b, distance_weight: float = 0.05,
                    points_num: int = 10):
    """Chamfer distance between edge-sampled polygons (reference
    ``ChamferDistance2D``), times ``distance_weight``, both ways averaged."""
    d1, d2 = chamfer_distance(sampling_edge_points(polys_a, points_num),
                              sampling_edge_points(polys_b, points_num))
    return distance_weight * (d1 + d2) / 2.0


def _focal_elementwise(logits, labels, num_classes: int,
                       gamma: float = 2.0, alpha: float = 0.25):
    """Per-element sigmoid focal loss summed over the classes (the
    reference's ``reduction_override='none'`` quality term); a label of
    ``num_classes`` is background."""
    onehot = _one_hot(labels, num_classes, logits.dtype)
    return sigmoid_focal_loss(logits, onehot, gamma, alpha).sum(-1)


# ---- heads ------------------------------------------------------------------
class DeformConv2d(nn.Conv2d):
    """mmcv's ``DeformConv2d`` as the JAX package computes it: the
    ``kernel_size``^2 taps of each location sampled at their offsets
    (:meth:`sample`), then the ``(out, in, k, k)`` weight and a bias
    (:meth:`project`; tap ``(ky, kx)`` meets ``weight[:, :, ky, kx]``). The
    JAX projection is a biased ``nn.Dense``; mmcv's has no bias."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3):
        super().__init__(in_channels, out_channels, kernel_size,
                         padding=kernel_size // 2)

    def sample(self, x, offsets):
        return deform_conv_sample(x, offsets, self.kernel_size[0])

    def project(self, taps, dtype):
        """float32 taps (B, C, k*k, H, W) -> (B, out, H, W) in ``dtype``."""
        b, _, _, h, w = taps.shape
        out = torch.matmul(self.weight.reshape(self.out_channels, -1),
                           taps.to(dtype).reshape(b, -1, h * w))
        out = out + self.bias.to(out.dtype)[:, None]
        return out.reshape(b, -1, h, w)

    def forward(self, x, offsets):
        return self.project(self.sample(x, offsets), x.dtype)


@HEADS.register_module()
class RotatedRepPointsHead(nn.Module):
    """Rotated RepPoints; ``use_reassign=True`` is CFA's convex-hull
    feature-adaption reassignment (reference
    ``rotated_reppoints_head.py:552-1000``). ``forward`` returns
    (cls_scores, pts_inits, pts_refines), per-level NCHW maps (C, 2 P and 2 P
    channels). The towers are ``stacked_convs`` 3x3 convolutions with a
    bias, each followed by GroupNorm(32, eps 1e-6) in float32 and a ReLU,
    whatever ``norm_cfg`` says (as in the JAX package)."""

    with_poc = False
    default_init_loss = dict(type='ConvexGIoULoss', loss_weight=0.375)
    default_refine_loss = dict(type='ConvexGIoULoss', loss_weight=1.0)

    def __init__(self, num_classes: int = 15, in_channels: int = 256,
                 feat_channels: int = 256, point_feat_channels: int = 256,
                 stacked_convs: int = 3, num_points: int = 9,
                 gradient_mul: float = 0.1,
                 point_strides: Sequence[int] = (8, 16, 32, 64, 128),
                 point_base_scale: int = 4, use_reassign: bool = False,
                 topk: int = 6, anti_factor: float = 0.75,
                 loss_cls: Optional[dict] = None,
                 loss_bbox_init: Optional[dict] = None,
                 loss_bbox_refine: Optional[dict] = None,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None, version: str = 'oc',
                 norm_cfg: Optional[dict] = None,
                 init_cfg: Optional[dict] = None):
        super().__init__()
        self.num_classes = num_classes
        self.num_points = num_points
        self.gradient_mul = gradient_mul
        self.point_strides = list(point_strides)
        self.point_base_scale = point_base_scale
        self.use_reassign = use_reassign
        self.topk = topk
        self.anti_factor = anti_factor
        self.train_cfg = train_cfg or {}
        self.test_cfg = test_cfg or {}
        self.version = version
        self.prior_generator = MlvlPointGenerator(self.point_strides,
                                                  offset=0.5)
        self.loss_cls_cfg = dict(loss_cls or dict(type='FocalLoss'))
        self.cls_loss = LOSSES.build(dict(self.loss_cls_cfg))
        self.init_loss = LOSSES.build(dict(
            loss_bbox_init or self.default_init_loss))
        self.refine_cfg = dict(loss_bbox_refine or self.default_refine_loss)
        self.refine_loss = LOSSES.build(dict(self.refine_cfg))
        self.cls_convs = nn.ModuleList(
            ConvGN(in_channels if i == 0 else feat_channels, feat_channels)
            for i in range(stacked_convs))
        self.reg_convs = nn.ModuleList(
            ConvGN(in_channels if i == 0 else feat_channels, feat_channels)
            for i in range(stacked_convs))
        pts_out = 2 * num_points
        self.reppoints_pts_init_conv = nn.Conv2d(feat_channels,
                                                 point_feat_channels, 3,
                                                 padding=1)
        self.reppoints_pts_init_out = nn.Conv2d(point_feat_channels, pts_out,
                                                1)
        self.reppoints_cls_conv = DeformConv2d(feat_channels,
                                               point_feat_channels)
        self.reppoints_cls_out = nn.Conv2d(point_feat_channels, num_classes,
                                           1)
        self.reppoints_pts_refine_conv = DeformConv2d(feat_channels,
                                                      point_feat_channels)
        self.reppoints_pts_refine_out = nn.Conv2d(point_feat_channels,
                                                  pts_out, 1)
        self._cache: Dict[tuple, tuple] = {}

    @torch.no_grad()
    def init_cls_prior(self):
        """Focal-loss prior bias on ``reppoints_cls_out``: every score
        starts near 0.01."""
        self.reppoints_cls_out.bias.fill_(-math.log((1 - 0.01) / 0.01))

    # ---- forward -----------------------------------------------------------
    def forward(self, feats):
        cls_scores, pts_inits, pts_refines, pocs = [], [], [], []
        gm = self.gradient_mul
        for x in feats:
            with record_function('reppoints.towers'):
                c = x
                for conv in self.cls_convs:
                    c = conv(c)
                r = x
                for conv in self.reg_convs:
                    r = conv(r)
                pts_init = self.reppoints_pts_init_out(
                    F.relu(self.reppoints_pts_init_conv(r)))
            # the sampling offsets: the initial points, their gradient
            # scaled by gradient_mul
            offsets = gm * pts_init + (1 - gm) * pts_init.detach()
            with record_function('reppoints.sample'):
                taps_c = self.reppoints_cls_conv.sample(c, offsets)
            with record_function('reppoints.heads'):
                cls_feat = F.relu(self.reppoints_cls_conv.project(taps_c,
                                                                  c.dtype))
                cls_scores.append(self.reppoints_cls_out(cls_feat))
            del taps_c
            with record_function('reppoints.sample'):
                taps_r = self.reppoints_pts_refine_conv.sample(r, offsets)
            with record_function('reppoints.heads'):
                ref_feat = F.relu(self.reppoints_pts_refine_conv.project(
                    taps_r, r.dtype))
                pts_refine = self.reppoints_pts_refine_out(ref_feat) + \
                    pts_init.detach()
            del taps_r
            pts_inits.append(pts_init)
            pts_refines.append(pts_refine)
            if self.with_poc:
                pocs.append(self.point_correlation(x, pts_refine))
        if self.with_poc:
            return (tuple(cls_scores), tuple(pts_inits), tuple(pts_refines),
                    tuple(pocs))
        return tuple(cls_scores), tuple(pts_inits), tuple(pts_refines)

    @torch.no_grad()
    def point_correlation(self, x, pts_refine):
        """APAA's point-wise correlation quality (B, H, W): the base
        features sampled at the refined points, and over the points the
        largest ``1 - cos`` of a tap with the taps' mean (norms held at
        least 1e-2)."""
        with record_function('reppoints.sample'):
            taps = deform_conv_sample(x, pts_refine.detach())  # (B,C,P,H,W)
        mean_t = taps.mean(2, keepdim=True)
        tn = taps / torch.clamp(torch.linalg.vector_norm(
            taps, dim=1, keepdim=True), min=1e-2)
        mn = mean_t / torch.clamp(torch.linalg.vector_norm(
            mean_t, dim=1, keepdim=True), min=1e-2)
        return (1.0 - (tn * mn).sum(1)).amax(1)

    # ---- points -------------------------------------------------------------
    def _centers(self, featmap_sizes, device):
        """Every level's point centres (N, 2), strides (N,) and level
        indices (N,), cached."""
        key = (tuple(tuple(s) for s in featmap_sizes), str(device))

        def make():
            pts = self.prior_generator.grid_priors(featmap_sizes, device,
                                                   with_stride=True)
            lvls = [torch.full((len(p),), i, dtype=torch.long,
                               device=device) for i, p in enumerate(pts)]
            return (torch.cat([p[:, :2] for p in pts]),
                    torch.cat([p[:, 2] for p in pts]), torch.cat(lvls))

        return cached(self._cache, key, make)

    def _points_to_imgspace(self, pts_flat, centers, strides):
        """(B, N, 2 P) ``(dy, dx)`` offsets in cells -> image-space (B, N,
        2 P) ``(x, y)`` pairs."""
        off = pts_flat.reshape(pts_flat.shape[:-1] + (self.num_points, 2))
        y = centers[None, :, None, 1] + off[..., 0] * strides[None, :, None]
        x = centers[None, :, None, 0] + off[..., 1] * strides[None, :, None]
        return torch.stack([x, y], -1).reshape(pts_flat.shape)

    def _flat(self, outputs):
        """(cls (B, N, C), init (B, N, 2 P), refine (B, N, 2 P)) in float32,
        location-major over the levels."""
        cls_scores, pts_inits, pts_refines = outputs[:3]
        b = cls_scores[0].shape[0]

        def flat(maps, ch):
            return torch.cat([m.permute(0, 2, 3, 1).reshape(b, -1, ch)
                              for m in maps], 1).float()

        pts = 2 * self.num_points
        return (flat(cls_scores, self.num_classes), flat(pts_inits, pts),
                flat(pts_refines, pts))

    def flat_outputs(self, outputs):
        """The float32 flattened outputs of ``forward`` with the point sets in
        image space: dict(cls (B, N, C), init and ref (B, N, 2 P), poc (B,
        N) with ``with_poc``), and the points' centres (N, 2), strides (N,)
        and levels (N,)."""
        cls_flat, init_flat, ref_flat = self._flat(outputs)
        sizes = [tuple(s.shape[-2:]) for s in outputs[0]]
        centers, strides, lvl = self._centers(sizes, cls_flat.device)
        flat = dict(cls=cls_flat,
                    init=self._points_to_imgspace(init_flat, centers,
                                                  strides),
                    ref=self._points_to_imgspace(ref_flat, centers, strides),
                    centers=centers, strides=strides, lvl=lvl)
        if self.with_poc:
            b = cls_flat.shape[0]
            flat['poc'] = torch.cat([p.reshape(b, -1) for p in outputs[3]],
                                    1).float()
        return flat

    # ---- targets ------------------------------------------------------------
    def _assigners(self):
        tc = self.train_cfg or {}
        init_assigner = ConvexAssigner(**{
            k: v for k, v in dict(tc.get('init', {}).get(
                'assigner', {})).items() if k != 'type'})
        ref_cfg = dict(tc.get('refine', {}).get('assigner', {}))
        ref_type = ref_cfg.pop('type', 'MaxConvexIoUAssigner')
        ref_cfg.pop('ignore_iof_thr', None)
        if ref_type == 'SASAssigner':
            refine_assigner = SASAssigner(**ref_cfg)
        elif ref_type == 'ATSSKldAssigner':
            refine_assigner = ATSSKldPointsAssigner(**ref_cfg)
        else:
            refine_assigner = MaxConvexIoUAssigner(**ref_cfg)
        return init_assigner, refine_assigner, ref_type

    @torch.no_grad()
    def targets(self, outputs, gt_bboxes, gt_labels, gt_mask,
                flat=None) -> dict:
        """The batch's targets, with no gradient: the init assignment
        (``best_i``, ``init_w``, ``init_tgt`` polygons), the refine one
        (``arg_r``, ``pos_r``, ``neg_r``, ``labels_r``, ``ref_tgt``) and
        what the head's selection adds (:meth:`select`). ``flat``: the
        outputs as :meth:`flat_outputs` gives them (made here when None)."""
        if flat is None:
            flat = self.flat_outputs(outputs)
        flat = {k: v.detach() for k, v in flat.items()}
        sizes = [tuple(s.shape[-2:]) for s in outputs[0]]
        centers, strides = flat['centers'], flat['strides']
        points_lvl = torch.log2(strides).to(torch.long)
        gt_polys = obb2poly(gt_bboxes.float(), self.version)  # (B, G, 8)
        init_assigner, refine_assigner, ref_type = self._assigners()
        num_level = [h * w for h, w in sizes]
        best_i, pos_i, _ = init_assigner(centers, points_lvl, gt_polys,
                                         gt_labels, gt_mask,
                                         self.num_classes)
        overlaps = None
        if ref_type == 'SASAssigner':
            assign = refine_assigner(flat['init'], num_level, gt_polys,
                                     gt_labels, gt_mask)
            pos_r = assign.assigned_gt_inds >= 0
            arg_r = assign.assigned_gt_inds.clamp(min=0)
            neg_r = ~pos_r
            labels_r = torch.where(pos_r, assign.labels, self.num_classes)
        elif ref_type == 'ATSSKldAssigner':
            arg_r, pos_r, neg_r, labels_r, overlaps = refine_assigner(
                flat['init'], num_level, gt_polys, gt_labels, gt_mask,
                self.num_classes)
        else:
            arg_r, pos_r, neg_r, labels_r, overlaps = refine_assigner(
                flat['init'], gt_polys, gt_labels, gt_mask,
                self.num_classes)

        def take(idx):
            return gt_polys.gather(1, idx[..., None].expand(-1, -1, 8))

        tg = dict(best_i=best_i, init_w=pos_i.float(), init_tgt=take(best_i),
                  arg_r=arg_r, pos_r=pos_r, neg_r=neg_r, labels_r=labels_r,
                  ref_tgt=take(arg_r), gt_mask=gt_mask)
        tg.update(self.select(flat, tg, overlaps, sizes))
        return tg

    def select(self, flat, tg, overlaps, sizes) -> dict:
        """The head's selection of the refine positives: CFA's reassignment
        with ``use_reassign``, else nothing."""
        if not self.use_reassign:
            return {}
        return self._cfa_reassign(flat, tg, overlaps, len(sizes))

    def _quality_params(self):
        gamma = float(self.loss_cls_cfg.get('gamma', 2.0))
        alpha = float(self.loss_cls_cfg.get('alpha', 0.25))
        return gamma, alpha, float(self.refine_cfg.get('loss_weight', 1.0))

    def _cfa_reassign(self, flat, tg, overlaps, num_levels) -> dict:
        """CFA (reference ``reassign``, ``rotated_reppoints_head.py
        :850-1000``): each positive's quality (focal + refine weight x (1 -
        convex GIoU) of its initial points); per (gt, level) the ``topk``
        best are candidates; per gt a Gaussian of their qualities splits
        them at the best of ``normalised tail density x quality``, and the
        kept ones are weighted by ``anti_factor x`` their share of the
        point set's overlaps (the anti-aliasing). Returns keep (B, N) and
        the weights w (B, N)."""
        gamma, alpha, refine_w = self._quality_params()
        cls_flat, init_img = flat['cls'], flat['init']
        b, n = cls_flat.shape[:2]
        num_gts = tg['gt_mask'].shape[1]
        if overlaps is None:        # a refine assigner without a matrix
            overlaps = cls_flat.new_zeros((b, n, num_gts))
        lvl = flat['lvl']
        pos, assigned = tg['pos_r'], tg['arg_r']
        k, lk = self.topk, num_levels * self.topk
        quality = _focal_elementwise(cls_flat, tg['labels_r'],
                                     self.num_classes, gamma, alpha) + \
            refine_w * (1 - convex_giou(init_img, tg['ref_tgt']))

        r1 = rank_in_group(assigned * num_levels + lvl, quality, pos,
                           num_gts * num_levels)
        cand = pos & (r1 < k)
        # each candidate's slot in a (G + 1, L K) table; the rest go to the
        # row G, cut off after
        slot = torch.where(cand, assigned * lk + lvl * k + r1, num_gts * lk)
        rows = (num_gts + 1) * lk

        def table(fill, values):
            out = torch.full((b, rows), fill, dtype=values.dtype,
                             device=values.device)
            return out.scatter_(1, slot, values)[:, :num_gts * lk].reshape(
                b, num_gts, lk)

        inf = float('inf')
        q_tbl = table(inf, torch.where(cand, quality, inf))
        idx_tbl = table(n, torch.where(
            cand, torch.arange(n, device=pos.device), n))
        col_sum = overlaps.sum(-1)      # padded gts' columns are zero
        ratio = overlaps.gather(-1, assigned[..., None])[..., 0] / \
            (col_sum + 1e-6)
        r_tbl = table(0.0, torch.where(cand, ratio, 0.0))

        order = torch.sort(q_tbl, dim=-1, stable=True).indices
        qs = q_tbl.gather(-1, order)
        rs = r_tbl.gather(-1, order)
        idx_s = idx_tbl.gather(-1, order)
        valid = torch.isfinite(qs)
        cnt = valid.sum(-1)
        mean = torch.where(valid, qs, 0.0).sum(-1) / torch.clamp(cnt, min=1)
        dev2 = (qs - mean[..., None]) ** 2
        var = torch.where(valid, dev2, 0.0).sum(-1) / torch.clamp(cnt - 1,
                                                                  min=1)
        var = torch.clamp(var, min=1e-12)
        dens = torch.where(valid, torch.exp(-dev2 / var[..., None]) /
                           torch.sqrt(var)[..., None], 0.0)
        # cumulative density from the tail
        gp = torch.flip(torch.cumsum(torch.flip(dens, [-1]), -1), [-1])
        gmin = torch.where(valid, gp, inf).amin(-1, keepdim=True)
        gmax = torch.where(valid, gp, -inf).amax(-1, keepdim=True)
        gnorm = (gp - gmin) / torch.clamp(gmax - gmin, min=1e-6)
        thr = torch.where(valid, gnorm * qs, -inf).argmax(-1)
        keep_slot = valid & (torch.arange(lk, device=qs.device) <=
                             thr[..., None])
        w = torch.where(keep_slot, self.anti_factor * rs * gnorm + 1e-6, 0.0)
        nkeep = keep_slot.sum(-1, keepdim=True)
        w = w * nkeep / torch.clamp(w.sum(-1, keepdim=True), min=1e-6)
        small = (cnt < 2)[..., None]
        keep_slot = torch.where(small, valid, keep_slot)
        w = torch.where(small & valid, 1.0, w)
        keep_slot = keep_slot & tg['gt_mask'][..., None]
        w = torch.where(keep_slot, w, 0.0)
        # back to the points: a point holds at most one slot
        flat_idx = idx_s.reshape(b, -1)
        keep = torch.zeros((b, n + 1), dtype=torch.uint8,
                           device=qs.device).scatter_reduce_(
            1, flat_idx, keep_slot.reshape(b, -1).to(torch.uint8), 'amax')
        w_pts = torch.zeros((b, n + 1), device=qs.device).scatter_add_(
            1, flat_idx, w.reshape(b, -1))
        return dict(keep=keep[:, :n].bool(), w=w_pts[:, :n])

    # ---- losses -------------------------------------------------------------
    def loss(self, outputs, gt_bboxes, gt_labels, gt_mask):
        """Batched loss: dict(loss_cls, loss_pts_init, loss_pts_refine, and
        Oriented RepPoints' two spatial border terms), float32 scalars. The
        targets run in a ``reppoints.targets`` range, the losses in
        ``reppoints.loss``."""
        flat = self.flat_outputs(outputs)
        with record_function('reppoints.targets'):
            tg = self.targets(outputs, gt_bboxes, gt_labels, gt_mask, flat)
        with record_function('reppoints.loss'):
            return self.losses(flat, tg)

    def _norm(self, flat):
        """Per-point normalisation ``point_base_scale * stride`` (1, N, 1)."""
        return (self.point_base_scale * flat['strides'])[None, :, None]

    def _reg_losses(self, flat, tg, ref_w, num_pos_r):
        """The init and refine point losses, normalised per point."""
        b, n = flat['init'].shape[:2]
        nt = self._norm(flat)
        num_pos_i = torch.clamp(tg['init_w'].sum(), min=1.0)
        loss_init = self.init_loss(
            (flat['init'] / nt).reshape(b * n, -1),
            (tg['init_tgt'] / nt).reshape(b * n, -1),
            weight=tg['init_w'].reshape(-1), avg_factor=num_pos_i)
        loss_refine = self.refine_loss(
            (flat['ref'] / nt).reshape(b * n, -1),
            (tg['ref_tgt'] / nt).reshape(b * n, -1),
            weight=ref_w.reshape(-1), avg_factor=num_pos_r)
        return loss_init, loss_refine

    def losses(self, flat, tg) -> dict:
        """The loss terms of :meth:`flat_outputs`' outputs and
        :meth:`targets`' targets."""
        lw = (tg['pos_r'] | tg['neg_r']).float()
        labels = tg['labels_r']
        if 'keep' in tg:            # CFA
            keep = tg['keep']
            num_pos = torch.clamp(keep.sum().float(), min=1.0)
            labels = torch.where(tg['pos_r'] & ~keep, self.num_classes,
                                 labels)
            lw = torch.where(keep, tg['w'], lw)
            ref_w = torch.where(keep, tg['w'], 0.0)
        else:
            ref_w = tg['pos_r'].float()
            num_pos = torch.clamp(ref_w.sum(), min=1.0)
        loss_init, loss_refine = self._reg_losses(flat, tg, ref_w, num_pos)
        loss_cls = self.cls_loss(flat['cls'], labels, weight=lw,
                                 avg_factor=num_pos)
        return dict(loss_cls=loss_cls, loss_pts_init=loss_init,
                    loss_pts_refine=loss_refine)

    # ---- inference ----------------------------------------------------------
    def pointsets_to_polys(self, pointsets):
        """(K, 2 P) point sets -> (K, 8): the minimum-area enclosing
        rectangle (reference ``points2rotrect``, ``rotrect``)."""
        return min_area_polygons(pointsets)

    def get_bboxes(self, outputs, img_shape=None, scale_factor=None,
                   rescale: bool = False, cfg=None,
                   plain_pair_mask: bool = False):
        """Batched decode + multiclass rotated NMS: per image the top
        ``nms_pre`` locations by their best sigmoid score (the lowest index
        first on a tie), their refined point sets turned into rectangles
        (:meth:`pointsets_to_polys`) and boxes (``poly2obb`` in the head's
        version). ``img_shape``, ``scale_factor`` and ``rescale`` are not
        read, as in the JAX package. Returns (dets (B, max_per_img, 6),
        labels, valid)."""
        cfg = cfg if cfg is not None else self.test_cfg
        check_exact_topk(cfg)
        with record_function('reppoints.decode_nms'):
            cls_flat, _, ref_flat = self._flat(outputs)
            sizes = [tuple(s.shape[-2:]) for s in outputs[0]]
            centers, strides, _ = self._centers(sizes, cls_flat.device)
            ref_img = self._points_to_imgspace(ref_flat, centers, strides)
            scores = torch.sigmoid(cls_flat)
            b, n = scores.shape[:2]
            nms_pre = int(cfg.get('nms_pre', 2000))
            k = min(nms_pre, n) if nms_pre > 0 else n
            _, top = topk_candidates(scores.amax(-1), k)       # (B, k)
            sets = ref_img.gather(1, top[..., None].expand(
                -1, -1, ref_img.shape[-1]))
            polys = self.pointsets_to_polys(sets.reshape(b * k, -1))
            boxes = poly2obb(polys.reshape(b, k, 8), self.version)
            sel = scores.gather(1, top[..., None].expand(-1, -1,
                                                         self.num_classes))
            sel = torch.cat([sel, sel.new_zeros((b, k, 1))], -1)
            nms_cfg = cfg.get('nms', {'iou_thr': 0.1})
            return multiclass_nms_rotated(
                boxes, sel, score_thr=float(cfg.get('score_thr', 0.05)),
                iou_thr=float(nms_cfg.get('iou_thr', 0.1)),
                max_per_img=int(cfg.get('max_per_img', 2000)),
                max_candidates=int(cfg.get('max_candidates', 2000)),
                plain_pair_mask=plain_pair_mask)


@HEADS.register_module()
class OrientedRepPointsHead(RotatedRepPointsHead):
    """Oriented RepPoints with APAA (reference
    ``oriented_reppoints_head.py:432-620``): each refine positive's
    quality is its focal loss plus ``init_qua_weight`` / ``1 -
    init_qua_weight`` of each stage's localisation (refine weight x (1 -
    convex GIoU)) and orientation (``ori_qua_weight`` x the chamfer
    distance of its least rectangle to the gt, edge-sampled) qualities,
    plus ``poc_qua_weight`` x the point-wise correlation; per (gt, level)
    the 6 best are candidates, and per gt the best ``ceil(top_ratio x
    count)`` of those (all of them under 2) are kept. Spatial border losses
    on both stages. ``forward`` adds a fourth output, the correlation map
    (B, H, W) of each level."""

    with_poc = True

    def __init__(self, *args, top_ratio: float = 0.4,
                 init_qua_weight: float = 0.2, ori_qua_weight: float = 0.3,
                 poc_qua_weight: float = 0.1,
                 loss_spatial_init: Optional[dict] = None,
                 loss_spatial_refine: Optional[dict] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.top_ratio = top_ratio
        self.init_qua_weight = init_qua_weight
        self.ori_qua_weight = ori_qua_weight
        self.poc_qua_weight = poc_qua_weight
        self.spatial_init = LOSSES.build(dict(loss_spatial_init or dict(
            type='SpatialBorderLoss', loss_weight=0.05)))
        self.spatial_refine = LOSSES.build(dict(loss_spatial_refine or dict(
            type='SpatialBorderLoss', loss_weight=0.1)))

    def quality(self, flat, tg):
        """APAA's quality of every point (B, N), float32."""
        gamma, alpha, refine_w = self._quality_params()
        init, ref, tgt = flat['init'], flat['ref'], tg['ref_tgt']
        b, n = init.shape[:2]
        poly_init = min_area_polygons(init.reshape(b * n, -1)).reshape(
            b, n, 8)
        poly_ref = min_area_polygons(ref.reshape(b * n, -1)).reshape(b, n, 8)
        ori_init = self.ori_qua_weight * chamfer_quality(tgt, poly_init)
        ori_ref = self.ori_qua_weight * chamfer_quality(tgt, poly_ref)
        loc_init = refine_w * (1 - convex_giou(init, tgt))
        loc_ref = refine_w * (1 - convex_giou(ref, tgt))
        iqw = self.init_qua_weight
        return (_focal_elementwise(flat['cls'], tg['labels_r'],
                                   self.num_classes, gamma, alpha) +
                iqw * (loc_init + ori_init) +
                (1 - iqw) * (loc_ref + ori_ref) +
                self.poc_qua_weight * flat['poc'])

    def select(self, flat, tg, overlaps, sizes) -> dict:
        """APAA's dynamic top-k: keep (B, N)."""
        qua = self.quality(flat, tg)
        num_levels, num_gts = len(sizes), tg['gt_mask'].shape[1]
        pos, assigned = tg['pos_r'], tg['arg_r']
        r1 = rank_in_group(assigned * num_levels + flat['lvl'], qua, pos,
                           num_gts * num_levels)
        cand = pos & (r1 < 6)
        r2 = rank_in_group(assigned, qua, cand, num_gts)
        cnt = torch.zeros(assigned.shape[0], num_gts, dtype=torch.long,
                          device=assigned.device).scatter_add_(
            1, assigned, cand.long())
        # ceil(count x ratio) in float32 (exact at every multiple of 5 for
        # 0.4, where float64 rounds 10 x 0.4 up to 5); the ratio filled on
        # the device
        ratio = torch.full((), self.top_ratio, dtype=torch.float32,
                           device=cnt.device)
        topk_g = torch.where(cnt < 2, cnt,
                             torch.ceil(cnt.float() * ratio).long())
        return dict(keep=cand & (r2 < topk_g.gather(1, assigned)))

    def losses(self, flat, tg) -> dict:
        keep, pos_r = tg['keep'], tg['pos_r']
        num_pos = torch.clamp(keep.sum().float(), min=1.0)
        labels = torch.where(pos_r & ~keep, self.num_classes, tg['labels_r'])
        lw = (pos_r | tg['neg_r']).float()
        ref_w = keep.float()
        loss_init, loss_refine = self._reg_losses(flat, tg, ref_w, num_pos)
        loss_cls = self.cls_loss(flat['cls'], labels, weight=lw,
                                 avg_factor=num_pos)
        b, n = flat['init'].shape[:2]
        nt = self._norm(flat)
        num_pos_i = torch.clamp(tg['init_w'].sum(), min=1.0)
        sb_init = self.spatial_init(
            (flat['init'] / nt).reshape(b * n, -1),
            (tg['init_tgt'] / nt).reshape(b * n, -1),
            weight=tg['init_w'].reshape(-1), avg_factor=num_pos_i)
        sb_ref = self.spatial_refine(
            (flat['ref'] / nt).reshape(b * n, -1),
            (tg['ref_tgt'] / nt).reshape(b * n, -1),
            weight=ref_w.reshape(-1), avg_factor=num_pos)
        return dict(loss_cls=loss_cls, loss_pts_init=loss_init,
                    loss_pts_refine=loss_refine, loss_spatial_init=sb_init,
                    loss_spatial_refine=sb_ref)


@HEADS.register_module()
class SAMRepPointsHead(RotatedRepPointsHead):
    """SASM (reference ``sam_reppoints_head.py``): the refine stage takes
    ``SASAssigner``'s positives, and the shape-adaptive weights
    ``exp(1 / (1 + d))``, d the width- and height-normalised distance of a
    point (or of a point set's mean point) to its gt's centre, multiply the
    init loss, the refine loss and the class loss
    (``:376-415``)."""

    default_init_loss = dict(type='BCConvexGIoULoss', loss_weight=0.375)

    def _sam_weights(self, tgt_polys, points_xy, lw):
        """tgt_polys (B, N, 8) (zeros where not positive); points_xy (B, N,
        2); lw (B, N) -> (B, N), 0 where not finite."""
        cx, cy, w, h, a = poly2obb(tgt_polys, self.version).unbind(-1)
        dx2 = (cx - points_xy[..., 0]) ** 2
        dy2 = (cy - points_xy[..., 1]) ** 2
        w_s = torch.clamp(w, min=1e-6)
        h_s = torch.clamp(h, min=1e-6)
        cond_wh = (w > 0) & (a >= 0) & (a <= 1.57)
        cond_hw = (w > 0) & ((a < 0) | (a > 1.57))
        d = torch.where(cond_wh, torch.sqrt(dx2 / w_s + dy2 / h_s),
                        torch.where(cond_hw,
                                    torch.sqrt(dx2 / h_s + dy2 / w_s), 0.0))
        sam = lw * torch.exp(1.0 / (d + 1.0))
        return torch.where(torch.isfinite(sam), sam, 0.0)

    def select(self, flat, tg, overlaps, sizes) -> dict:
        """The SA weights of the init stage (every point, at its location)
        and of the refine stage (at its initial points' mean)."""
        b, n = flat['init'].shape[:2]
        sam_i = self._sam_weights(
            torch.where(tg['init_w'][..., None] > 0, tg['init_tgt'], 0.0),
            flat['centers'][None].expand(b, n, 2),
            torch.ones_like(tg['init_w']))
        ref_centers = _sum(flat['init'].reshape(b, n, -1, 2), -2) / \
            self.num_points
        sam_r = self._sam_weights(
            torch.where(tg['pos_r'][..., None], tg['ref_tgt'], 0.0),
            ref_centers, (tg['pos_r'] | tg['neg_r']).float())
        return dict(sam_i=sam_i, sam_r=sam_r)

    def losses(self, flat, tg) -> dict:
        b, n = flat['init'].shape[:2]
        nt = self._norm(flat)
        ref_w = tg['pos_r'].float()
        lw_r = (tg['pos_r'] | tg['neg_r']).float()
        num_pos_i = torch.clamp(tg['init_w'].sum(), min=1.0)
        num_pos_r = torch.clamp(ref_w.sum(), min=1.0)
        loss_init = self.init_loss(
            (flat['init'] / nt).reshape(b * n, -1),
            (tg['init_tgt'] / nt).reshape(b * n, -1),
            weight=(tg['init_w'] * tg['sam_i']).reshape(-1),
            avg_factor=num_pos_i)
        loss_refine = self.refine_loss(
            (flat['ref'] / nt).reshape(b * n, -1),
            (tg['ref_tgt'] / nt).reshape(b * n, -1),
            weight=(ref_w * tg['sam_r']).reshape(-1), avg_factor=num_pos_r)
        loss_cls = self.cls_loss(flat['cls'], tg['labels_r'],
                                 weight=lw_r * tg['sam_r'],
                                 avg_factor=num_pos_r)
        return dict(loss_cls=loss_cls, loss_pts_init=loss_init,
                    loss_pts_refine=loss_refine)


@HEADS.register_module()
class KLDRepPointsHead(RotatedRepPointsHead):
    """G-RepPoints (reference ``configs/g_reppoints``): ``KLDRepPointsLoss``
    on both stages (a Gaussian fitted to each point set against the gt's),
    the refine stage assigned by ``ATSSKldAssigner``, and a decode from the
    same statistic: a one-component Gaussian fitted to each point set,
    turned into a rectangle (``ops.boxes.gaussian2bbox``). Decoding the
    raw hull instead is a train/test mismatch that scores near 0 mAP."""

    default_init_loss = dict(type='KLDRepPointsLoss')
    default_refine_loss = dict(type='KLDRepPointsLoss')

    def pointsets_to_polys(self, pointsets):
        p = pointsets.reshape(-1, self.num_points, 2)
        _, mu, cov = gmm_fit(p, n_components=1, n_iter=2)
        return gaussian2bbox(mu[..., 0, :], cov[..., 0, :, :]).reshape(
            pointsets.shape[:-1] + (8,))
