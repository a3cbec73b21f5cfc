"""Rotated FCOS head, anchor-free (counterpart of
``orientedobjectdetection_tpu/models/dense_heads/rotated_fcos_head.py``;
reference ``dense_heads/rotated_fcos_head.py:17-667`` and
``csl_rotated_fcos_head.py``).

The towers are 3x3 convolutions, each followed by GroupNorm(32) and a ReLU;
the convolutions run in the input's dtype (bfloat16 under autocast or in a
bfloat16 bundle) and the GroupNorm in float32, cast back to the input's
dtype. The regression and the angle go through a learnable per-level
``Scale`` in float32.

Point targets (regress-range gating, the smallest gt that holds the point,
centre sampling in the gt's rotated frame) are one masked computation over
``(B, N, G)``, under ``torch.no_grad()``: no per-image loop, no
data-dependent shape, no wait for the host. The loss runs the rotated IoU
loss on every point with the weight ``positive * centerness``, as the JAX
package does.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from ...core.anchors import MlvlPointGenerator
from ...core.coders import DistanceAnglePointCoder
from ...ops.nms import multiclass_nms_rotated, topk_candidates
from ...utils.registry import BBOX_CODERS, HEADS, LOSSES

INF = 1e8


class Scale(nn.Module):
    """A learnable scalar (mmcv's ``Scale``); the product is float32."""

    def __init__(self, init_value: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(float(init_value)))

    def forward(self, x):
        return x.float() * self.scale


class ConvGN(nn.Module):
    """mmcv's ConvModule with GroupNorm(32) and a ReLU: ``conv`` then
    ``gn`` (checkpoint names ``<parent>.conv.*`` and ``<parent>.gn.*``).
    The convolution keeps its bias, as the JAX package's does. GroupNorm's
    epsilon is flax's 1e-6."""

    def __init__(self, cin: int, cout: int, groups: int = 32):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, padding=1)
        self.gn = nn.GroupNorm(groups, cout, eps=1e-6)

    def forward(self, x):
        x = self.conv(x)
        y = F.group_norm(x.float(), self.gn.num_groups, self.gn.weight,
                         self.gn.bias, self.gn.eps)
        return F.relu(y.to(x.dtype))


def _flat(maps, b: int, channels: int) -> torch.Tensor:
    """Per-level NCHW maps -> (B, N, channels), location-major."""
    return torch.cat([m.permute(0, 2, 3, 1).reshape(b, -1, channels)
                      for m in maps], 1)


@HEADS.register_module()
class RotatedFCOSHead(nn.Module):
    """FCOS head: ``conv_cls`` (C logits), ``conv_reg`` (l, t, r, b),
    ``conv_angle`` (one angle, or the angle coder's bins with
    ``separate_angle``) and ``conv_centerness`` on the towers.
    ``forward`` returns (cls_scores, bbox_preds, angle_preds,
    centernesses), per-level NCHW maps.

    Options as in the reference: ``norm_on_bbox`` (ReLU on the regression,
    which is in strides: the loss and the decode multiply it back),
    ``centerness_on_reg``, ``center_sampling`` / ``center_sample_radius``,
    ``scale_angle`` (a per-level ``Scale`` on the angle) and
    ``separate_angle`` (the box loss on the horizontal box in the point's
    frame, and an angle loss of its own: ``SmoothFocalLoss`` on the
    ``angle_coder``'s bins, or ``L1Loss`` on the angle). ``h_bbox_coder``
    is accepted and not read: the horizontal boxes are decoded with
    ``DistanceAnglePointCoder('le90')`` and a zero angle, as the JAX
    package does; so is ``train_cfg`` (the targets follow from the
    geometry)."""

    def __init__(self, num_classes: int = 15, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 strides: Sequence[int] = (8, 16, 32, 64, 128),
                 regress_ranges=((-1, 64), (64, 128), (128, 256), (256, 512),
                                 (512, INF)),
                 center_sampling: bool = False,
                 center_sample_radius: float = 1.5,
                 norm_on_bbox: bool = False,
                 centerness_on_reg: bool = False,
                 separate_angle: bool = False,
                 scale_angle: bool = True,
                 bbox_coder: Optional[dict] = None,
                 h_bbox_coder: Optional[dict] = None,
                 angle_coder: Optional[dict] = None,
                 loss_cls: Optional[dict] = None,
                 loss_bbox: Optional[dict] = None,
                 loss_centerness: Optional[dict] = None,
                 loss_angle: Optional[dict] = None,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None):
        super().__init__()
        self.num_classes = num_classes
        self.strides = list(strides)
        self.regress_ranges = [tuple(float(v) for v in r)
                               for r in regress_ranges]
        self.center_sampling = center_sampling
        self.center_sample_radius = center_sample_radius
        self.norm_on_bbox = norm_on_bbox
        self.centerness_on_reg = centerness_on_reg
        self.separate_angle = separate_angle
        self.test_cfg = test_cfg or {}
        self.coder = DistanceAnglePointCoder(
            angle_range=(bbox_coder or {}).get('angle_version', 'le90'))
        self.h_coder = DistanceAnglePointCoder(angle_range='le90')
        self.angle_coder = BBOX_CODERS.build(dict(angle_coder)) \
            if angle_coder is not None else None
        self.prior_generator = MlvlPointGenerator(self.strides, offset=0.5)
        self.cls_loss = LOSSES.build(dict(loss_cls or dict(type='FocalLoss')))
        self.bbox_loss = LOSSES.build(dict(
            loss_bbox or dict(type='RotatedIoULoss')))
        self.centerness_loss = LOSSES.build(dict(
            loss_centerness or dict(type='CrossEntropyLoss')))
        self.angle_loss = None
        if separate_angle:
            default = 'SmoothFocalLoss' if self.angle_coder is not None \
                else 'L1Loss'
            self.angle_loss = LOSSES.build(dict(
                loss_angle or dict(type=default)))
        self.cls_convs = nn.ModuleList(
            ConvGN(in_channels if i == 0 else feat_channels, feat_channels)
            for i in range(stacked_convs))
        self.reg_convs = nn.ModuleList(
            ConvGN(in_channels if i == 0 else feat_channels, feat_channels)
            for i in range(stacked_convs))
        angle_out = self.angle_coder.encode_size \
            if separate_angle and self.angle_coder is not None else 1
        self.conv_cls = nn.Conv2d(feat_channels, num_classes, 3, padding=1)
        self.conv_reg = nn.Conv2d(feat_channels, 4, 3, padding=1)
        self.conv_angle = nn.Conv2d(feat_channels, angle_out, 3, padding=1)
        self.conv_centerness = nn.Conv2d(feat_channels, 1, 3, padding=1)
        self.scales = nn.ModuleList(Scale() for _ in self.strides)
        self.scale_angles = nn.ModuleList(
            Scale() for _ in self.strides) \
            if scale_angle and not separate_angle else None
        self._point_cache: Dict[tuple, tuple] = {}

    @torch.no_grad()
    def init_cls_prior(self):
        """Focal-loss prior bias on ``conv_cls``: every score starts near
        0.01."""
        self.conv_cls.bias.fill_(-math.log((1 - 0.01) / 0.01))

    def forward(self, feats):
        cls_scores, bbox_preds, angle_preds, centernesses = [], [], [], []
        for lvl, x in enumerate(feats):
            c = x
            for conv in self.cls_convs:
                c = conv(c)
            r = x
            for conv in self.reg_convs:
                r = conv(r)
            cls_scores.append(self.conv_cls(c))
            bbox_pred = self.scales[lvl](self.conv_reg(r))
            bbox_preds.append(F.relu(bbox_pred) if self.norm_on_bbox
                              else torch.exp(bbox_pred))
            ang = self.conv_angle(r)
            if self.scale_angles is not None:
                ang = self.scale_angles[lvl](ang)
            angle_preds.append(ang)
            centernesses.append(self.conv_centerness(
                r if self.centerness_on_reg else c))
        return (tuple(cls_scores), tuple(bbox_preds), tuple(angle_preds),
                tuple(centernesses))

    # ---- targets ----------------------------------------------------------
    def flat_points(self, featmap_sizes, device):
        """(N, 2) points over every level, and each point's (N, 2) regress
        range and (N,) stride, float32 on ``device``."""
        key = (tuple(tuple(s) for s in featmap_sizes), str(device))
        if key not in self._point_cache:
            pts = self.prior_generator.grid_priors(featmap_sizes, device)
            ranges = [torch.tensor(self.regress_ranges[lvl],
                                   device=device).expand(len(p), 2)
                      for lvl, p in enumerate(pts)]
            strides = [torch.full((len(p),), float(self.strides[lvl]),
                                  device=device)
                       for lvl, p in enumerate(pts)]
            self._point_cache[key] = (torch.cat(pts), torch.cat(ranges),
                                      torch.cat(strides))
        return self._point_cache[key]

    @torch.no_grad()
    def targets(self, points, ranges, strides, gt_bboxes, gt_labels,
                gt_mask):
        """points (N, 2), ranges (N, 2), strides (N,) and padded gts
        (B, G, 5) / (B, G) / (B, G) -> labels (B, N) (``num_classes`` for
        background), (l, t, r, b) targets (B, N, 4), angle targets (B, N)
        and the positive mask (B, N). A point goes to the smallest valid gt
        that holds it within its level's range, the lowest index on a tie;
        a negative point's targets are those of gt 0."""
        gx, gy, gw, gh, ga = gt_bboxes[:, None].unbind(-1)     # (B, 1, G)
        cos_a, sin_a = torch.cos(ga), torch.sin(ga)
        dx = points[None, :, 0, None] - gx                     # (B, N, G)
        dy = points[None, :, 1, None] - gy
        ox = dx * cos_a + dy * sin_a
        oy = -dx * sin_a + dy * cos_a
        left = gw / 2 + ox
        right = gw / 2 - ox
        top = gh / 2 + oy
        bottom = gh / 2 - oy
        inside = (left > 0) & (right > 0) & (top > 0) & (bottom > 0)
        if self.center_sampling:
            radius = self.center_sample_radius * strides[None, :, None]
            inside &= (ox.abs() < torch.minimum(radius, gw / 2)) & \
                (oy.abs() < torch.minimum(radius, gh / 2))
        max_reg = torch.maximum(torch.maximum(left, right),
                                torch.maximum(top, bottom))
        valid = inside & (max_reg >= ranges[None, :, 0, None]) & \
            (max_reg <= ranges[None, :, 1, None]) & gt_mask[:, None, :]
        cand_areas = torch.where(valid, gw * gh, gw.new_tensor(INF))
        min_area, matched = cand_areas.min(dim=2)              # (B, N)
        pos = min_area < INF
        labels = torch.where(pos, gt_labels.long().gather(1, matched),
                             self.num_classes)
        pick = matched[..., None]
        bbox_targets = torch.cat([t.gather(2, pick) for t in
                                  (left, top, right, bottom)], -1)
        angle_targets = gt_bboxes[..., 4].gather(1, matched)
        return labels, bbox_targets, angle_targets, pos

    @staticmethod
    def centerness_target(bbox_targets):
        """sqrt((min(l, r) / max(l, r)) * (min(t, b) / max(t, b))), the
        maxima clamped at 1e-6 and the product at 0."""
        lr = bbox_targets[..., [0, 2]]
        tb = bbox_targets[..., [1, 3]]
        c = (lr.amin(-1) / lr.amax(-1).clamp(min=1e-6)) * \
            (tb.amin(-1) / tb.amax(-1).clamp(min=1e-6))
        return torch.sqrt(c.clamp(min=0))

    # ---- loss ---------------------------------------------------------------
    def loss(self, outputs, gt_bboxes, gt_labels, gt_mask):
        """Batched loss: dict(loss_cls, loss_bbox, loss_centerness, and
        loss_angle with ``separate_angle``) of float32 scalars. The targets
        and the box loss carry ``torch.profiler`` ranges (``fcos.targets``,
        ``fcos.box_loss``)."""
        cls_scores, bbox_preds, angle_preds, centernesses = outputs
        b = cls_scores[0].shape[0]
        featmap_sizes = [tuple(s.shape[-2:]) for s in cls_scores]
        points, ranges, strides = self.flat_points(featmap_sizes,
                                                   cls_scores[0].device)
        with record_function('fcos.targets'):
            labels, bt, at, pos = self.targets(
                points, ranges, strides, gt_bboxes.float(), gt_labels,
                gt_mask)
            pw = pos.float()
            ctr_targets = self.centerness_target(bt)
            num_pos = pos.sum().float().clamp(min=1.0)
            ctr_denom = (ctr_targets * pw).sum().clamp(min=1e-6)
        cls_flat = _flat(cls_scores, b, self.num_classes).float()
        box_flat = _flat(bbox_preds, b, 4).float()
        ang_flat = _flat(angle_preds, b, angle_preds[0].shape[1]).float()
        ctr_flat = _flat(centernesses, b, 1).float()
        if self.norm_on_bbox:
            box_flat = box_flat * strides[None, :, None]
        losses = dict(loss_cls=self.cls_loss(
            cls_flat, labels, weight=torch.ones_like(pw),
            avg_factor=num_pos))
        with record_function('fcos.box_loss'):
            if self.separate_angle:
                zeros = torch.zeros_like(ang_flat[..., :1])
                pred_box = self.h_coder.decode(
                    points[None], torch.cat([box_flat, zeros], -1))
                tgt_box = self.h_coder.decode(
                    points[None], torch.cat([bt, zeros], -1))
            else:
                pred_box = self.coder.decode(
                    points[None], torch.cat([box_flat, ang_flat[..., :1]],
                                            -1))
                tgt_box = self.coder.decode(
                    points[None], torch.cat([bt, at[..., None]], -1))
            losses['loss_bbox'] = self.bbox_loss(
                pred_box, tgt_box, weight=pw * ctr_targets,
                avg_factor=ctr_denom)
        if self.separate_angle:
            if self.angle_coder is not None:
                losses['loss_angle'] = self.angle_loss(
                    ang_flat, self.angle_coder.encode(at[..., None]),
                    weight=pw, avg_factor=num_pos)
            else:
                losses['loss_angle'] = self.angle_loss(
                    ang_flat[..., 0], at, weight=pw, avg_factor=num_pos)
        losses['loss_centerness'] = self.centerness_loss(
            ctr_flat, ctr_targets[..., None], weight=pw, avg_factor=num_pos)
        return losses

    # ---- inference ----------------------------------------------------------
    def candidates(self, outputs, img_shape=None, cfg=None):
        """Per level, the top ``nms_pre`` points by
        ``sigmoid(max logit) * sigmoid(centerness)``, decoded. Returns
        boxes (B, K, 5), sigmoid scores (B, K, C) and sigmoid centerness
        (B, K), float32, K summed over levels."""
        cfg = cfg if cfg is not None else self.test_cfg
        if cfg.get('approx_topk', False):
            raise ValueError('test_cfg.approx_topk=True asks for an '
                             'approximate top-k, which the port does not '
                             'have; set it False for the exact top-k')
        nms_pre = int(cfg.get('nms_pre', 1000))
        cls_scores, bbox_preds, angle_preds, centernesses = outputs
        featmap_sizes = [tuple(s.shape[-2:]) for s in cls_scores]
        level_points = self.prior_generator.grid_priors(
            featmap_sizes, cls_scores[0].device)
        boxes, scores, ctrs = [], [], []
        for lvl, pts in enumerate(level_points):
            b = cls_scores[lvl].shape[0]
            logits = _flat([cls_scores[lvl]], b, self.num_classes)
            ctr = _flat([centernesses[lvl]], b, 1)[..., 0]
            deltas = _flat([bbox_preds[lvl]], b, 4)
            angles = _flat([angle_preds[lvl]], b, angle_preds[lvl].shape[1])
            n = logits.shape[1]
            k = min(nms_pre, n) if nms_pre > 0 else n
            rank = torch.sigmoid(logits.amax(-1).float()) * \
                torch.sigmoid(ctr.float())
            _, idx = topk_candidates(rank, k)                  # (B, k)

            def take(t):
                return t.gather(1, idx[..., None].expand(
                    -1, -1, t.shape[-1])).float()

            sel_deltas = take(deltas)
            if self.norm_on_bbox:
                sel_deltas = sel_deltas * self.strides[lvl]
            sel_angles = take(angles)
            if self.separate_angle and self.angle_coder is not None:
                theta = self.angle_coder.decode(sel_angles)[..., None]
            else:
                theta = sel_angles[..., :1]
            boxes.append(self.coder.decode(
                pts[idx], torch.cat([sel_deltas, theta], -1),
                max_shape=img_shape))
            scores.append(torch.sigmoid(take(logits)))
            ctrs.append(torch.sigmoid(ctr.gather(1, idx).float()))
        return torch.cat(boxes, 1), torch.cat(scores, 1), torch.cat(ctrs, 1)

    def get_bboxes(self, outputs, img_shape=None, scale_factor=None,
                   rescale: bool = False, cfg=None,
                   plain_pair_mask: bool = False):
        """Batched decode + multiclass rotated NMS, the scores weighted by
        the centerness (``score_factors``). Returns (dets (B, max_per_img,
        6), labels (B, max_per_img), valid); ``rescale`` and
        ``plain_pair_mask`` as in ``RotatedRetinaHead.get_bboxes``."""
        cfg = cfg if cfg is not None else self.test_cfg
        boxes, scores, ctrs = self.candidates(outputs, img_shape, cfg)
        if rescale and scale_factor is not None:
            sf = boxes.new_tensor(scale_factor)[:2].repeat(2)
            boxes = torch.cat([boxes[..., :4] / sf, boxes[..., 4:]], -1)
        scores = torch.cat([scores, scores.new_zeros(scores.shape[:2] + (1,))],
                           -1)
        nms_cfg = cfg.get('nms', {'iou_thr': 0.1})
        return multiclass_nms_rotated(
            boxes, scores,
            score_thr=float(cfg.get('score_thr', 0.05)),
            iou_thr=float(nms_cfg.get('iou_thr', 0.1)),
            max_per_img=int(cfg.get('max_per_img', 2000)),
            score_factors=ctrs,
            max_candidates=int(cfg.get('max_candidates', 2000)),
            plain_pair_mask=plain_pair_mask)


@HEADS.register_module()
class CSLRFCOSHead(RotatedFCOSHead):
    """FCOS with CSL angle classification (reference
    ``csl_rotated_fcos_head.py``): the config sets ``separate_angle=True``
    and a ``CSLCoder`` ``angle_coder``."""
