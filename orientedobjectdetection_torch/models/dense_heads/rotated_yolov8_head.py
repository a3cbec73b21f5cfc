"""RotatedYOLOv8 head and OBBLabelAssigner, the jy prototypes' head
(counterpart of
``orientedobjectdetection_tpu/models/dense_heads/rotated_yolov8_head.py``;
reference ``dense_heads/rotated_yolov8_head.py:37-650`` and
``assigners/obb_label_assigner.py:20-252``).

Per level three towers of two :class:`YOLOConvModule` each (cls, reg,
angle) and a 1x1 output conv; the regression goes through a per-level
``Scale`` and is clipped at 0 in float32, or, with ``reg_max > 1``, is the
expectation of a float32 softmax over ``1 + reg_max`` bins a side (DFL).
Module names are the JAX package's (``cls_conv_{i}_{j}``, ``cls_pred_{i}``,
``scale_{i}``...).

:class:`OBBLabelAssigner` is one masked computation over ``(B, N, G)``
under ``torch.no_grad()``: the points rotated into each gt's frame; the
inside, centre-radius (1.5 strides) and regress-range gates; cost ``0.2 *
centerness + 0.2 * IoU + 0.6 * softmax class probability``; the top-k
points a gt (a stable descending sort: the lowest index wins a tie, as
``jax.lax.top_k``); a point that several gts keep goes to the largest gt
by AREA (the reference's quirk), the first at a tie; a gt left without a
point takes its point of largest centerness. The IoU of the detached,
decoded predictions against the gts is one ``rbbox_overlaps`` call for the
batch: the IoU-matrix kernel on the card. The JAX package scatters the
orphan rematch (``idx.at[best_pt].set``); where several gts share a best
point, XLA's serial scatter lets the highest gt index write last, and the
port takes that gt (a deterministic ``amax`` scatter, no write race).

The box loss compares prediction and target decoded in the
stride-normalized space (the JAX package's choice, kept). The background
label is ``num_classes``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.profiler import record_function

from ...core.anchors import MlvlPointGenerator, cached
from ...core.coders import DistanceAnglePointCoder
from ...ops.iou import rbbox_overlaps
from ...ops.nms import multiclass_nms_rotated, topk_candidates
from ...utils.registry import BBOX_ASSIGNERS, HEADS, LOSSES
from ..blocks import YOLOConvModule, make_divisible
from .rotated_fcos_head import Scale, _flat


@BBOX_ASSIGNERS.register_module()
class OBBLabelAssigner:
    """The jy cost-based top-k point assigner, batched over images.
    ``alpha``, ``beta``, ``gamma``, ``featmap_strides``, ``regress_ranges``,
    ``bbox_coder`` and ``iou_calculator`` are accepted and not read, as in
    the JAX package (the head passes each point's stride and range).
    ``plain_iou`` computes the IoU matrix with the plain version on the
    card (a reference run)."""

    def __init__(self, num_classes: int, topk: int = 15, alpha: float = 1.0,
                 beta: float = 6.0, gamma: float = 1e-7,
                 angle_version: str = 'le90',
                 featmap_strides: Sequence[int] = (8, 16, 32),
                 regress_ranges=((-1, 96), (96, 192), (192, 384)),
                 bbox_coder: Optional[dict] = None,
                 iou_calculator: Optional[dict] = None,
                 center_radius: float = 1.5, plain_iou: bool = False):
        self.num_classes = num_classes
        self.topk = topk
        self.center_radius = center_radius
        self.coder = DistanceAnglePointCoder(angle_range=angle_version)
        self.plain_iou = plain_iou

    @torch.no_grad()
    def cost(self, points, strides, ranges, gt_bboxes, gt_labels, gt_mask,
             bbox_preds, angle_preds, cls_scores) -> dict:
        """The assignment's terms over (B, N, G): ``cost`` (0 outside the
        gate), ``gate``, ``centerness``, the sides ``left``, ``top``,
        ``right``, ``bottom`` of each point in each gt's frame, and the gts'
        ``areas`` (B, 1, G). Arguments as :meth:`assign`'s."""
        gt_bboxes = gt_bboxes.float()
        b, n = bbox_preds.shape[:2]
        g = gt_bboxes.shape[1]
        gx, gy, gw, gh, ga = gt_bboxes[:, None].unbind(-1)    # (B, 1, G)
        areas = gw * gh
        cos_a, sin_a = torch.cos(ga), torch.sin(ga)
        dx = points[None, :, 0, None] - gx                     # (B, N, G)
        dy = points[None, :, 1, None] - gy
        ox = dx * cos_a + dy * sin_a
        oy = -dx * sin_a + dy * cos_a
        left, right = gw / 2 + ox, gw / 2 - ox
        top, bottom = gh / 2 + oy, gh / 2 - oy
        inside = torch.minimum(torch.minimum(left, top),
                               torch.minimum(right, bottom)) > 0
        ndx = 2 * ox / gw.clamp(min=1e-6)
        ndy = 2 * oy / gh.clamp(min=1e-6)
        centerness = (1 - torch.sqrt((ndx ** 2 + ndy ** 2 + 1e-8) / 2)
                      ).clamp(min=0)
        radius = self.center_radius * strides[None, :, None]
        inside &= (ox.abs() < radius) & (oy.abs() < radius)
        max_reg = torch.maximum(torch.maximum(left, top),
                                torch.maximum(right, bottom))
        gate = inside & (max_reg >= ranges[None, :, 0, None]) & \
            (max_reg <= ranges[None, :, 1, None]) & gt_mask[:, None, :]

        pred_full = torch.cat([bbox_preds.float() * strides[None, :, None],
                               angle_preds.float()], -1)
        det = self.coder.decode(points[None], pred_full)       # (B, N, 5)
        probs = torch.softmax(cls_scores.float(), -1)          # (B, N, C)
        iou = rbbox_overlaps(det, gt_bboxes, plain=self.plain_iou)
        safe = gt_labels.long().clamp(0, probs.shape[-1] - 1)
        cls_prob = probs.gather(2, safe[:, None, :].expand(b, n, g))
        cost = (0.2 * centerness + 0.2 * iou + 0.6 * cls_prob) * gate
        return dict(cost=cost, gate=gate, centerness=centerness, left=left,
                    top=top, right=right, bottom=bottom, areas=areas)

    @torch.no_grad()
    def assign(self, points, strides, ranges, gt_bboxes, gt_labels, gt_mask,
               bbox_preds, angle_preds, cls_scores) -> Tuple[torch.Tensor,
                                                             ...]:
        """points (N, 2), strides (N,), ranges (N, 2); padded gts (B, G, 5)
        / (B, G) / (B, G); predictions (B, N, 4) in strides, (B, N, 1),
        (B, N, C) logits. Returns labels (B, N), stride-normalized (l, t,
        r, b) targets (B, N, 4), angle targets (B, N) and positives (B, N),
        float32 where they are real numbers."""
        terms = self.cost(points, strides, ranges, gt_bboxes, gt_labels,
                          gt_mask, bbox_preds, angle_preds, cls_scores)
        cost, gate, centerness = (terms[k] for k in ('cost', 'gate',
                                                     'centerness'))
        areas = terms['areas']
        b, n, g = cost.shape
        k = min(self.topk, n)
        top_vals, top_idx = topk_candidates(cost.transpose(1, 2), k)
        chosen = torch.zeros((b, g, n), dtype=torch.bool,
                             device=cost.device)
        chosen.scatter_(2, top_idx, top_vals > 0)
        valid = gate & chosen.transpose(1, 2)

        eff_area = torch.where(valid, areas, torch.zeros_like(areas))
        max_area = eff_area.amax(-1)
        idx = torch.argmax(eff_area, -1)                        # (B, N)
        pos = max_area > 0

        # orphan gts: rematched to their point of largest centerness; of
        # the gts sharing that point, the highest index writes
        has_match = torch.zeros((b, g), device=cost.device).scatter_reduce(
            1, idx, pos.float(), 'amax') > 0
        orphan = gt_mask & ~has_match
        best_pt = torch.argmax(centerness, 1)                   # (B, G)
        gt_index = torch.arange(g, device=cost.device).expand(b, g)
        writer = torch.full((b, n), -1, dtype=torch.long,
                            device=cost.device).scatter_reduce(
            1, best_pt, gt_index, 'amax')
        written = writer >= 0
        w = writer.clamp(min=0)
        takes = written & orphan.gather(1, w)
        idx = torch.where(takes, w, idx)
        pos = pos | takes

        labels = torch.where(pos, gt_labels.long().gather(1, idx),
                             torch.full_like(idx, self.num_classes))
        pick = idx[..., None]
        sides = torch.cat([terms[t].gather(2, pick) for t in
                           ('left', 'top', 'right', 'bottom')], -1)
        bbox_targets = sides / strides[None, :, None]
        angle_targets = gt_bboxes[..., 4].float().gather(1, idx)
        return labels, bbox_targets, angle_targets, pos


@HEADS.register_module()
class RotatedYOLOv8Head(nn.Module):
    """``forward`` returns (cls_scores, bbox_preds, angle_preds), per-level
    NCHW maps; the regression in strides, float32. The head is built from
    the widths its inputs really have (``feat_widths``, the neck's
    ``out_widths``; the JAX head infers them), its towers from
    ``make_divisible(in_channels, widen_factor)``. ``norm_cfg``,
    ``act_cfg`` and ``init_cfg`` are accepted and not read."""

    takes_widths = True

    def __init__(self, num_classes: int = 15,
                 in_channels: Sequence[int] = (256, 512, 768),
                 widen_factor: float = 1.0, reg_max: int = 0,
                 featmap_strides: Sequence[int] = (8, 16, 32),
                 regress_ranges=((-1, 96), (96, 192), (192, 384)),
                 bbox_coder: Optional[dict] = None,
                 loss_cls: Optional[dict] = None,
                 loss_bbox: Optional[dict] = None,
                 norm_cfg: Optional[dict] = None,
                 act_cfg: Optional[dict] = None,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None,
                 init_cfg: Optional[dict] = None,
                 feat_widths: Optional[Sequence[int]] = None):
        super().__init__()
        self.num_classes = num_classes
        self.reg_max = reg_max
        self.featmap_strides = list(featmap_strides)
        self.regress_ranges = [tuple(float(v) for v in r)
                               for r in regress_ranges]
        self.test_cfg = dict(test_cfg or {})
        self.coder = DistanceAnglePointCoder(
            angle_range=(bbox_coder or {}).get('angle_version', 'le90'))
        self.prior_generator = MlvlPointGenerator(self.featmap_strides,
                                                  offset=0.5)
        assigner = dict((train_cfg or {}).get('assigner') or dict(
            type='OBBLabelAssigner', num_classes=num_classes,
            featmap_strides=list(featmap_strides),
            regress_ranges=regress_ranges, topk=15))
        self.assigner = BBOX_ASSIGNERS.build(assigner)
        self.cls_loss = LOSSES.build(dict(loss_cls or dict(type='FocalLoss')))
        self.bbox_loss = LOSSES.build(dict(
            loss_bbox or dict(type='RotatedIoULoss')))
        chans = [make_divisible(c, widen_factor) for c in in_channels]
        widths = list(feat_widths) if feat_widths is not None else chans
        if len(widths) != len(self.featmap_strides):
            raise ValueError(f'{len(widths)} input maps for '
                             f'{len(self.featmap_strides)} strides')
        self.reg_out = max(16, chans[0] // 4, reg_max * 4)
        self.cls_out = max(chans[0], num_classes)
        for i, cin in enumerate(widths):
            self.build_level(i, cin)
        self._point_cache: Dict[tuple, tuple] = {}

    # ---- network ------------------------------------------------------------
    def tower(self, name: str, cin: int, cout: int) -> None:
        self.add_module(f'{name}_0', YOLOConvModule(cin, cout, 3))
        self.add_module(f'{name}_1', YOLOConvModule(cout, cout, 3))

    def run_tower(self, name: str, x):
        return getattr(self, f'{name}_1')(getattr(self, f'{name}_0')(x))

    def build_level(self, i: int, cin: int) -> None:
        self.tower(f'cls_conv_{i}', cin, self.cls_out)
        self.add_module(f'cls_pred_{i}',
                        nn.Conv2d(self.cls_out, self.num_classes, 1))
        self.tower(f'reg_conv_{i}', cin, self.reg_out)
        if self.reg_max > 1:
            self.add_module(f'reg_pred_{i}', nn.Conv2d(
                self.reg_out, (1 + self.reg_max) * 4, 1))
        else:
            self.add_module(f'reg_pred_{i}', nn.Conv2d(self.reg_out, 4, 1))
            self.add_module(f'scale_{i}', Scale())
        self.tower(f'ang_conv_{i}', cin, self.cls_out)
        self.add_module(f'ang_pred_{i}', nn.Conv2d(self.cls_out, 1, 1))

    def regression(self, i: int, r):
        """The level's float32 (l, t, r, b) in strides from its reg tower:
        ``Scale`` and a clip at 0, or DFL's expectation over ``1 + reg_max``
        bins a side (softmax in float32)."""
        pred = getattr(self, f'reg_pred_{i}')(r)
        if self.reg_max > 1:
            n_bins = 1 + self.reg_max
            b, _, h, w = pred.shape
            prob = pred.float().reshape(b, 4, n_bins, h, w).softmax(2)
            proj = torch.arange(n_bins, dtype=torch.float32,
                                device=pred.device)
            return (prob * proj[:, None, None]).sum(2)
        return getattr(self, f'scale_{i}')(pred).float().clamp(min=0)

    def forward_level(self, i: int, x) -> tuple:
        c = self.run_tower(f'cls_conv_{i}', x)
        r = self.run_tower(f'reg_conv_{i}', x)
        a = self.run_tower(f'ang_conv_{i}', x)
        return (getattr(self, f'cls_pred_{i}')(c), self.regression(i, r),
                getattr(self, f'ang_pred_{i}')(a))

    def forward(self, feats):
        if len(feats) != len(self.featmap_strides):
            raise ValueError(f'{len(feats)} maps for '
                             f'{len(self.featmap_strides)} strides')
        per_level = [self.forward_level(i, x) for i, x in enumerate(feats)]
        return tuple(tuple(out) for out in zip(*per_level))

    def prior_biases(self) -> dict:
        """Output conv name -> its initial bias: the class prior
        ``log(5 / num_classes / (1024 / stride)^2)``, 1 for the regression
        (without DFL) and the angle."""
        out = {}
        for i, s in enumerate(self.featmap_strides):
            out[f'cls_pred_{i}'] = math.log(
                5 / self.num_classes / (1024 / s) ** 2)
            if self.reg_max <= 1:
                out[f'reg_pred_{i}'] = 1.0
            out[f'ang_pred_{i}'] = 1.0
        return out

    @torch.no_grad()
    def init_cls_prior(self):
        """The JAX package's bias initializers (:meth:`prior_biases`)."""
        for name, value in self.prior_biases().items():
            getattr(self, name).bias.fill_(value)

    # ---- flattening ---------------------------------------------------------
    def _flat(self, outputs):
        """(cls (B, N, C), boxes (B, N, 4), angles (B, N, 1)), location-major
        over the levels, in the maps' dtypes."""
        cls_scores, bbox_preds, angle_preds = outputs[:3]
        b = cls_scores[0].shape[0]
        return (_flat(cls_scores, b, self.num_classes),
                _flat(bbox_preds, b, 4), _flat(angle_preds, b, 1))

    def flat_points(self, featmap_sizes, device):
        """(N, 2) points over every level, their (N,) strides and (N, 2)
        regress ranges, float32 on ``device``."""
        key = (tuple(tuple(s) for s in featmap_sizes), str(device))

        def make():
            pts = self.prior_generator.grid_priors(featmap_sizes, device)
            strides = [torch.full((len(p),), float(self.featmap_strides[i]),
                                  device=device) for i, p in enumerate(pts)]
            ranges = [torch.tensor(self.regress_ranges[i],
                                   device=device).expand(len(p), 2)
                      for i, p in enumerate(pts)]
            return torch.cat(pts), torch.cat(strides), torch.cat(ranges)

        return cached(self._point_cache, key, make)

    # ---- loss ---------------------------------------------------------------
    def targets(self, outputs, gt_bboxes, gt_labels, gt_mask) -> tuple:
        """The assigner's (labels, bbox targets, angle targets, positives)
        for ``forward``'s outputs, in a ``yolov8.targets`` range."""
        cls_flat, box_flat, ang_flat = self._flat(outputs)
        featmap_sizes = [tuple(s.shape[-2:]) for s in outputs[0]]
        points, strides, ranges = self.flat_points(featmap_sizes,
                                                   cls_flat.device)
        with record_function('yolov8.targets'):
            return self.assigner.assign(
                points, strides, ranges, gt_bboxes, gt_labels, gt_mask,
                box_flat.detach(), ang_flat.detach(), cls_flat.detach())

    def box_loss(self, points, box_flat, ang_flat, bt, at, pw):
        """Rotated IoU loss of prediction and target decoded in the
        stride-normalized space, over the positives."""
        pred = self.coder.decode(points[None], torch.cat([box_flat,
                                                          ang_flat], -1))
        tgt = self.coder.decode(points[None], torch.cat([bt, at[..., None]],
                                                        -1))
        return self.bbox_loss(pred, tgt, weight=pw,
                              avg_factor=pw.sum().clamp(min=1.0))

    def cls_term(self, outputs, cls_flat, labels, num_pos):
        return self.cls_loss(cls_flat, labels,
                             weight=torch.ones_like(labels, dtype=torch.float),
                             avg_factor=num_pos)

    def loss(self, outputs, gt_bboxes, gt_labels, gt_mask):
        """dict(loss_cls, loss_bbox) of float32 scalars; the loss terms in
        a ``yolov8.loss`` range."""
        labels, bt, at, pos = self.targets(outputs, gt_bboxes, gt_labels,
                                           gt_mask)
        return self.losses(outputs, labels, bt, at, pos)

    def losses(self, outputs, labels, bt, at, pos) -> dict:
        with record_function('yolov8.loss'):
            cls_flat, box_flat, ang_flat = (t.float()
                                            for t in self._flat(outputs))
            featmap_sizes = [tuple(s.shape[-2:]) for s in outputs[0]]
            points = self.flat_points(featmap_sizes, cls_flat.device)[0]
            pw = pos.float()
            num_pos = pos.sum().float().clamp(min=1.0)
            return dict(
                loss_cls=self.cls_term(outputs, cls_flat, labels, num_pos),
                loss_bbox=self.box_loss(points, box_flat, ang_flat, bt, at,
                                        pw))

    # ---- inference ----------------------------------------------------------
    def score_logits(self, outputs):
        """The per-level class logits that rank and score the detections."""
        return outputs[0]

    def get_bboxes(self, outputs, img_shape=None, scale_factor=None,
                   rescale: bool = False, cfg=None,
                   plain_pair_mask: bool = False):
        """Per image the top ``nms_pre`` points by their largest raw logit
        (stable: the lowest index wins a tie), only those decoded, sigmoid
        scores with a zero background column, then multiclass rotated NMS
        (the pair-mask kernel on the card), in a ``yolov8.decode_nms``
        range. Returns (dets (B, max_per_img, 6), labels, valid)."""
        cfg = cfg if cfg is not None else self.test_cfg
        if cfg.get('approx_topk', False):
            raise ValueError('test_cfg.approx_topk=True asks for an '
                             'approximate top-k, which the port does not '
                             'have; set it False for the exact top-k')
        with record_function('yolov8.decode_nms'):
            logits = self.score_logits(outputs)
            b = logits[0].shape[0]
            cls_flat = _flat(logits, b, self.num_classes)
            _, box_flat, ang_flat = self._flat(outputs)
            featmap_sizes = [tuple(s.shape[-2:]) for s in logits]
            points, strides, _ = self.flat_points(featmap_sizes,
                                                  cls_flat.device)
            k = min(int(cfg.get('nms_pre', 2000)), cls_flat.shape[1])
            _, top = topk_candidates(cls_flat.amax(-1).float(), k)

            def take(t):
                return t.gather(1, top[..., None].expand(
                    -1, -1, t.shape[-1])).float()

            scores = torch.sigmoid(take(cls_flat))
            pred = torch.cat([take(box_flat) * strides[top][..., None],
                              take(ang_flat)], -1)
            boxes = self.coder.decode(points[top], pred, max_shape=img_shape)
            if rescale and scale_factor is not None:
                sf = boxes.new_tensor(scale_factor)[:2].repeat(2)
                boxes = torch.cat([boxes[..., :4] / sf, boxes[..., 4:]], -1)
            scores = torch.cat([scores, scores.new_zeros(scores.shape[:2]
                                                         + (1,))], -1)
            nms_cfg = cfg.get('nms', {'iou_thr': 0.1})
            return multiclass_nms_rotated(
                boxes, scores, score_thr=float(cfg.get('score_thr', 0.05)),
                iou_thr=float(nms_cfg.get('iou_thr', 0.1)),
                max_per_img=int(cfg.get('max_per_img', 2000)),
                max_candidates=int(cfg.get('max_candidates', 2000)),
                plain_pair_mask=plain_pair_mask)


@HEADS.register_module()
class RotatedYOLOv8AngleHead(RotatedYOLOv8Head):
    """:class:`RotatedYOLOv8Head` with an angle loss on the positives
    (``loss_angle``, by default ``SmoothL1Loss(beta=0.1,
    loss_weight=0.2)``) on top of the rotated IoU loss. The JAX package
    assigns twice (once in each loss); the port once, with the same
    result."""

    def __init__(self, loss_angle: Optional[dict] = None, **kwargs):
        super().__init__(**kwargs)
        self.angle_loss = LOSSES.build(dict(loss_angle or dict(
            type='SmoothL1Loss', beta=0.1, loss_weight=0.2)))

    def losses(self, outputs, labels, bt, at, pos) -> dict:
        out = super().losses(outputs, labels, bt, at, pos)
        with record_function('yolov8.loss'):
            ang = self._flat(outputs)[2][..., 0].float()
            pw = pos.float()
            out['loss_angle'] = self.angle_loss(
                ang, at, weight=pw, avg_factor=pw.sum().clamp(min=1.0))
        return out
