"""Refine detectors: S2ANet and R3Det (counterpart of
``orientedobjectdetection_tpu/models/detectors/refine_detectors.py``;
reference ``detectors/s2anet.py:9-135``, ``r3det.py:13-147`` and
``detectors/utils.py``).

- S2ANet: FAM head -> every location's anchor decoded into a roi ->
  AlignConv (each location's 3x3 rotated roi grid sampled, then a dense
  projection) -> ODM head on the rois.
- R3Det: RetinaNet stage 0 -> each location's best anchor decoded into a
  roi -> per refine stage: FeatureRefineModule (5x1, 1x5 and 1x1 convs,
  re-sampled at each location's roi, added to the input) -> refine head
  on the rois -> its decoded boxes, the next stage's rois.

The rois are detached float32 (B, N, 5), N the locations over all levels
(stop_gradient in the JAX package). The sampling is plain PyTorch
(:mod:`...ops.feature_align`). Training and serving run the same forward;
the detectors take no ignore regions, as in the JAX package.

The stages run inside ``torch.profiler.record_function`` ranges named
``refine.*``: ``first_stage`` (backbone, neck and the FAM / stage-0 head),
``rois`` (decoding the rois), ``align`` (AlignConv, or FeatureRefineModule
with its convolutions), ``head`` (ODM / refine heads) and ``decode_nms``;
in training also ``first_loss`` and ``refine_loss`` (each stage's
assigner, targets and loss terms).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from ...ops.feature_align import align_conv_sample, rotated_feature_align
from ...utils.registry import BACKBONES, DETECTORS, HEADS, NECKS
from .single_stage import init_seeded_weights

_STRIDES = (8, 16, 32, 64, 128)


class AlignConv(nn.Module):
    """One level's aligned convolution (reference ``detectors/utils.py
    :40-91``): the 3 x 3 taps of each location's roi grid
    (:func:`align_conv_sample`) times ``deform_conv.weight`` ``(C, C, 3,
    3)`` (tap ``(ky, kx)`` meets ``weight[:, :, ky, kx]``), then ReLU.
    ``deform_conv`` holds the weight and is not called."""

    def __init__(self, channels: int, stride: int):
        super().__init__()
        self.stride = stride
        self.deform_conv = nn.Conv2d(channels, channels, 3, padding=1,
                                     bias=False)

    def forward(self, x, rois):
        """x (B, C, H, W); rois (B, H*W, 5) -> (B, C, H, W)."""
        b, c, h, w = x.shape
        taps = align_conv_sample(x, rois, float(self.stride),
                                 3).to(x.dtype)
        weight = self.deform_conv.weight
        out = torch.matmul(weight.reshape(weight.shape[0], -1),
                           taps.reshape(b, -1, h * w))
        return F.relu(out.reshape(b, -1, h, w))


class AlignConvModule(nn.Module):
    """S2ANet's per-level AlignConvs, ``ac.{i}`` (reference
    ``detectors/utils.py:94-133``)."""

    def __init__(self, channels: int, featmap_strides: Sequence[int]):
        super().__init__()
        self.ac = nn.ModuleList(AlignConv(channels, s)
                                for s in featmap_strides)

    def forward(self, feats, rois_per_level):
        return [ac(x, rois) for ac, x, rois in
                zip(self.ac, feats, rois_per_level)]


class FeatureRefineModule(nn.Module):
    """R3Det's feature refinement (reference ``detectors/utils.py
    :136-206``), one for all levels: ``conv_1_5(conv_5_1(x)) +
    conv_1_1(x)`` re-sampled at each location's roi centre, added to
    ``x``. The sum is taken in float32 and cast to ``x``'s dtype."""

    def __init__(self, channels: int, featmap_strides: Sequence[int]):
        super().__init__()
        self.strides = list(featmap_strides)
        self.conv_5_1 = nn.Conv2d(channels, channels, (5, 1), padding=(2, 0))
        self.conv_1_5 = nn.Conv2d(channels, channels, (1, 5), padding=(0, 2))
        self.conv_1_1 = nn.Conv2d(channels, channels, 1)

    def forward(self, feats, rois_per_level):
        outs = []
        for x, rois, stride in zip(feats, rois_per_level, self.strides):
            mixed = self.conv_1_5(self.conv_5_1(x)) + self.conv_1_1(x)
            aligned = rotated_feature_align(mixed, rois, 1.0 / stride)
            outs.append((x + aligned).to(x.dtype))
        return outs


def split_levels(flat: torch.Tensor, featmap_sizes) -> list:
    """(B, N, 5) -> per level (B, H*W, 5) views."""
    return list(flat.split([h * w for h, w in featmap_sizes], 1))


def first_stage_rois(head, outputs) -> torch.Tensor:
    """The first stage's rois: each location's best anchor decoded
    (:meth:`AnchorHead.filter_bboxes`; with one anchor a location, that
    anchor), detached float32 (B, N, 5)."""
    return torch.cat(head.filter_bboxes(
        [s.detach() for s in outputs[0]],
        [d.detach() for d in outputs[1]]), 1)


def _head_cfg(cfg: dict, train_cfg, test_cfg) -> dict:
    cfg = dict(cfg)
    if cfg.get('train_cfg') is None:
        cfg['train_cfg'] = train_cfg
    if cfg.get('test_cfg') is None:
        cfg['test_cfg'] = test_cfg
    return cfg


class _RefineDetector(nn.Module):
    """Backbone and neck of both refine detectors."""

    def __init__(self, backbone: dict, neck: Optional[dict],
                 train_cfg: Optional[dict], test_cfg: Optional[dict]):
        super().__init__()
        self.train_cfg = train_cfg or {}
        self.test_cfg = test_cfg or {}
        self.backbone = BACKBONES.build(dict(backbone))
        self.neck = NECKS.build(dict(neck)) if neck is not None else None

    def extract_feat(self, images):
        x = self.backbone(images)
        return self.neck(x) if self.neck is not None else x

    def init_weights(self, seed: int = 0):
        """Seeded random weights (:func:`init_seeded_weights`) and every
        head's focal prior bias."""
        init_seeded_weights(self, seed)
        for head in self.heads():
            head.init_cls_prior()

    def bboxes_from_outputs(self, outputs, img_shape=None, scale_factor=None,
                            rescale: bool = False, cfg=None,
                            plain_pair_mask: bool = False):
        """The last stage's decode + NMS over its rois, with the detector's
        ``test_cfg``. ``scale_factor`` and ``rescale`` are accepted and not
        read, as in the JAX package."""
        head, outs, rois = self.last_stage(outputs)
        with record_function('refine.decode_nms'):
            return head.get_bboxes_with_anchors(
                outs, rois, cfg=cfg if cfg is not None else self.test_cfg,
                img_shape=img_shape, plain_pair_mask=plain_pair_mask)


@DETECTORS.register_module()
class S2ANet(_RefineDetector):
    """FAM head -> AlignConv -> ODM head (reference ``s2anet.py``).
    ``forward`` returns ``dict(fam_outputs, rois (B, N, 5), odm_outputs)``,
    each outputs a head's (cls_scores, bbox_preds) NCHW maps."""

    def __init__(self, backbone: dict, neck: Optional[dict] = None,
                 fam_head: Optional[dict] = None,
                 align_cfgs: Optional[dict] = None,
                 odm_head: Optional[dict] = None,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None,
                 pretrained: Optional[str] = None,
                 init_cfg: Optional[dict] = None):
        super().__init__(backbone, neck, train_cfg, test_cfg)
        self.fam_head = HEADS.build(_head_cfg(
            fam_head, self.train_cfg.get('fam_cfg'), self.test_cfg))
        self.align_conv = AlignConvModule(
            neck['out_channels'],
            (align_cfgs or {}).get('featmap_strides', _STRIDES))
        self.odm_head = HEADS.build(_head_cfg(
            odm_head, self.train_cfg.get('odm_cfg'), self.test_cfg))

    def heads(self):
        return [self.fam_head, self.odm_head]

    def forward(self, images, batch=None, train: bool = False, rng=None):
        """``batch``, ``train`` and ``rng`` are accepted for the two-stage
        detectors' interface and not read."""
        with record_function('refine.first_stage'):
            feats = self.extract_feat(images)
            fam_outputs = self.fam_head(feats)
        with record_function('refine.rois'):
            rois = first_stage_rois(self.fam_head, fam_outputs)
        sizes = [tuple(f.shape[-2:]) for f in feats]
        with record_function('refine.align'):
            aligned = self.align_conv(feats, split_levels(rois, sizes))
        with record_function('refine.head'):
            odm_outputs = self.odm_head(aligned)
        return dict(fam_outputs=fam_outputs, rois=rois,
                    odm_outputs=odm_outputs)

    def loss_from_outputs(self, outputs, batch):
        """``fam_loss_cls``, ``fam_loss_bbox``, ``odm_loss_cls`` and
        ``odm_loss_bbox``."""
        gts = (batch['gt_bboxes'], batch['gt_labels'], batch['gt_mask'])
        with record_function('refine.first_loss'):
            losses = {f'fam_{k}': v for k, v in
                      self.fam_head.loss(outputs['fam_outputs'],
                                         *gts).items()}
        with record_function('refine.refine_loss'):
            losses.update(self.odm_head.loss_with_anchors(
                outputs['odm_outputs'], outputs['rois'], *gts,
                prefix='odm_'))
        return losses

    def last_stage(self, outputs):
        return self.odm_head, outputs['odm_outputs'], outputs['rois']


@DETECTORS.register_module()
class R3Det(_RefineDetector):
    """RetinaNet stage 0 -> refine stages (reference ``r3det.py``), one a
    ``refine_heads`` entry, each with its FeatureRefineModule
    (``feat_refine_module.{i}``; every stage takes ``frm_cfgs[0]``'s
    strides, as the JAX package does) and refine head
    (``refine_head.{i}``). ``forward`` returns ``dict(s0_outputs,
    stage_outputs, stage_rois, final_rois)``: stage ``i`` ran on
    ``stage_rois[i]`` and gave ``stage_outputs[i]``."""

    def __init__(self, backbone: dict, neck: Optional[dict] = None,
                 bbox_head: Optional[dict] = None,
                 frm_cfgs: Optional[list] = None,
                 refine_heads: Optional[list] = None,
                 num_refine_stages: int = 1,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None,
                 pretrained: Optional[str] = None,
                 init_cfg: Optional[dict] = None):
        super().__init__(backbone, neck, train_cfg, test_cfg)
        self.bbox_head = HEADS.build(_head_cfg(
            bbox_head, self.train_cfg.get('s0'), self.test_cfg))
        strides = (frm_cfgs or [{}])[0].get('featmap_strides', _STRIDES)
        sr = self.train_cfg.get('sr')
        self.feat_refine_module = nn.ModuleList()
        self.refine_head = nn.ModuleList()
        for i, head in enumerate(refine_heads or []):
            self.feat_refine_module.append(FeatureRefineModule(
                neck['out_channels'], strides))
            self.refine_head.append(HEADS.build(_head_cfg(
                head, sr[i] if isinstance(sr, (list, tuple)) else sr,
                self.test_cfg)))

    def heads(self):
        return [self.bbox_head, *self.refine_head]

    def forward(self, images, batch=None, train: bool = False, rng=None):
        """``batch``, ``train`` and ``rng`` are accepted for the two-stage
        detectors' interface and not read."""
        with record_function('refine.first_stage'):
            feats = self.extract_feat(images)
            s0_outputs = self.bbox_head(feats)
        with record_function('refine.rois'):
            rois = first_stage_rois(self.bbox_head, s0_outputs)
        sizes = [tuple(f.shape[-2:]) for f in feats]
        stage_outputs, stage_rois = [], []
        for frm, head in zip(self.feat_refine_module, self.refine_head):
            with record_function('refine.align'):
                feats = frm(feats, split_levels(rois, sizes))
            with record_function('refine.head'):
                out = head(feats)
            stage_outputs.append(out)
            stage_rois.append(rois)
            with record_function('refine.rois'):
                rois = head.refine_bboxes(out, rois)
        return dict(s0_outputs=s0_outputs, stage_outputs=stage_outputs,
                    stage_rois=stage_rois, final_rois=rois)

    def loss_from_outputs(self, outputs, batch):
        """``s0_loss_cls``, ``s0_loss_bbox`` and, per refine stage ``i``,
        ``sr{i}_loss_cls`` and ``sr{i}_loss_bbox`` scaled by
        ``train_cfg.stage_loss_weights[i]`` (1 where it has no entry)."""
        gts = (batch['gt_bboxes'], batch['gt_labels'], batch['gt_mask'])
        with record_function('refine.first_loss'):
            losses = {f's0_{k}': v for k, v in
                      self.bbox_head.loss(outputs['s0_outputs'],
                                          *gts).items()}
        weights = self.train_cfg.get('stage_loss_weights', [1.0] * 8)
        for i, (head, out, rois) in enumerate(zip(
                self.refine_head, outputs['stage_outputs'],
                outputs['stage_rois'])):
            w = float(weights[i]) if i < len(weights) else 1.0
            with record_function('refine.refine_loss'):
                stage = head.loss_with_anchors(out, rois, *gts,
                                               prefix=f'sr{i}_')
            losses.update({k: v * w for k, v in stage.items()})
        return losses

    def last_stage(self, outputs):
        return (self.refine_head[-1], outputs['stage_outputs'][-1],
                outputs['stage_rois'][-1])
