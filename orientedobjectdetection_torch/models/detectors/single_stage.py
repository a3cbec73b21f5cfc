"""Single-stage rotated detector (counterpart of
``orientedobjectdetection_tpu/models/detectors/single_stage.py``):
backbone -> neck -> head, then the head's batched loss, or its batched
decode and NMS.

The training batch is padded, with its masks carried explicitly:

    batch = {
        'images':    (B, H, W, 3),
        'gt_bboxes': (B, G, 5) float,
        'gt_labels': (B, G)    int,
        'gt_mask':   (B, G)    bool,
        # optional ignore regions, routed to the assigner:
        'gt_ignore': (B, K, 5), 'gt_ignore_mask': (B, K),
    }
"""

from __future__ import annotations

import inspect
import math
from typing import Optional

import torch
from torch import nn

from ...utils.registry import BACKBONES, DETECTORS, HEADS, NECKS
from ..utils_rotation import ORConv2d

# the layers with a weight and a bias: seeded by init_seeded_weights, cast
# to the serving dtype by init_detector
WEIGHTED_LAYERS = (nn.Conv2d, nn.Linear, ORConv2d)


@torch.no_grad()
def init_seeded_weights(module: nn.Module, seed: int = 0) -> None:
    """Seeded random weights from a CPU ``torch.Generator``: LeCun-normal
    weights of the ``WEIGHTED_LAYERS`` (convolutions, linear layers and
    ORConv2d's 5-D filters), zero biases; frozen BN keeps its identity
    statistics. A steerable ORConv2d's free parameter is its basis
    coefficients, seeded in the same way; a module with other parameters
    or another initializer (the adaptive rotated convolution's experts,
    ESE's ``normal(0.001)`` conv) seeds them with its
    ``init_seeded(generator)``; parameters with a constant initializer keep
    the value they were built with. The same seed gives the same
    weights on any device as long as the module is still on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if hasattr(m, 'init_seeded'):
            m.init_seeded(gen)
        elif isinstance(m, WEIGHTED_LAYERS):
            w = m.coeff if getattr(m, 'steerable', False) else m.weight
            w.copy_(torch.randn(w.shape, generator=gen)
                    / math.sqrt(w[0].numel()))
            if m.bias is not None:
                m.bias.zero_()


def build_fed(registry, cfg: dict, source: nn.Module) -> nn.Module:
    """Build ``cfg`` from ``registry``; a module that needs its input
    widths (``takes_widths``, the YOLO necks and heads: flax infers them,
    PyTorch cannot) gets the widths ``source`` really produces
    (``source.out_widths``) as ``feat_widths``."""
    cfg = dict(cfg)
    widths = getattr(source, 'out_widths', None)
    if getattr(registry.get(cfg['type']), 'takes_widths', False) and \
            widths is not None:
        cfg['feat_widths'] = list(widths)
    return registry.build(cfg)


@DETECTORS.register_module()
class RotatedSingleStageDetector(nn.Module):
    """Input NCHW images; ``forward`` returns the head's per-level NCHW
    maps: (cls_scores, bbox_preds), with angle_clses after them for a CSL
    head, or (cls_scores, bbox_preds, angle_preds, centernesses) for
    FCOS. A neck or head is built with its input widths where it needs
    them (:func:`build_fed`)."""

    def __init__(self, backbone: dict, neck: Optional[dict] = None,
                 bbox_head: Optional[dict] = None,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None,
                 pretrained: Optional[str] = None,
                 init_cfg: Optional[dict] = None):
        super().__init__()
        self.backbone = BACKBONES.build(dict(backbone))
        self.neck = build_fed(NECKS, neck, self.backbone) \
            if neck is not None else None
        head = dict(bbox_head)
        if head.get('train_cfg') is None:
            head['train_cfg'] = train_cfg
        if head.get('test_cfg') is None:
            head['test_cfg'] = test_cfg
        self.bbox_head = build_fed(HEADS, head, self.neck or self.backbone)

    def init_weights(self, seed: int = 0):
        """Seeded random weights (:func:`init_seeded_weights`) and the
        head's focal prior bias."""
        init_seeded_weights(self, seed)
        self.bbox_head.init_cls_prior()

    def forward(self, images, batch=None, train: bool = False, rng=None):
        """``batch``, ``train`` and ``rng`` are accepted for the two-stage
        detectors' interface and not read: a single-stage head assigns its
        targets in the loss."""
        x = self.backbone(images)
        if self.neck is not None:
            x = self.neck(x)
        return self.bbox_head(x)

    def loss_from_outputs(self, outputs, batch):
        """The head's losses for ``forward``'s outputs on a padded batch.
        The batch's ignore regions reach a head whose ``loss`` takes them;
        the others drop them, as in the JAX package."""
        ignore = {}
        takes_ignore = 'gt_ignore' in inspect.signature(
            self.bbox_head.loss).parameters
        if 'gt_ignore' in batch and takes_ignore:
            ignore = dict(gt_ignore=batch['gt_ignore'],
                          gt_ignore_mask=batch['gt_ignore_mask'])
        return self.bbox_head.loss(outputs, batch['gt_bboxes'],
                                   batch['gt_labels'], batch['gt_mask'],
                                   **ignore)

    def bboxes_from_outputs(self, outputs, img_shape=None, scale_factor=None,
                            rescale: bool = False, cfg=None,
                            plain_pair_mask: bool = False):
        return self.bbox_head.get_bboxes(
            outputs, img_shape=img_shape, scale_factor=scale_factor,
            rescale=rescale, cfg=cfg, plain_pair_mask=plain_pair_mask)


@DETECTORS.register_module()
class RotatedRetinaNet(RotatedSingleStageDetector):
    """Thin alias (reference ``detectors/rotated_retinanet.py``)."""


@DETECTORS.register_module()
class RotatedFCOS(RotatedSingleStageDetector):
    """Thin alias (reference ``detectors/rotated_fcos.py``)."""


@DETECTORS.register_module()
class RotatedYOLOv8(RotatedSingleStageDetector):
    """Thin alias (reference ``detectors/rotated_yolov8.py:7-17``): the jy
    heads, whose ``forward`` returns (cls_scores, bbox_preds,
    angle_preds), with the objectness maps after them for the decoupled
    heads; the loss and the decode take the outputs as they are."""


@DETECTORS.register_module()
class RotatedRepPoints(RotatedSingleStageDetector):
    """Thin alias (reference ``detectors/rotated_reppoints.py``): the
    point-set heads, whose ``forward`` returns (cls_scores, pts_inits,
    pts_refines), and Oriented RepPoints' correlation maps after them."""
