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

import math
from typing import Optional

import torch
from torch import nn

from ...utils.registry import BACKBONES, DETECTORS, HEADS, NECKS


@DETECTORS.register_module()
class RotatedSingleStageDetector(nn.Module):
    """Input NCHW images; ``forward`` returns the head's per-level
    (cls_scores, bbox_preds) NCHW maps."""

    def __init__(self, backbone: dict, neck: Optional[dict] = None,
                 bbox_head: Optional[dict] = None,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None,
                 pretrained: Optional[str] = None,
                 init_cfg: Optional[dict] = None):
        super().__init__()
        self.backbone = BACKBONES.build(dict(backbone))
        self.neck = NECKS.build(dict(neck)) if neck is not None else None
        head = dict(bbox_head)
        if head.get('train_cfg') is None:
            head['train_cfg'] = train_cfg
        if head.get('test_cfg') is None:
            head['test_cfg'] = test_cfg
        self.bbox_head = HEADS.build(head)

    @torch.no_grad()
    def init_weights(self, seed: int = 0):
        """Seeded random weights from a CPU ``torch.Generator``: LeCun-normal
        convolution weights, zero biases, identity frozen BN, and the head's
        focal prior bias. The same seed gives the same weights on any
        device as long as the module is still on the CPU."""
        gen = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               / math.sqrt(fan_in))
                if m.bias is not None:
                    m.bias.zero_()
        self.bbox_head.init_cls_prior()

    def forward(self, images):
        x = self.backbone(images)
        if self.neck is not None:
            x = self.neck(x)
        return self.bbox_head(x)

    def loss_from_outputs(self, outputs, batch):
        """The head's losses for ``forward``'s outputs on a padded batch."""
        ignore = {}
        if 'gt_ignore' in batch:
            ignore = dict(gt_ignore=batch['gt_ignore'],
                          gt_ignore_mask=batch['gt_ignore_mask'])
        return self.bbox_head.loss(outputs, batch['gt_bboxes'],
                                   batch['gt_labels'], batch['gt_mask'],
                                   **ignore)

    def bboxes_from_outputs(self, outputs, img_shape=None, cfg=None,
                            plain_pair_mask: bool = False):
        return self.bbox_head.get_bboxes(outputs, img_shape=img_shape,
                                         cfg=cfg,
                                         plain_pair_mask=plain_pair_mask)


@DETECTORS.register_module()
class RotatedRetinaNet(RotatedSingleStageDetector):
    """Thin alias (reference ``detectors/rotated_retinanet.py``)."""
