"""Two-stage rotated detector (counterpart of
``orientedobjectdetection_tpu/models/detectors/two_stage.py``; reference
``detectors/two_stage.py:11-195``).

Test: backbone -> neck -> RPN head -> proposals -> RoI head, then the RoI
head's decode and NMS. Train: backbone -> neck -> RPN head; proposals from
the detached RPN outputs with ``train_cfg.rpn_proposal``; the RoI head
samples a fixed RoI set per image, pools it under autograd and classifies
it; ``loss_from_outputs`` adds the RPN losses and the RoI head's.

The stages run inside ``torch.profiler.record_function`` ranges named
``two_stage.*``, so a profile splits by stage: ``network_rpn`` and
``proposals`` in both modes; ``roialign_head`` and ``decode_nms`` when
serving; ``sample_rois``, ``roi_pool``, ``rpn_targets`` (inside the RPN
head's loss) and ``roi_loss`` when training. RoI Transformer's stages have
a range each: ``roialign_head_{i}`` when serving, ``sample_rois_{i}`` and
``roi_pool_{i}`` when training.

``ReDet`` (JAX ``two_stage.py:299-303``) is the same detector on the
equivariant ``ReResNet`` / ``ReFPN`` with the ``RiRoIAlignRotated`` RoI
layer, whose roll has its own range, ``two_stage.ri_roll``.
``RotatedFasterRCNN`` is the same detector with the horizontal-proposal
RPN and :class:`RotatedStandardRoIHead`; ``GlidingVertex`` and
``RoITransformer`` (JAX ``two_stage.py:132-296``) keep its construction,
its RPN stage and its ranges, and return their RoI heads' own outputs:
serving ``dict(proposals, head_outputs)`` and ``dict(roi_outputs)``,
training ``dict(rpn_outputs, targets, head_outputs)`` and
``dict(rpn_outputs, stage_data)``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.profiler import record_function

from ...utils.registry import BACKBONES, DETECTORS, HEADS, NECKS
from .single_stage import init_seeded_weights


@DETECTORS.register_module()
class RotatedTwoStageDetector(nn.Module):
    """Input NCHW images. ``forward`` returns, when serving,
    ``dict(proposals (B, R, 5), prop_valid (B, R), cls_score (B, R, C+1),
    bbox_pred (B, R, 5))``; in training what the losses need (see
    :meth:`forward`)."""

    def __init__(self, backbone: dict, neck: Optional[dict] = None,
                 rpn_head: Optional[dict] = None,
                 roi_head: Optional[dict] = None,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None,
                 pretrained: Optional[str] = None,
                 init_cfg: Optional[dict] = None):
        super().__init__()
        self.train_cfg = train_cfg or {}
        self.test_cfg = test_cfg or {}
        self.backbone = BACKBONES.build(dict(backbone))
        self.neck = NECKS.build(dict(neck)) if neck is not None else None
        rpn = dict(rpn_head)
        rpn.setdefault('train_cfg', self.train_cfg.get('rpn'))
        rpn.setdefault('test_cfg', self.test_cfg.get('rpn'))
        self.rpn_head = HEADS.build(rpn)
        roi = dict(roi_head)
        roi.setdefault('train_cfg', self.train_cfg.get('rcnn'))
        roi.setdefault('test_cfg', self.test_cfg.get('rcnn'))
        self.roi_head = HEADS.build(roi)

    def init_weights(self, seed: int = 0):
        """Seeded random weights (:func:`init_seeded_weights`): LeCun-normal
        convolution and linear weights, zero biases, identity frozen BN."""
        init_seeded_weights(self, seed)

    def extract_feat(self, images):
        x = self.backbone(images)
        return self.neck(x) if self.neck is not None else x

    def assigners(self) -> list:
        """The assigners in the order a train step runs them: the RPN's,
        then each RoI stage's (set ``plain_iou`` on each for a reference
        run)."""
        return [self.rpn_head.assigner, *self.roi_head.assigners]

    def network_rpn(self, images):
        with record_function('two_stage.network_rpn'):
            feats = self.extract_feat(images)
            return feats, self.rpn_head(feats)

    def proposals(self, rpn_outputs, train: bool, batch=None, rng=None):
        """The RPN's proposals: in training from its detached outputs with
        ``train_cfg.rpn_proposal``, where the RoI stage will need the
        ``batch`` and the ``rng`` (raises without them). Returns
        (proposals, valid)."""
        if train and (batch is None or rng is None):
            raise ValueError('two-stage training needs the batch and an rng')
        cfg = self.train_cfg.get('rpn_proposal', self.test_cfg.get('rpn')) \
            if train else self.test_cfg.get('rpn')
        with record_function('two_stage.proposals'), torch.no_grad():
            proposals, _, valid = self.rpn_head.get_proposals(rpn_outputs,
                                                              cfg=cfg)
        return proposals, valid

    def rpn_losses(self, outputs, batch) -> dict:
        return self.rpn_head.loss(outputs['rpn_outputs'], batch['gt_bboxes'],
                                  batch['gt_labels'], batch['gt_mask'])

    def forward(self, images, batch=None, train: bool = False, rng=None,
                plain_roi_align: bool = False):
        """``train=True`` takes the padded ``batch`` (its ``gt_bboxes``,
        ``gt_labels`` and ``gt_mask``) and ``rng``, a
        :class:`~orientedobjectdetection_torch.core.SampleKey` for the RoI
        sampling, and returns ``dict(rpn_outputs, rois, labels,
        label_weights, bbox_targets, bbox_weights, num_pos, cls_score,
        bbox_pred)``. ``plain_roi_align`` serves with the RoIAlign kernel's
        plain version."""
        feats, rpn_outputs = self.network_rpn(images)
        if train:
            return self._forward_train(feats, rpn_outputs, batch, rng)
        proposals, prop_valid = self.proposals(rpn_outputs, False)
        with record_function('two_stage.roialign_head'):
            cls_score, bbox_pred = self.roi_head(
                feats, proposals, plain_roi_align=plain_roi_align)
        return dict(proposals=proposals, prop_valid=prop_valid,
                    cls_score=cls_score, bbox_pred=bbox_pred)

    def _forward_train(self, feats, rpn_outputs, batch, rng):
        proposals, prop_valid = self.proposals(rpn_outputs, True, batch, rng)
        with record_function('two_stage.sample_rois'):
            rois, labels, label_weights, bbox_targets, bbox_weights, \
                num_pos = self.roi_head.sample_rois(
                    proposals, prop_valid, batch['gt_bboxes'],
                    batch['gt_labels'], batch['gt_mask'], rng)
        with record_function('two_stage.roi_pool'):
            pooled = self.roi_head.pool(feats, rois, train=True)
        cls_score, bbox_pred = self.roi_head.bbox_head(pooled)
        return dict(rpn_outputs=rpn_outputs, rois=rois, labels=labels,
                    label_weights=label_weights, bbox_targets=bbox_targets,
                    bbox_weights=bbox_weights, num_pos=num_pos,
                    cls_score=cls_score, bbox_pred=bbox_pred)

    def loss_from_outputs(self, outputs, batch):
        """The RPN's losses (``loss_rpn_cls``, ``loss_rpn_bbox``) and the RoI
        head's (``loss_cls``, ``loss_bbox``) for ``forward(train=True)``'s
        outputs on a padded batch. The box loss's count of positives is
        taken from the box weights, not from ``num_pos``, so that it is the
        whole batch's when a data-parallel step gathers the outputs."""
        losses = self.rpn_losses(outputs, batch)
        with record_function('two_stage.roi_loss'):
            losses.update(self.roi_head.bbox_head.loss(
                outputs['cls_score'], outputs['bbox_pred'], outputs['rois'],
                outputs['labels'], outputs['label_weights'],
                outputs['bbox_targets'], outputs['bbox_weights'],
                outputs['bbox_weights'].sum().clamp(min=1.0)))
        return losses

    def bboxes_from_outputs(self, outputs, img_shape=None, scale_factor=None,
                            rescale: bool = False, cfg=None,
                            plain_pair_mask: bool = False):
        """Decode + NMS of the serving outputs. ``scale_factor`` and
        ``rescale`` are accepted and not read, as in the JAX package."""
        cfg = cfg if cfg is not None else self.test_cfg.get('rcnn')
        with record_function('two_stage.decode_nms'):
            return self.roi_head.get_bboxes(
                outputs['proposals'], outputs['cls_score'],
                outputs['bbox_pred'], cfg=cfg, img_shape=img_shape,
                plain_pair_mask=plain_pair_mask)


@DETECTORS.register_module()
class OrientedRCNN(RotatedTwoStageDetector):
    """Thin alias (reference ``detectors/oriented_rcnn.py``)."""


@DETECTORS.register_module()
class RotatedFasterRCNN(RotatedTwoStageDetector):
    """Thin alias (reference ``detectors/rotate_faster_rcnn.py``): with
    ``RotatedRPNHead`` and ``RotatedStandardRoIHead``, proposals are
    horizontal ``(B, R, 4)``."""


@DETECTORS.register_module()
class GlidingVertex(RotatedTwoStageDetector):
    """Gliding Vertex (reference ``detectors/gliding_vertex.py``):
    horizontal RPN -> :class:`GVRatioRoIHead`. Serving returns
    ``dict(proposals (B, R, 4), head_outputs)``, the head's four outputs;
    training ``dict(rpn_outputs, targets, head_outputs)``."""

    def forward(self, images, batch=None, train: bool = False, rng=None,
                plain_roi_align: bool = False):
        feats, rpn_outputs = self.network_rpn(images)
        if train:
            proposals, prop_valid = self.proposals(rpn_outputs, True, batch,
                                                   rng)
            with record_function('two_stage.sample_rois'):
                targets = self.roi_head.sample_rois(
                    proposals, prop_valid, batch['gt_bboxes'],
                    batch['gt_labels'], batch['gt_mask'], rng)
            with record_function('two_stage.roi_pool'):
                pooled = self.roi_head.pool(feats, targets[0], train=True)
            return dict(rpn_outputs=rpn_outputs, targets=targets,
                        head_outputs=self.roi_head.bbox_head(pooled))
        proposals, _ = self.proposals(rpn_outputs, False)
        with record_function('two_stage.roialign_head'):
            head_outputs = self.roi_head(feats, proposals,
                                         plain_roi_align=plain_roi_align)
        return dict(proposals=proposals, head_outputs=head_outputs)

    def loss_from_outputs(self, outputs, batch):
        """The RPN's losses and the head's ``loss_cls``, ``loss_bbox``,
        ``loss_fix`` and ``loss_ratio``."""
        losses = self.rpn_losses(outputs, batch)
        with record_function('two_stage.roi_loss'):
            losses.update(self.roi_head.loss(outputs['head_outputs'],
                                             outputs['targets']))
        return losses

    def bboxes_from_outputs(self, outputs, img_shape=None, scale_factor=None,
                            rescale: bool = False, cfg=None,
                            plain_pair_mask: bool = False):
        cfg = cfg if cfg is not None else self.test_cfg.get('rcnn')
        with record_function('two_stage.decode_nms'):
            return self.roi_head.get_bboxes(
                outputs['proposals'], outputs['head_outputs'], cfg=cfg,
                img_shape=img_shape, plain_pair_mask=plain_pair_mask)


@DETECTORS.register_module()
class RoITransformer(RotatedTwoStageDetector):
    """RoI Transformer (reference ``detectors/roi_transformer.py``):
    horizontal RPN -> :class:`RoITransRoIHead`'s cascade. Serving returns
    ``dict(roi_outputs)`` (the last stage's RoIs and outputs); training
    ``dict(rpn_outputs, stage_data)``."""

    def forward(self, images, batch=None, train: bool = False, rng=None,
                plain_roi_align: bool = False):
        feats, rpn_outputs = self.network_rpn(images)
        if train:
            proposals, _ = self.proposals(rpn_outputs, True, batch, rng)
            return dict(rpn_outputs=rpn_outputs,
                        stage_data=self.roi_head.forward_train(
                            feats, proposals, batch, rng))
        proposals, _ = self.proposals(rpn_outputs, False)
        return dict(roi_outputs=self.roi_head(
            feats, proposals, plain_roi_align=plain_roi_align))

    def loss_from_outputs(self, outputs, batch):
        """The RPN's losses and each stage's, ``s{i}_loss_cls`` and
        ``s{i}_loss_bbox``."""
        losses = self.rpn_losses(outputs, batch)
        with record_function('two_stage.roi_loss'):
            losses.update(self.roi_head.loss(outputs['stage_data']))
        return losses

    def bboxes_from_outputs(self, outputs, img_shape=None, scale_factor=None,
                            rescale: bool = False, cfg=None,
                            plain_pair_mask: bool = False):
        cfg = cfg if cfg is not None else self.test_cfg.get('rcnn')
        with record_function('two_stage.decode_nms'):
            return self.roi_head.get_bboxes(
                outputs['roi_outputs'], cfg=cfg, img_shape=img_shape,
                plain_pair_mask=plain_pair_mask)


@DETECTORS.register_module()
class ReDet(RotatedTwoStageDetector):
    """Thin alias (reference ``detectors/redet.py``): ``ReResNet`` ->
    ``ReFPN`` -> oriented RPN -> ``RiRoIAlignRotated`` RoI head."""
