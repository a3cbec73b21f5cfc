"""Port parity, RoI Transformer (``configs/roi_trans/roi_trans_tiny_synth.py``:
R18, 64-wide FPN, 2 classes, at 128 px) and its KFIoU recipe
(``configs/kfiou/roi_trans_kfiou_ln_r50_fpn_1x_dota_le90.py`` narrowed to
R18 and 64 channels, its 15 classes and per-class KFIoU stage-1 head kept)
against the JAX package on the same random weights: the weight mapping of
the stage heads (``roi_head.bbox_head.{i}``), the cascade's serving
outputs and detections, each stage's sampled RoIs (the JAX draws swapped
in; stage 0 takes every proposal as valid, as the JAX package does), and
one train step's losses, gradients and parameter update
(:class:`test_torch_rotated_rpn.Family`).

Tolerances: the last stage's RoIs 1e-3 (decoded from float32 network
outputs) and class scores 1e-4; sampled labels exact, RoIs 1e-3; the rest
as the harness states.
"""

import copy
import os.path as osp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orientedobjectdetection_torch.apis import init_detector
from orientedobjectdetection_torch.utils import Config
from test_torch_rotated_rpn import CONFIGS, Family
from test_torch_rotated_rpn import jax_draws  # noqa: F401 (a fixture)

torch.set_num_threads(1)

TINY = osp.join(CONFIGS, 'roi_trans', 'roi_trans_tiny_synth.py')
KFIOU = osp.join(CONFIGS, 'kfiou', 'roi_trans_kfiou_ln_r50_fpn_1x_dota_le90.py')
LOSSES = ['loss_rpn_cls', 'loss_rpn_bbox', 's0_loss_cls', 's0_loss_bbox',
          's1_loss_cls', 's1_loss_bbox']


def narrow_kfiou():
    """The published KFIoU RoI Transformer at R18 / 64 channels / 256-wide
    FC layers, with the tiny configs' proposal and sample counts."""
    model = copy.deepcopy(dict(Config.fromfile(KFIOU).model))
    model['backbone'] = dict(model['backbone'], depth=18, init_cfg=None)
    model['neck'] = dict(model['neck'], in_channels=[64, 128, 256, 512],
                         out_channels=64)
    model['rpn_head'] = dict(model['rpn_head'], in_channels=64,
                             feat_channels=64)
    roi = dict(model['roi_head'])
    roi['bbox_head'] = [dict(h, in_channels=64, fc_out_channels=256)
                        for h in roi['bbox_head']]
    model['roi_head'] = roi
    model['train_cfg'] = dict(
        model['train_cfg'],
        rpn_proposal=dict(nms_pre=512, max_per_img=256, nms=dict(iou_thr=0.7),
                          min_bbox_size=0),
        rcnn=[dict(s, sampler=dict(s['sampler'], num=128))
              for s in model['train_cfg']['rcnn']])
    model['test_cfg'] = dict(
        rpn=dict(nms_pre=512, max_per_img=256, nms=dict(iou_thr=0.7),
                 min_bbox_size=0),
        rcnn=dict(nms_pre=256, score_thr=0.05, nms=dict(iou_thr=0.1),
                  max_per_img=100))
    return model


@pytest.fixture(scope='module')
def family():
    return Family(TINY, 80)


@pytest.fixture(scope='module')
def kfiou():
    return Family(KFIOU, 90, model=narrow_kfiou())


def test_weights_round_trip(family):
    family.check_weights()
    assert {'roi_head.bbox_head.0.fc_reg.weight',
            'roi_head.bbox_head.1.shared_fcs.1.bias'} <= set(family.state)


def test_serving_matches_jax(family):
    """Detections, and the cascade's last-stage RoIs and scores."""
    outputs = family.check_serving()['roi_outputs']
    ref = jax.jit(family.jdet.apply)(family.variables,
                                     jnp.asarray(family.images))
    ref = ref['roi_outputs']
    assert outputs['rois'].shape == (2, 256, 5)
    np.testing.assert_allclose(outputs['rois'].numpy(),
                               np.asarray(ref['rois']), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(outputs['cls_score'].numpy(),
                               np.asarray(ref['cls_score']), atol=1e-4)
    # stage 1 pools rotated RoIs: stage 0 turned the theta-0 proposals
    assert (outputs['rois'][..., 4].abs() > 1e-3).float().mean() > 0.5


def test_bundle_reads_the_last_stage_head():
    bundle = init_detector(KFIOU, device='cpu')
    assert bundle.num_classes == 15
    assert not bundle.detector.roi_head.bbox_head[1].reg_class_agnostic


def check_stages(outputs, ref):
    """Each stage's sampled labels exactly and RoIs within 1e-3."""
    for i, (got, want) in enumerate(zip(outputs['stage_data'], ref)):
        np.testing.assert_array_equal(got['labels'].numpy(),
                                      np.asarray(want['labels']),
                                      err_msg=f'stage {i}')
        np.testing.assert_allclose(got['rois'].numpy(),
                                   np.asarray(want['rois']), rtol=1e-4,
                                   atol=1e-3, err_msg=f'stage {i}')
        assert float(got['num_pos']) >= 1


def test_train_step_losses_and_gradients_match_jax(family, jax_draws):
    outputs = family.check_step0(LOSSES)
    check_stages(outputs, family.j_outputs['stage_data'])
    assert float(family.j_losses['s1_loss_bbox']) > 0


def test_make_train_step_matches_jax(family, jax_draws):
    family.check_train_step()


def test_kfiou_train_step_matches_jax(kfiou, jax_draws):
    """The KFIoU stage-1 head (per-class regression read at the labels,
    ``KFLoss`` on the decoded boxes): step-0 losses and gradients, then
    one ``make_train_step``."""
    outputs = kfiou.check_step0(LOSSES)
    check_stages(outputs, kfiou.j_outputs['stage_data'])
    assert outputs['stage_data'][1]['bbox_pred'].shape[-1] == 15 * 5
    kfiou.check_train_step()
