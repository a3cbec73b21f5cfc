"""Every config under ``configs/jy/`` built with the port, cut as the JAX
package's ``test_forward._shrink`` cuts it (backbone and neck at deepen
0.33 / widen 0.125, the head as published), through one loss, its
backward and one decode on 64 px images: the losses finite and
non-negative, the detections finite and padded (and the MSDCN head's
offsets seeded at 0, as the JAX package initializes them)."""

import copy
import glob
import os.path as osp

import numpy as np
import pytest
import torch

from orientedobjectdetection_torch.models import build_detector
from orientedobjectdetection_torch.utils import Config
from test_torch_yolov8 import random_gts

torch.set_num_threads(1)

ROOT = osp.join(osp.dirname(__file__), '..')
JY_CONFIGS = sorted(glob.glob(osp.join(ROOT, 'configs', 'jy', '*.py')))


def shrunk(path):
    """The config's model cut as ``test_forward._shrink`` cuts it: backbone
    and neck at deepen 0.33 / widen 0.125, the head as published; NMS at
    100 candidates a class."""
    m = copy.deepcopy(dict(Config.fromfile(path).model))
    m['backbone'] = dict(m['backbone'], deepen_factor=0.33,
                         widen_factor=0.125)
    m['neck'] = dict(m['neck'], deepen_factor=0.33, widen_factor=0.125)
    small = dict(nms_pre=100, max_per_img=20, max_candidates=128)
    m['test_cfg'] = dict(m.get('test_cfg') or {}, **small)
    if m['bbox_head'].get('test_cfg'):
        m['bbox_head'] = dict(m['bbox_head'],
                              test_cfg=dict(m['bbox_head']['test_cfg'],
                                            **small))
    return m


def test_the_jy_configs_are_listed():
    assert len(JY_CONFIGS) == 9


@pytest.mark.parametrize('path', JY_CONFIGS,
                         ids=[osp.basename(p) for p in JY_CONFIGS])
def test_jy_config_takes_a_loss_and_a_decode(path):
    """Each ``configs/jy/`` model (backbone and neck shrunk) builds, gives
    finite positive losses on 64 px images with padded gts, and decodes."""
    torch.manual_seed(0)
    det = build_detector(shrunk(path))
    det.init_weights(0)
    # the JAX initializers: zero offsets of the MSDCN head's samplings
    assert not any(m.weight.any() for n, m in det.named_modules()
                   if n.endswith('_dcn_0.offset'))
    classes = det.bbox_head.num_classes
    rng = np.random.default_rng(1)
    images = torch.from_numpy(rng.normal(0, 1, (2, 3, 64, 64)).astype(
        np.float32))
    gts, labels, mask = random_gts(rng, valid=3, classes=classes, size=64)
    outputs = det(images)
    losses = det.loss_from_outputs(outputs, dict(
        gt_bboxes=torch.from_numpy(gts), gt_labels=torch.from_numpy(labels),
        gt_mask=torch.from_numpy(mask)))
    assert set(losses) >= {'loss_cls', 'loss_bbox'}
    for k, v in losses.items():
        assert torch.isfinite(v) and float(v.detach()) >= 0, k
    sum(losses.values()).backward()
    with torch.no_grad():
        dets, labels, valid = det.bboxes_from_outputs(det(images))
    assert dets.shape == (2, 20, 6) and torch.isfinite(dets).all()
    assert (labels[~valid] == -1).all()

