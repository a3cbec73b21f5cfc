"""The configs of the other two-stage families build in the port, and the
two faults found before their port stay repaired:

- every Gliding Vertex, RoI Transformer and Rotated Faster R-CNN config
  builds its detector on the CPU (build only), the three Swin ones with
  the ported ``SwinTransformer``;
- each of the 13 configs that the Swin, ConvNeXt and ReDet modules
  unlocked builds its detector on the CPU (build only);
- the ATSS HBB config builds (its head's ``assign_by_circumhbbox`` no
  longer reaches ``ATSSObbAssigner``, which takes none) and its head loss
  equals the JAX package's on the same features and weights (rtol 1e-4:
  float32 sums in another order);
- a detector served through ``DetectorBundle`` then takes the same train
  step as a fresh one (the heads' anchor and coder caches are no longer
  inference tensors): GWD and KFIoU, exactly on the CPU.
"""

import copy
import glob
import os.path as osp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orientedobjectdetection_tpu.utils.registry import HEADS as J_HEADS
from orientedobjectdetection_torch.apis import init_detector
from orientedobjectdetection_torch.models import build_detector
from orientedobjectdetection_torch.parallel import (build_optimizer,
                                                    create_train_state,
                                                    make_train_step)
from orientedobjectdetection_torch.utils import Config
from orientedobjectdetection_torch.utils.jax_weights import \
    from_jax_variables
from orientedobjectdetection_torch.utils.registry import HEADS
from test_torch_retina_variants import (SIZE, STRIDES, anchor_gts,
                                        fill_variables)

torch.set_num_threads(1)

ROOT = osp.join(osp.dirname(__file__), '..')
FAMILY_CONFIGS = sorted(
    glob.glob(osp.join(ROOT, 'configs', 'gliding_vertex', '*.py')) +
    glob.glob(osp.join(ROOT, 'configs', 'roi_trans', '*.py')) +
    glob.glob(osp.join(ROOT, 'configs', 'rotated_faster_rcnn', '*.py')) +
    glob.glob(osp.join(ROOT, 'configs', 'kfiou', 'roi_trans_*.py')))
SWIN = [c for c in FAMILY_CONFIGS if 'swin' in osp.basename(c)]
BUILT = [c for c in FAMILY_CONFIGS if c not in SWIN]
# the configs that the Swin, ConvNeXt and ReDet modules made buildable
UNLOCKED = sorted(
    glob.glob(osp.join(ROOT, 'configs', '**', '*swin*.py'), recursive=True) +
    glob.glob(osp.join(ROOT, 'configs', 'convnext', '*.py')) +
    glob.glob(osp.join(ROOT, 'configs', 'redet', '*.py')))
UNLOCKED_BACKBONE = {'swin': 'SwinTransformer', 'convnext': 'ConvNeXt',
                     'redet': 'ReResNet'}
DETECTOR = {'gliding_vertex': 'GlidingVertex', 'roi_trans': 'RoITransformer',
            'rotated_faster_rcnn': 'RotatedFasterRCNN',
            'kfiou': 'RoITransformer'}
ATSS_HBB = osp.join(ROOT, 'configs', 'rotated_atss',
                    'rotated_atss_hbb_r50_fpn_1x_dota_oc.py')


def test_the_family_configs_are_counted():
    assert len(FAMILY_CONFIGS) == 19 and len(BUILT) == 16 and len(SWIN) == 3
    assert len(UNLOCKED) == 13


@pytest.mark.parametrize('config', BUILT,
                         ids=[osp.basename(c) for c in BUILT])
def test_config_builds(config):
    det = build_detector(dict(Config.fromfile(config).model))
    family = osp.basename(osp.dirname(config))
    assert type(det).__name__ == DETECTOR[family]
    assert type(det.rpn_head).__name__ == 'RotatedRPNHead'


@pytest.mark.parametrize('config', SWIN, ids=[osp.basename(c) for c in SWIN])
def test_swin_configs_raise_naming_the_backbone(config):
    """The Swin configs of these families build, with the ported backbone
    at the published widths (the name is kept from when they raised)."""
    det = build_detector(dict(Config.fromfile(config).model))
    family = osp.basename(osp.dirname(config))
    assert type(det).__name__ == DETECTOR[family]
    assert type(det.backbone).__name__ == 'SwinTransformer'
    assert det.neck.in_channels == [96, 192, 384, 768]


@pytest.mark.parametrize('config', UNLOCKED,
                         ids=[osp.basename(c) for c in UNLOCKED])
def test_unlocked_config_builds(config):
    det = build_detector(dict(Config.fromfile(config).model))
    name = osp.basename(config)
    kind = 'redet' if name.startswith('redet') else \
        'swin' if 'swin' in name else 'convnext'
    assert type(det.backbone).__name__ == UNLOCKED_BACKBONE[kind]
    if kind == 'redet':
        assert type(det).__name__ == 'ReDet'
        assert type(det.neck).__name__ == 'ReFPN'
        assert det.roi_head.rotation_invariant


# ---- C.1: the ATSS HBB config ------------------------------------------------
def test_atss_hbb_config_builds_and_its_loss_matches_jax():
    """R18, a 32-wide FPN and head, one stacked conv, 4 classes, 128 px:
    the head's loss on seeded features, weights and gts."""
    model = copy.deepcopy(dict(Config.fromfile(ATSS_HBB).model))
    assert model['bbox_head']['assign_by_circumhbbox'] == 'oc'
    model['backbone'] = dict(model['backbone'], depth=18, init_cfg=None)
    model['neck'] = dict(model['neck'], in_channels=[64, 128, 256, 512],
                         out_channels=32)
    model['bbox_head'] = dict(model['bbox_head'], num_classes=4,
                              in_channels=32, feat_channels=32,
                              stacked_convs=1)
    det = build_detector(model)
    assert type(det.bbox_head.assigner).__name__ == 'ATSSObbAssigner'
    head_cfg = dict(model['bbox_head'], train_cfg=model['train_cfg'],
                    test_cfg=model['test_cfg'])
    rng = np.random.default_rng(7)
    feats = [rng.normal(0, 1, (2, SIZE // s, SIZE // s, 32))
             .astype(np.float32) for s in STRIDES]
    gts = anchor_gts(rng, head_cfg)
    jh = J_HEADS.build(dict(head_cfg))
    shapes = jax.eval_shape(jh.init, jax.random.PRNGKey(0),
                            [jnp.asarray(f) for f in feats])
    variables = fill_variables(shapes, rng)
    ref = jax.jit(lambda p: jh.loss(
        jh.apply({'params': p}, [jnp.asarray(f) for f in feats]),
        *map(jnp.asarray, gts)))(variables['params'])
    head = HEADS.build(dict(head_cfg))
    head.load_state_dict({k[len('bbox_head.'):]: v for k, v in
                          from_jax_variables({'params': {
                              'bbox_head': variables['params']}}).items()})
    with torch.no_grad():
        out = head([torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats])
        losses = head.loss(out, *map(torch.from_numpy, gts))
    assert sorted(losses) == sorted(ref) == ['loss_bbox', 'loss_cls']
    for k, v in losses.items():
        assert float(ref[k]) > 0
        np.testing.assert_allclose(float(v), float(ref[k]), rtol=1e-4,
                                   err_msg=k)


# ---- C.2: serving, then training the same module ---------------------------
@pytest.mark.parametrize('name', ['gwd/gwd_tiny_synth.py',
                                  'kfiou/kfiou_tiny_synth.py'])
def test_serving_then_training_takes_a_fresh_step(name):
    """One bundle call fills the heads' caches; the train step that follows
    on the same module equals a fresh module's, metrics and parameters."""
    cfg = Config.fromfile(osp.join(ROOT, 'configs', name))
    rng = np.random.default_rng(8)
    images = torch.from_numpy(rng.uniform(0, 255, (2, SIZE, SIZE, 3))
                              .astype(np.float32))
    gts = np.zeros((2, 8, 5), np.float32)
    gts[:, :3] = [[40, 50, 30, 20, 0.3], [80, 80, 40, 25, -0.5],
                  [60, 30, 24, 20, 0.1]]
    batch = dict(images=images, gt_bboxes=torch.from_numpy(gts),
                 gt_labels=torch.zeros(2, 8, dtype=torch.long),
                 gt_mask=torch.arange(8)[None].expand(2, 8) < 3)

    def step(detector):
        tx = build_optimizer(dict(type='sgd', momentum=0.9), 0.01)
        state = create_train_state(detector, tx, device='cpu')
        state, metrics = make_train_step(detector, tx,
                                         device_norm=cfg.img_norm_cfg)(
            state, batch)
        return detector, metrics

    bundle = init_detector(cfg, device='cpu', device_norm=cfg.img_norm_cfg)
    dets, _, valid = bundle(images)
    assert dets.shape[0] == 2
    served, metrics = step(bundle.detector)
    fresh, ref = step(build_detector(dict(cfg.model)))
    assert sorted(metrics) == sorted(ref)
    for k, v in metrics.items():
        assert torch.isfinite(v) and torch.equal(v, ref[k]), k
    for (n, p), q in zip(served.named_parameters(), fresh.parameters()):
        assert torch.equal(p, q), n
