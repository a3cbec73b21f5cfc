"""Port parity, the Oriented R-CNN serving slice: geometry, HBB NMS, the
midpoint-offset coder, FPN without extra convolutions, the RPN head and its
proposals, the RoI head and its decode, the weight mapping, and the whole
slice, each against the JAX package on the same inputs.

The model is ``configs/oriented_rcnn/oriented_rcnn_tiny_synth.py``
(ResNet-18, 64-wide FPN, 2 classes) with random numpy weights carried by
``from_jax_variables``. Each stage is fed the JAX stage's inputs, because
the discrete steps between the stages (top-k, NMS, level routing) would turn
a last-bit difference upstream into a different box downstream.

Tolerances: geometry, coder and IoU 1e-5 (float32 element-wise math);
network outputs rtol 1e-4 (same weights, other convolution algorithms and
summation order); proposals and RoI-head outputs 1e-4; detections 1e-3
(float32 network, then decode and NMS on the same candidates); valid flags
and labels exact.
"""

import os.path as osp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orientedobjectdetection_tpu.apis.inference import \
    DetectorBundle as JBundle
from orientedobjectdetection_tpu.core.coders import \
    MidpointOffsetCoder as JMidpoint
from orientedobjectdetection_tpu.models import build_detector as j_build
from orientedobjectdetection_tpu.ops import boxes as j_boxes
from orientedobjectdetection_tpu.ops import nms as j_nms
from orientedobjectdetection_tpu.utils.config import Config as JConfig
from orientedobjectdetection_tpu.utils.registry import HEADS as JHEADS
from orientedobjectdetection_tpu.utils.registry import NECKS as JNECKS
from orientedobjectdetection_torch.apis import (inference_detector,
                                                init_detector)
from orientedobjectdetection_torch.core import MidpointOffsetCoder
from orientedobjectdetection_torch.models import build_detector
from orientedobjectdetection_torch.models.necks import FPN
from orientedobjectdetection_torch.ops import (hbb2obb, hbb_overlaps,
                                               nms_hbb, obb2xyxy)
from orientedobjectdetection_torch.utils import Config
from orientedobjectdetection_torch.utils.jax_weights import (
    from_jax_variables, to_jax_layout)

torch.set_num_threads(1)

CONFIGS = osp.join(osp.dirname(__file__), '..', 'configs', 'oriented_rcnn')
TINY = osp.join(CONFIGS, 'oriented_rcnn_tiny_synth.py')
R50 = osp.join(CONFIGS, 'oriented_rcnn_r50_fpn_1x_dota_le90.py')
SIZE = 128


def random_obbs(n, seed, extent=200.0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(0, extent, n), rng.uniform(0, extent, n),
                     rng.uniform(4, 80, n), rng.uniform(4, 80, n),
                     rng.uniform(-np.pi, np.pi, n)], -1).astype(np.float32)


def random_xyxy(shape, seed, extent=100.0):
    rng = np.random.default_rng(seed)
    x1 = rng.uniform(0, extent, shape)
    y1 = rng.uniform(0, extent, shape)
    return np.stack([x1, y1, x1 + rng.uniform(2, 40, shape),
                     y1 + rng.uniform(2, 40, shape)], -1).astype(np.float32)


# ---- geometry, NMS, coder ---------------------------------------------------
@pytest.mark.parametrize('version', ['oc', 'le90', 'le135'])
def test_obb2xyxy_and_hbb2obb_match_jax(version):
    obbs = random_obbs(200, 0)
    got = obb2xyxy(torch.from_numpy(obbs), version)
    ref = np.asarray(j_boxes.obb2xyxy(jnp.asarray(obbs), version))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    hbbs = random_xyxy((200,), 1)
    hbbs[:20, 2] = hbbs[:20, 0] + (hbbs[:20, 3] - hbbs[:20, 1])   # squares
    got = hbb2obb(torch.from_numpy(hbbs), version)
    ref = np.asarray(j_boxes.hbb2obb(jnp.asarray(hbbs), version))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


def test_hbb_overlaps_matches_jax():
    b1, b2 = random_xyxy((70,), 2), random_xyxy((90,), 3)
    b2[:5] = b1[:5]
    b1[-1] = 0.0                                       # zero-size box
    ref = np.asarray(j_nms.hbb_overlaps(jnp.asarray(b1), jnp.asarray(b2)))
    got = hbb_overlaps(torch.from_numpy(b1), torch.from_numpy(b2))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)
    assert (got[-1] == 0).all() and np.allclose(got[:5].diagonal(), 1.0)
    batched = hbb_overlaps(torch.from_numpy(np.stack([b1, b1[::-1]])),
                           torch.from_numpy(np.stack([b2, b2])))
    np.testing.assert_allclose(batched[0].numpy(), ref, atol=1e-6)
    np.testing.assert_allclose(batched[1].numpy(), ref[::-1], atol=1e-6)


@pytest.mark.parametrize('n,thr', [(150, 0.5), (150, 0.8), (700, 0.3)])
def test_nms_hbb_matches_jax_with_ties_and_padding(n, thr):
    """Score ties (the lowest index wins), exact duplicates and masked
    padding; n = 700 crosses the 512-row block of the pair mask."""
    rng = np.random.default_rng(n)
    boxes = random_xyxy((2, n), 4)
    boxes[:, 1::3] = boxes[:, 0:-1:3][:, :boxes[:, 1::3].shape[1]]
    scores = rng.uniform(0, 1, (2, n)).astype(np.float32)
    scores[:, ::4] = 0.5                               # ties
    valid = np.ones((2, n), bool)
    valid[:, -n // 5:] = False
    valid[1, :7] = False
    keep, order = nms_hbb(torch.from_numpy(boxes), torch.from_numpy(scores),
                          thr, valid_mask=torch.from_numpy(valid))
    for i in range(2):
        r_keep, r_order = j_nms.nms_hbb(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]), thr,
            valid_mask=jnp.asarray(valid[i]))
        np.testing.assert_array_equal(keep[i].numpy(), np.asarray(r_keep))
        np.testing.assert_array_equal(order[i].numpy(), np.asarray(r_order))
    assert 0 < keep.sum() < valid.sum()
    assert not keep[~torch.from_numpy(valid)].any()


@pytest.mark.parametrize('max_shape', [None, (96, 128)])
def test_midpoint_offset_coder_matches_jax(max_shape):
    cfg = dict(angle_range='le90', target_stds=(1., 1., 1., 1., 0.5, 0.5))
    n = 300
    rng = np.random.default_rng(5)
    props = random_xyxy((n,), 6, extent=128.0)
    deltas = rng.normal(0, 0.7, (n, 6)).astype(np.float32)
    deltas[:10, 4:] = 3.0                              # clipped to 0.5
    deltas[10:20, 2:4] = 9.0                           # clipped ratio
    got = MidpointOffsetCoder(**cfg).decode(
        torch.from_numpy(props), torch.from_numpy(deltas),
        max_shape=max_shape)
    ref = np.asarray(JMidpoint(**cfg).decode(
        jnp.asarray(props), jnp.asarray(deltas), max_shape=max_shape))
    assert got.shape == (n, 5)
    # the angle of a near-square box is ill-conditioned: compare it where
    # the sides differ
    np.testing.assert_allclose(got.numpy()[:, :4], ref[:, :4], rtol=1e-5,
                               atol=1e-4)
    clear = np.abs(ref[:, 2] - ref[:, 3]) > 1e-2 * ref[:, 2]
    assert clear.sum() > n // 2
    np.testing.assert_allclose(got.numpy()[clear, 4], ref[clear, 4],
                               atol=1e-4)
    # batched leading dimensions give the same boxes
    again = MidpointOffsetCoder(**cfg).decode(
        torch.from_numpy(props).reshape(3, 100, 4),
        torch.from_numpy(deltas).reshape(3, 100, 6), max_shape=max_shape)
    assert torch.equal(again.reshape(n, 5), got)

    gts = random_obbs(n, 7, extent=128.0)
    gts[:, 4] = rng.uniform(-np.pi / 2, np.pi / 2, n)
    gts[:8, 4] = 0.0                                   # tied vertices
    enc = MidpointOffsetCoder(**cfg).encode(torch.from_numpy(props),
                                            torch.from_numpy(gts))
    ref_enc = np.asarray(JMidpoint(**cfg).encode(jnp.asarray(props),
                                                 jnp.asarray(gts)))
    np.testing.assert_allclose(enc.numpy(), ref_enc, rtol=1e-5, atol=1e-5)


# ---- the tiny model on carried weights ------------------------------------
def perturb_variables(variables, seed):
    """Random numpy values in place of the init's constants, so frozen BN,
    biases and every kernel carry information through the comparison. The
    regression outputs of both stages are scaled down, as a trained
    detector's are: proposals near their anchors, boxes inside the image."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == 'kernel':
            v = rng.normal(0, 1 / np.sqrt(int(np.prod(shape[:-1]))), shape)
            if path[-2].key in ('rpn_reg', 'fc_reg'):
                v = v * 0.05
        elif name == 'scale':
            v = rng.uniform(0.5, 1.5, shape)
        elif name == 'var':
            v = rng.uniform(0.5, 2.0, shape)
        else:                               # bias, mean
            v = rng.normal(0, 0.1, shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, variables)


class Tiny:
    """The tiny Oriented R-CNN in both packages on the same weights."""

    def __init__(self):
        self.jcfg = JConfig.fromfile(TINY)
        self.jdet = j_build(dict(self.jcfg.model))
        shapes = jax.eval_shape(
            self.jdet.init, jax.random.PRNGKey(0),
            jnp.zeros((1, SIZE, SIZE, 3), jnp.float32))
        self.variables = perturb_variables(shapes, 21)
        self.params = self.variables['params']
        self.cfg = Config.fromfile(TINY)
        self.state = from_jax_variables(self.variables)
        self.det = build_detector(dict(self.cfg.model)).eval()
        self.det.load_state_dict(self.state, strict=True)

    def jax_head(self, name, stage):
        cfg = dict(self.jcfg.model[name])
        cfg['test_cfg'] = self.jcfg.model['test_cfg'][stage]
        return JHEADS.build(cfg)

    def levels(self, seed, count=5):
        """Random NHWC pyramid levels of a SIZE px image, strides 4 up."""
        rng = np.random.default_rng(seed)
        return [rng.normal(0, 1, (2, SIZE // s, SIZE // s, 64)
                           ).astype(np.float32)
                for s in (4, 8, 16, 32, 64)[:count]]


@pytest.fixture(scope='module')
def tiny():
    return Tiny()


def nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2).contiguous()


def test_weights_round_trip_with_no_leftover_key(tiny):
    names = set(tiny.state)
    assert {'rpn_head.rpn_conv.weight', 'rpn_head.rpn_cls.bias',
            'rpn_head.rpn_reg.weight',
            'roi_head.bbox_head.shared_fcs.0.weight',
            'roi_head.bbox_head.shared_fcs.1.bias',
            'roi_head.bbox_head.fc_cls.weight',
            'roi_head.bbox_head.fc_reg.bias'} <= names
    assert names == set(tiny.det.state_dict())        # strict both ways
    # a dense kernel (in, out) is the linear weight (out, in) transposed
    dense = tiny.params['roi_head']['bbox_head']['shared_fc_0']['kernel']
    assert dense.shape == (7 * 7 * 64, 256)
    np.testing.assert_array_equal(
        tiny.state['roi_head.bbox_head.shared_fcs.0.weight'].numpy(),
        dense.T)
    back = to_jax_layout(tiny.det.state_dict())
    flat_ref = {jax.tree_util.keystr(p): v for p, v in
                jax.tree_util.tree_leaves_with_path(dict(tiny.variables))}
    flat_got = {jax.tree_util.keystr(p): v for p, v in
                jax.tree_util.tree_leaves_with_path(back)}
    assert sorted(flat_got) == sorted(flat_ref)
    for k, v in flat_ref.items():
        np.testing.assert_array_equal(flat_got[k], v, err_msg=k)


def test_fpn_without_extra_convs_matches_jax(tiny):
    rng = np.random.default_rng(22)
    inputs = [rng.normal(0, 1, (2, SIZE // s, SIZE // s, c)
                         ).astype(np.float32)
              for s, c in zip((4, 8, 16, 32), (64, 128, 256, 512))]
    neck = JNECKS.build(dict(tiny.jcfg.model['neck']))
    ref = jax.jit(neck.apply)({'params': tiny.params['neck']},
                              [jnp.asarray(x) for x in inputs])
    with torch.no_grad():
        got = tiny.det.neck([nchw(x) for x in inputs])
    assert len(got) == len(ref) == 5
    assert not any(k.startswith('neck.fpn_convs.4') for k in tiny.state)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), r,
                                   rtol=1e-4, atol=1e-4 * np.abs(r).max())
    # the fifth level is every second cell of the fourth
    assert torch.equal(got[4], got[3][:, :, ::2, ::2])
    # 'on_output' builds since slice 9 (its first extra conv reads the
    # 256-channel last output); an unknown mode raises
    extra = FPN(add_extra_convs='on_output').fpn_convs[4].conv
    assert extra.in_channels == 256
    with pytest.raises(ValueError):
        FPN(add_extra_convs='on_nothing')


def test_rpn_forward_and_proposals_match_jax(tiny):
    feats = tiny.levels(23)
    rpn = tiny.jax_head('rpn_head', 'rpn')
    j_out = jax.jit(rpn.apply)({'params': tiny.params['rpn_head']},
                               tuple(jnp.asarray(f) for f in feats))
    with torch.no_grad():
        t_out = tiny.det.rpn_head([nchw(f) for f in feats])
    for got, ref in zip(t_out[0] + t_out[1], j_out[0] + j_out[1]):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref,
                                   rtol=1e-4, atol=1e-4 * np.abs(ref).max())

    # proposals from the SAME maps (the JAX head's)
    cfg = tiny.jcfg.model['test_cfg']['rpn']
    r_boxes, r_scores, r_valid = jax.jit(
        lambda o: rpn.get_proposals(o, cfg=cfg))(j_out)
    same = (tuple(nchw(s) for s in j_out[0]),
            tuple(nchw(p) for p in j_out[1]))
    with torch.no_grad():
        boxes, scores, valid = tiny.det.rpn_head.get_proposals(
            same, cfg=tiny.cfg.model['test_cfg']['rpn'])
    r_valid = np.asarray(r_valid)
    assert boxes.shape == (2, 256, 5) and valid.dtype == torch.bool
    assert 50 < r_valid.sum(1).min() and r_valid.sum(1).max() <= 256
    np.testing.assert_array_equal(valid.numpy(), r_valid)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(r_boxes), atol=1e-4)
    np.testing.assert_allclose(scores.numpy(), np.asarray(r_scores),
                               atol=1e-6)
    assert (boxes[~valid] == 0).all() and (scores[~valid] == 0).all()


def test_proposals_are_padded_when_candidates_run_out(tiny):
    """Fewer candidates than ``max_per_img``: the output keeps its shape."""
    feats = [nchw(f[:, :2, :2]) for f in tiny.levels(24)]
    with torch.no_grad():
        boxes, scores, valid = tiny.det.rpn_head.get_proposals(
            tiny.det.rpn_head(feats), cfg=dict(nms_pre=8, max_per_img=100))
    assert boxes.shape == (2, 100, 5) and valid.shape == (2, 100)
    assert 0 < valid.sum(1).min() and valid.sum(1).max() <= 40


def roi_inputs(tiny, seed):
    from chip_smoke import seeded_rois
    feats = tiny.levels(seed, count=4)
    rois = seeded_rois(2, 40, SIZE, seed + 1)
    return feats, rois


def test_roi_head_forward_matches_jax(tiny):
    feats, rois = roi_inputs(tiny, 25)
    roi = tiny.jax_head('roi_head', 'rcnn')
    r_cls, r_reg = jax.jit(roi.apply)(
        {'params': tiny.params['roi_head']},
        tuple(jnp.asarray(f) for f in feats), jnp.asarray(rois))
    t_feats = [nchw(f) for f in feats] + [torch.zeros(2, 64, 2, 2)]
    with torch.no_grad():
        cls_score, bbox_pred = tiny.det.roi_head(t_feats,
                                                 torch.from_numpy(rois))
        plain = tiny.det.roi_head(t_feats, torch.from_numpy(rois),
                                  plain_roi_align=True)
    assert cls_score.shape == (2, 40, 3) and bbox_pred.shape == (2, 40, 5)
    np.testing.assert_allclose(cls_score.numpy(), np.asarray(r_cls),
                               atol=1e-4)
    np.testing.assert_allclose(bbox_pred.numpy(), np.asarray(r_reg),
                               atol=1e-4)
    assert torch.equal(plain[0], cls_score)
    # neither pooling function carries a gradient: one asked for raises
    t_feats[0].requires_grad_()
    for plain_roi_align in (False, True):
        with pytest.raises(ValueError, match='gradient'):
            tiny.det.roi_head(t_feats, torch.from_numpy(rois),
                              plain_roi_align=plain_roi_align)
    assert tiny.det.roi_head.roi_cfg == dict(
        out_size=(7, 7), sampling_ratio=2, finest_scale=56.0,
        strides=[4, 8, 16, 32])


def test_bbox_head_and_get_bboxes_match_jax(tiny):
    rng = np.random.default_rng(26)
    pooled = rng.normal(0, 1, (2, 30, 7, 7, 64)).astype(np.float32)
    head = tiny.jax_head('roi_head', 'rcnn').make_bbox_head()
    r_cls, r_reg = jax.jit(head.apply)(
        {'params': tiny.params['roi_head']['bbox_head']},
        jnp.asarray(pooled))
    with torch.no_grad():
        cls_score, bbox_pred = tiny.det.roi_head.bbox_head(
            torch.from_numpy(pooled))
    np.testing.assert_allclose(cls_score.numpy(), np.asarray(r_cls),
                               atol=1e-4)
    np.testing.assert_allclose(bbox_pred.numpy(), np.asarray(r_reg),
                               atol=1e-4)

    # decode + NMS on the SAME head outputs
    rois = random_obbs(2 * 120, 27, extent=SIZE).reshape(2, 120, 5)
    rois[:, -10:] = 0.0                                # padded proposals
    cls = rng.normal(0, 2, (2, 120, 3)).astype(np.float32)
    reg = rng.normal(0, 0.5, (2, 120, 5)).astype(np.float32)
    cfg = dict(tiny.jcfg.model['test_cfg']['rcnn'])
    r_dets, r_labels, r_valid = jax.jit(
        lambda a, b, c: tiny.jax_head('roi_head', 'rcnn').get_bboxes(
            a, b, c, cfg=cfg))(jnp.asarray(rois), jnp.asarray(cls),
                               jnp.asarray(reg))
    dets, labels, valid = tiny.det.roi_head.get_bboxes(
        torch.from_numpy(rois), torch.from_numpy(cls), torch.from_numpy(reg),
        cfg=cfg)
    r_valid = np.asarray(r_valid)
    assert dets.shape == (2, 100, 6) and 10 < r_valid.sum(1).min()
    np.testing.assert_array_equal(valid.numpy(), r_valid)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(r_labels))
    np.testing.assert_allclose(dets.numpy(), np.asarray(r_dets), atol=1e-4)


def test_whole_slice_matches_jax(tiny):
    images = np.random.default_rng(28).normal(
        0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    r_dets, r_labels, r_valid = JBundle(tiny.jcfg, tiny.jdet,
                                        tiny.variables)(jnp.asarray(images))
    bundle = init_detector(tiny.cfg, tiny.state, device='cpu')
    assert bundle.two_stage and bundle.num_classes == 2
    outputs = bundle.forward(torch.from_numpy(images))
    assert outputs['proposals'].shape == (2, 256, 5)
    assert outputs['cls_score'].dtype == torch.float32
    dets, labels, valid = bundle.decode(outputs)
    r_valid = np.asarray(r_valid)
    assert r_valid.sum(1).min() > 5
    np.testing.assert_array_equal(valid.sum(1).numpy(), r_valid.sum(1))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(r_labels))
    np.testing.assert_allclose(dets.numpy(), np.asarray(r_dets), atol=1e-3)

    # the single-image entry point pads to the config's pad_size (256 px)
    per_class = inference_detector(bundle, images[0], img_norm_cfg=dict(
        mean=[0., 0., 0.], std=[1., 1., 1.], to_rgb=False))
    canvas = np.zeros((1, 256, 256, 3), np.float32)
    canvas[0, :SIZE, :SIZE] = images[0]
    dets, labels, valid = bundle(torch.from_numpy(canvas))
    assert len(per_class) == 2 and sum(map(len, per_class)) == valid.sum()
    for c, arr in enumerate(per_class):
        np.testing.assert_allclose(
            arr, dets[0][valid[0] & (labels[0] == c)].numpy(), atol=1e-4)


def test_init_detector_builds_the_r50_config():
    bundle = init_detector(R50, device='cpu', dtype=torch.bfloat16, seed=3)
    assert bundle.num_classes == 15 and bundle.two_stage
    det = bundle.detector
    fc = det.roi_head.bbox_head.shared_fcs[0]
    assert fc.weight.shape == (1024, 12544)
    assert fc.weight.dtype == torch.bfloat16           # linear layers too
    assert det.rpn_head.rpn_conv.weight.dtype == torch.bfloat16
    assert det.backbone.bn1.weight.dtype == torch.float32
    assert len(det.neck.fpn_convs) == 4                # no extra convs
    assert float(fc.weight.detach().float().std()) == pytest.approx(
        12544 ** -0.5, rel=0.05)                       # seeded, not default
    assert not fc.bias.any()
    again = init_detector(R50, device='cpu', seed=3).detector
    assert torch.equal(again.roi_head.bbox_head.fc_cls.weight.bfloat16(),
                       det.roi_head.bbox_head.fc_cls.weight)


def test_training_entry_points_raise(tiny):
    """What is still to port raises, naming its ROADMAP item: the ReDet
    RoI layer (A.9). Two-stage training (A.1) runs; it raises only for a
    call without its batch and rng."""
    images = torch.zeros(1, 3, 64, 64)
    with pytest.raises(ValueError, match='rng'):
        tiny.det(images, train=True)
    cfg = dict(tiny.cfg.model['roi_head'])
    cfg['bbox_roi_extractor'] = dict(roi_layer=dict(type='RiRoIAlignRotated'))
    cfg.pop('type')
    from orientedobjectdetection_torch.models import OrientedStandardRoIHead
    with pytest.raises(NotImplementedError, match='ROADMAP A.9'):
        OrientedStandardRoIHead(**cfg)
