"""Port parity, models: anchors, box decode, ResNet/FPN/RetinaHead forward
on weights carried from the JAX package, and the weight mapping itself.

Tolerances: anchors and decode 1e-5 (float32 element-wise math); the
network forward rtol 1e-4 in float32 (same weights, different convolution
algorithms and summation order)."""

import os.path as osp
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _retina_cfg
from orientedobjectdetection_tpu.core.anchors import \
    RotatedAnchorGenerator as JAnchors
from orientedobjectdetection_tpu.core.coders import \
    DeltaXYWHAOBBoxCoder as JCoder
from orientedobjectdetection_tpu.models import build_detector as j_build
from orientedobjectdetection_torch.core import (DeltaXYWHAOBBoxCoder,
                                                RotatedAnchorGenerator)
from orientedobjectdetection_torch.models import build_detector
from orientedobjectdetection_torch.utils.jax_weights import \
    from_jax_variables

sys.path.insert(0, osp.join(osp.dirname(__file__), '..', 'tools',
                            'model_converters'))
from convert_torch_weights import synthesize_reference_state  # noqa: E402

torch.set_num_threads(1)

ANCHOR_CFG = dict(octave_base_scale=4, scales_per_octave=3,
                  ratios=[1.0, 0.5, 2.0], strides=[8, 16, 32, 64, 128])


def test_anchors_match_jax():
    sizes = [(16, 12), (8, 6), (4, 3), (2, 2), (1, 1)]
    got = RotatedAnchorGenerator(**ANCHOR_CFG).grid_priors(sizes)
    ref = JAnchors(**ANCHOR_CFG).grid_priors(sizes)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize('coder_cfg', [
    dict(angle_range='le90', edge_swap=True, proj_xy=True),
    dict(angle_range='oc'),
    dict(angle_range='le135', norm_factor=0.5, add_ctr_clamp=True,
         target_stds=(0.1, 0.1, 0.2, 0.2, 0.1)),
])
@pytest.mark.parametrize('max_shape', [None, (96, 128)])
def test_coder_matches_jax(coder_cfg, max_shape):
    rng = np.random.default_rng(0)
    n = 300
    anchors = np.stack([rng.uniform(0, 128, n), rng.uniform(0, 96, n),
                        rng.uniform(4, 64, n), rng.uniform(4, 64, n),
                        rng.uniform(-1.5, 1.5, n)], -1).astype(np.float32)
    deltas = rng.normal(0, 1.5, (n, 5)).astype(np.float32)
    got = DeltaXYWHAOBBoxCoder(**coder_cfg).decode(
        torch.from_numpy(anchors), torch.from_numpy(deltas),
        max_shape=max_shape)
    ref = jax.jit(lambda a, d: JCoder(**coder_cfg).decode(
        a, d, max_shape=max_shape))(anchors, deltas)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    gts = anchors.copy()
    gts[:, :4] *= rng.uniform(0.8, 1.2, (n, 4)).astype(np.float32)
    gts[:, 4] = rng.uniform(-1.5, 1.5, n)
    enc = DeltaXYWHAOBBoxCoder(**coder_cfg).encode(
        torch.from_numpy(anchors), torch.from_numpy(gts))
    ref_enc = jax.jit(lambda a, g: JCoder(**coder_cfg).encode(a, g))(
        anchors, gts)
    np.testing.assert_allclose(enc.numpy(), np.asarray(ref_enc), rtol=1e-5,
                               atol=1e-5)


def perturb_variables(variables, seed):
    """Random numpy values in place of the init's constants, so frozen BN,
    biases and every kernel carry information through the comparison."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == 'kernel':
            fan_in = int(np.prod(shape[:-1]))
            v = rng.normal(0, 1 / np.sqrt(fan_in), shape)
        elif name == 'scale':
            v = rng.uniform(0.5, 1.5, shape)
        elif name == 'var':
            v = rng.uniform(0.5, 2.0, shape)
        else:                               # bias, mean
            v = rng.normal(0, 0.1, shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, variables)


def jax_variables(cfg, size, seed):
    det = j_build(cfg)
    shapes = jax.eval_shape(det.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3), jnp.float32))
    return det, perturb_variables(shapes, seed)


@pytest.mark.parametrize('depth', [18, 50])
def test_from_jax_variables_matches_converter(depth):
    cfg = _retina_cfg(num_classes=4, depth=depth, channels=32, stacked=2)
    _, variables = jax_variables(cfg, 64, depth)
    got = from_jax_variables(variables)
    ref = synthesize_reference_state(variables, 'RotatedRetinaNet')
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        assert tuple(got[k].shape) == v.shape, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    # the port's modules take exactly these names
    model = build_detector(cfg)
    model.load_state_dict(got, strict=True)


def test_forward_matches_jax():
    """ResNet-18 -> FPN -> RetinaHead on carried weights, float32."""
    cfg = _retina_cfg(num_classes=4, depth=18, channels=32, stacked=2)
    det, variables = jax_variables(cfg, 96, 7)
    images = np.random.default_rng(8).normal(
        0, 1, (2, 96, 96, 3)).astype(np.float32)
    j_cls, j_reg = jax.jit(det.apply)(variables, images)
    model = build_detector(cfg).eval()
    model.load_state_dict(from_jax_variables(variables))
    with torch.no_grad():
        t_cls, t_reg = model(torch.from_numpy(images).permute(0, 3, 1, 2))
    assert len(t_cls) == len(j_cls) == 5
    for got, ref in zip(t_cls + t_reg, j_cls + j_reg):
        ref = np.asarray(ref)
        got = got.permute(0, 2, 3, 1).numpy()       # NCHW -> NHWC
        scale = np.abs(ref).max()
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * scale)


def test_config_fromfile_matches_jax():
    """The port's Config copy reads the flagship config with its _base_
    chain exactly as the JAX package's does."""
    from orientedobjectdetection_tpu.utils.config import Config as JConfig
    from orientedobjectdetection_torch.utils import Config
    path = osp.join(osp.dirname(__file__), '..', 'configs',
                    'rotated_retinanet',
                    'rotated_retinanet_obb_r50_fpn_1x_dota_le90.py')
    got, ref = Config.fromfile(path), JConfig.fromfile(path)
    assert dict(got.items()) == dict(ref.items())
    assert got.model.bbox_head.num_classes == 15
    assert got.img_norm_cfg['to_rgb'] is True      # from the _base_ file


def decode_inputs(seed, num_classes=4, size=64):
    """Random NHWC head outputs of a RetinaNet head on a ``size`` px image:
    logits that put many scores past score_thr, small deltas."""
    rng = np.random.default_rng(seed)
    sizes = [-(-size // s) for s in ANCHOR_CFG['strides']]
    cls = [rng.normal(-1, 2, (2, s, s, 9 * num_classes)).astype(np.float32)
           for s in sizes]
    reg = [rng.normal(0, 0.2, (2, s, s, 45)).astype(np.float32)
           for s in sizes]
    return cls, reg


def nchw_outputs(cls, reg):
    return (tuple(torch.from_numpy(x).permute(0, 3, 1, 2) for x in cls),
            tuple(torch.from_numpy(x).permute(0, 3, 1, 2) for x in reg))


@pytest.mark.parametrize('rescale', [True, False])
def test_get_bboxes_rescale_matches_jax(rescale):
    """The JAX argument order (outputs, img_shape, scale_factor, rescale,
    cfg), positionally: ``rescale`` with a ``scale_factor`` divides the
    decoded centres and sizes by (w, h, w, h) before NMS; without
    ``rescale`` the factor is not read."""
    scale_factor = (2.0, 0.5, 2.0, 0.5)
    from orientedobjectdetection_tpu.utils.registry import HEADS as JHEADS
    from orientedobjectdetection_torch.utils.registry import HEADS
    cfg = dict(_retina_cfg(num_classes=4, depth=18, channels=32,
                           stacked=1)['bbox_head'])
    cfg['test_cfg'] = dict(nms_pre=200, score_thr=0.05, max_per_img=100,
                           max_candidates=300, nms=dict(iou_thr=0.1))
    cls, reg = decode_inputs(9)
    img_shape = (64, 64)
    ref = jax.jit(lambda c, r: JHEADS.build(dict(cfg)).get_bboxes(
        (c, r), img_shape, scale_factor, rescale))(
        tuple(map(jnp.asarray, cls)), tuple(map(jnp.asarray, reg)))
    head = HEADS.build(dict(cfg))
    got = head.get_bboxes(nchw_outputs(cls, reg), img_shape, scale_factor,
                          rescale)
    r_dets, r_labels, r_valid = (np.asarray(x) for x in ref)
    assert r_valid.sum() > 20
    np.testing.assert_array_equal(got[2].numpy(), r_valid)
    np.testing.assert_array_equal(got[1].numpy(), r_labels)
    np.testing.assert_allclose(got[0].numpy(), r_dets, atol=1e-4)
    plain = head.get_bboxes(nchw_outputs(cls, reg), img_shape)
    assert torch.equal(plain[0], got[0]) != rescale
    # the detector passes the same arguments through, in the same order
    model = build_detector(_retina_cfg(num_classes=4, depth=18, channels=32,
                                       stacked=1))
    model.bbox_head.test_cfg.update(cfg['test_cfg'])
    via = model.bboxes_from_outputs(nchw_outputs(cls, reg), img_shape,
                                    scale_factor, rescale)
    for v, g in zip(via, got):
        assert torch.equal(v, g)


@pytest.mark.parametrize('approx', [True, False, None])
def test_approx_topk_raises_only_when_true(approx):
    """The port has no approximate top-k: ``approx_topk=True`` raises and
    names the key; false or absent runs the exact top-k."""
    from orientedobjectdetection_torch.utils.registry import HEADS
    cfg = dict(_retina_cfg(num_classes=4, depth=18, channels=32,
                           stacked=1)['bbox_head'])
    cfg['test_cfg'] = dict(nms_pre=200, score_thr=0.05, max_per_img=100,
                           max_candidates=300, nms=dict(iou_thr=0.1))
    if approx is not None:
        cfg['test_cfg']['approx_topk'] = approx
    head = HEADS.build(cfg)
    outputs = nchw_outputs(*decode_inputs(10))
    if approx:
        with pytest.raises(ValueError, match='approx_topk'):
            head.get_bboxes(outputs)
        return
    dets, labels, valid = head.get_bboxes(outputs)
    exact = dict(cfg['test_cfg'], approx_topk=False)
    ref = head.get_bboxes(outputs, cfg=exact)
    assert valid.sum() > 20 and torch.equal(dets, ref[0])
