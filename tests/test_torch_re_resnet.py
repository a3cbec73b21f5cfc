"""Port parity, ReDet's equivariant pieces against the JAX package on the
same inputs and weights:

- ``c8_steerable_basis`` (equal) and ``rotation_interp_matrix`` (1e-6);
- ``ORConv2d`` with ``stride=2``, without a bias, ``steerable`` and
  ``interp``, 1 and 8 input orientations: outputs and the gradients into
  the input and the free parameter within 1e-5 of their largest;
- ``ReResNet`` (depth 18, both conv bases) and ``ReFPN`` outputs within
  1e-5 of each map's largest, and the carry both ways exactly;
- the rotation-invariant roll (``ri_roll``) after the gather RoIAlign, at
  angles ``k pi / 8`` for k in -8..8 and one float32 ulp either side
  (where ``round`` breaks ties to even and the remainder of a negative bin
  wraps), against ``ri_roi_align_rotated``: equal bins, pooled features
  within 1e-5 of their largest;
- ``frozen_mask`` of ReDet at ``frozen_stages=1``: the JAX package's
  partition (layer1 frozen, the stem trainable), at depth 18 and 50.
"""

import math
import os.path as osp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orientedobjectdetection_tpu.models import build_detector as j_build
from orientedobjectdetection_tpu.models import utils_rotation as j_rot
from orientedobjectdetection_tpu.models.backbones import re_resnet as j_re
from orientedobjectdetection_tpu.models.backbones.jy_modules import \
    rotation_interp_matrix as j_interp
from orientedobjectdetection_tpu.parallel import train_state as j_ts
from orientedobjectdetection_torch.models import build_detector
from orientedobjectdetection_torch.models import utils_rotation as rot
from orientedobjectdetection_torch.models.backbones import ReResNet
from orientedobjectdetection_torch.models.backbones import re_resnet
from orientedobjectdetection_torch.models.necks import ReFPN
from orientedobjectdetection_torch.ops.roi_align_rotated import \
    roi_align_rotated
from orientedobjectdetection_torch.parallel import frozen_mask
from orientedobjectdetection_torch.utils import Config
from orientedobjectdetection_torch.utils.jax_weights import (
    _to_port, from_jax_variables, to_jax_layout)
from test_torch_swin import random_variables
from test_torch_two_stage_train import leaves

torch.set_num_threads(1)

CONFIGS = osp.join(osp.dirname(__file__), '..', 'configs', 'redet')


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def close(got, ref, label=''):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max(), err_msg=label)


def test_steerable_basis_and_interp_operator_match_jax():
    for n in (4, 8):
        np.testing.assert_array_equal(rot.c8_steerable_basis(n),
                                      j_rot.c8_steerable_basis(n))
    angles = np.arange(8, dtype=np.int32) * np.float32(math.pi / 4)
    np.testing.assert_allclose(
        rot.rotation_interp_matrix(torch.from_numpy(angles)).numpy(),
        np.asarray(j_interp(jnp.asarray(angles))), rtol=0, atol=1e-6)


@pytest.mark.parametrize('in_orientations,kw', [
    (1, dict(stride=2)),
    (8, dict(stride=2, use_bias=False)),
    (1, dict(steerable=True)),
    (8, dict(steerable=True, stride=2)),
    (1, dict(interp=True)),
    (8, dict(interp=True, use_bias=False)),
])
def test_orconv_options_match_jax(in_orientations, kw):
    rng = np.random.default_rng(in_orientations + len(kw))
    cin, cout = 3, 4
    x = rng.normal(0, 1, (2, 9, 8, cin * in_orientations)).astype(np.float32)
    jconv = j_rot.ORConv2d(cout, in_orientations=in_orientations, **kw)
    shapes = jax.eval_shape(jconv.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))
    params = random_variables(shapes, 1)['params']
    conv = rot.ORConv2d(cin, cout, in_orientations=in_orientations, **kw)
    free = 'coeff' if kw.get('steerable') else 'kernel'
    with torch.no_grad():
        getattr(conv, 'coeff' if free == 'coeff' else 'weight').copy_(
            torch.from_numpy(re_resnet_tensor(params[free], free)))
        if 'bias' in params:
            conv.bias.copy_(torch.from_numpy(params['bias']))
    assert (conv.bias is None) == ('bias' not in params)
    x_t = nchw(x).requires_grad_(True)
    out = conv(x_t)
    stride = kw.get('stride', 1)
    assert out.shape == (2, cout * 8, -(-9 // stride), -(-8 // stride))
    cot = rng.normal(0, 1, out.shape).astype(np.float32)
    (out * torch.from_numpy(cot)).sum().backward()
    ref, vjp = jax.vjp(lambda p, xx: jconv.apply({'params': p}, xx),
                       params, jnp.asarray(x))
    close(out.detach().permute(0, 2, 3, 1).numpy(), ref, 'output')
    g_params, g_x = vjp(jnp.asarray(cot.transpose(0, 2, 3, 1)))
    close(x_t.grad.permute(0, 2, 3, 1).numpy(), g_x, 'input gradient')
    grad = getattr(conv, 'coeff' if free == 'coeff' else 'weight').grad
    close(grad.numpy(), re_resnet_tensor(np.asarray(g_params[free]), free),
          'weight gradient')


def re_resnet_tensor(v, leaf):
    """A flax group-conv tensor in the port's layout (the carry's)."""
    return np.ascontiguousarray(_to_port(np.asarray(v), 'group', leaf, 7),
                                dtype=np.float32)


def test_orconv_rebuilds_its_weight_from_the_tied_parameter():
    """A 1x1 group convolution's copies are rolls of one filter; a change
    to the tied parameter reaches every copy."""
    conv = rot.ORConv2d(2, 3, in_orientations=8, kernel_size=1,
                        use_bias=False)
    w = conv.rotated_weight().reshape(3, 8, 2, 8)
    for o in range(8):
        np.testing.assert_array_equal(
            w[:, o].detach().numpy(),
            torch.roll(conv.weight[..., 0, 0], o, 2).detach().numpy())
    with torch.no_grad():
        conv.weight.add_(1.0)
    assert torch.equal(conv.rotated_weight().reshape(3, 8, 2, 8),
                       w.detach() + 1.0)
    with pytest.raises(ValueError):
        rot.ORConv2d(2, 3, kernel_size=1, steerable=True)


@pytest.mark.parametrize('basis', ['permutation', 'steerable'])
def test_re_resnet_and_re_fpn_match_jax(basis):
    rng = np.random.default_rng(4)
    images = rng.normal(0, 1, (2, 64, 64, 3)).astype(np.float32)
    jnet = j_re.ReResNet(depth=18, conv_basis=basis)
    jneck = j_re.ReFPN(out_channels=64, conv_basis=basis)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                            jnp.asarray(images))
    v_net = random_variables(shapes, 5)
    feats = jax.jit(jnet.apply)(v_net, jnp.asarray(images))
    n_shapes = jax.eval_shape(jneck.init, jax.random.PRNGKey(0), feats)
    v_neck = random_variables(n_shapes, 6)
    outs = jax.jit(jneck.apply)(v_neck, feats)
    tree = {'params': {'backbone': v_net['params'],
                       'neck': v_neck['params']},
            'batch_stats': {'backbone': v_net['batch_stats']}}
    state = from_jax_variables(tree)
    net = ReResNet(depth=18, conv_basis=basis)
    neck = ReFPN(out_channels=64, conv_basis=basis)
    for prefix, module in (('backbone.', net), ('neck.', neck)):
        module.load_state_dict({k[len(prefix):]: t for k, t in state.items()
                                if k.startswith(prefix)}, strict=True)
    with torch.no_grad():
        got = net(nchw(images))
        got_outs = neck(got)
    assert [g.shape[1] for g in got] == [256, 512, 1024, 2048]
    for g, r in zip(got + got_outs, feats + outs):
        close(g.permute(0, 2, 3, 1).numpy(), r)
    back = dict(leaves(to_jax_layout(
        {**{'backbone.' + k: t for k, t in net.state_dict().items()},
         **{'neck.' + k: t for k, t in neck.state_dict().items()}})))
    ref = dict(leaves(tree))
    assert sorted(back) == sorted(ref)
    for name, v in ref.items():
        np.testing.assert_array_equal(back[name], v, err_msg=name)


def boundary_thetas():
    """``k pi / 8`` for k in -8..8 (as float32) and one ulp either side:
    bin boundaries at odd k, bin centres at even k."""
    base = (np.arange(-8, 9) * np.float32(math.pi / 8)).astype(np.float32)
    return np.concatenate([base, np.nextafter(base, np.float32(np.inf)),
                           np.nextafter(base, np.float32(-np.inf))])


def test_orientation_shift_matches_jax_at_the_boundaries():
    thetas = boundary_thetas()
    ref = np.asarray(jax.jit(lambda t: jnp.round(
        t / (2 * jnp.pi / 8)).astype(jnp.int32) % 8)(jnp.asarray(thetas)))
    got = re_resnet.orientation_shift(torch.from_numpy(thetas)).numpy()
    np.testing.assert_array_equal(got, ref)
    # ties round to even: 1/2 -> 0, 3/2 -> 2, -1/2 -> 0, -3/2 -> -2 = 6
    half = np.float32(math.pi / 8)
    at = re_resnet.orientation_shift(torch.tensor(
        [half, 3 * half, -half, -3 * half])).tolist()
    assert at == [0, 2, 0, 6]


def test_ri_roll_matches_jax_at_the_boundaries():
    rng = np.random.default_rng(7)
    thetas = boundary_thetas()
    n = len(thetas)
    feats = [rng.normal(0, 1, (1, 64 // s, 64 // s, 16)).astype(np.float32)
             for s in (4, 8, 16, 32)]
    rois = np.zeros((1, n, 5), np.float32)
    rois[0, :, :2] = rng.uniform(16, 48, (n, 2))
    rois[0, :, 2:4] = rng.uniform(6, 30, (n, 2))
    rois[0, :, 4] = thetas
    scales = [1 / 4, 1 / 8, 1 / 16, 1 / 32]
    ref = j_re.ri_roi_align_rotated([jnp.asarray(f) for f in feats],
                                    jnp.asarray(rois), (7, 7), scales, 2)
    pooled = roi_align_rotated([torch.from_numpy(f) for f in feats],
                               torch.from_numpy(rois), (7, 7), scales, 2)
    got = re_resnet.ri_roll(pooled, torch.from_numpy(rois))
    close(got.numpy(), ref)
    # every bin is taken, and the roll moves the channels of a turned RoI
    shifts = re_resnet.orientation_shift(torch.from_numpy(thetas))
    assert set(shifts.tolist()) == set(range(8))
    turned = shifts[None] != 0
    assert not torch.equal(got[turned], pooled[turned])
    assert torch.equal(got[~turned], pooled[~turned])


@pytest.mark.parametrize('config', ['redet_tiny_synth.py',
                                    'redet_re50_refpn_1x_dota_le90.py'])
def test_frozen_mask_is_the_jax_partition(config):
    cfg = Config.fromfile(osp.join(CONFIGS, config))
    model = dict(cfg.model)
    model['backbone'] = dict(model['backbone'], frozen_stages=1)
    detector = build_detector(model)
    mask = frozen_mask(detector, 1)
    assert mask['backbone.conv1.weight'] and mask['backbone.bn1.bias']
    assert not mask['backbone.layer1.0.conv2.weight']
    det = j_build(model)
    shapes = jax.eval_shape(det.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 256, 256, 3), jnp.float32))
    j_mask = dict(leaves(j_ts.frozen_mask(shapes['params'], 1)))
    ours = dict(leaves(to_jax_layout(
        {n: torch.full_like(p, float(mask[n]))
         for n, p in detector.named_parameters()})['params']))
    assert sorted(ours) == sorted(j_mask)
    for n, v in ours.items():
        assert bool(v.flat[0]) == bool(j_mask[n]), n
    assert sum(not v for v in j_mask.values()) > 0
