"""Port parity, the YOLO block set and backbones: each block of
``models/blocks.py`` (the YOLO conv module and its depthwise form,
DarknetBottleneck, CSPNeXtBlock, ChannelAttention, CSPLayer, SPPF, C2f),
CSPNeXt with its MSARC stage and YOLOv8 CSPDarknet, and the jy modules
(the rotation operator, the routing function, the adaptive rotated
convolution, MSARC, the rotationally deformable convolution, deformable
attention), on numpy-seeded inputs and weights carried from the JAX
package by ``utils/jax_weights.py:mirror_from_jax``.

Small sizes: 8-32 channels, 16-64 px, two images. Outputs are held to
1e-5 of the reference's largest magnitude (float32; the convolutions sum
in other orders)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orientedobjectdetection_tpu.models import blocks as JB
from orientedobjectdetection_tpu.models.backbones import \
    csp_darknet as j_darknet
from orientedobjectdetection_tpu.models.backbones import cspnext as j_cspnext
from orientedobjectdetection_tpu.models.backbones import jy_modules as JY
from orientedobjectdetection_torch.models import blocks as PB
from orientedobjectdetection_torch.models.backbones import jy_modules as PY
from orientedobjectdetection_torch.models.backbones.csp_darknet import \
    YOLOv8CSPDarknet
from orientedobjectdetection_torch.models.backbones.cspnext import CSPNeXt
from orientedobjectdetection_torch.utils.jax_weights import (mirror_from_jax,
                                                             mirror_to_jax)

torch.set_num_threads(1)

RTOL = 1e-5     # of the reference's largest magnitude


def fill_variables(shapes, rng, kernel_scale=1.0):
    """numpy values in the flax tree's shapes: LeCun-normal kernels (x
    ``kernel_scale``), BN scales and variances in [0.5, 1.5], small means
    and biases."""
    def fill(path, leaf):
        name = path[-1].key
        if name == 'kernel':
            v = rng.normal(0, kernel_scale / np.sqrt(
                np.prod(leaf.shape[:-1])), leaf.shape)
        elif name in ('scale', 'var'):
            v = rng.uniform(0.5, 1.5, leaf.shape)
        else:
            v = rng.normal(0, 0.1, leaf.shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def to_nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x,
                                                              (0, 3, 1, 2))))


def jax_nchw(y):
    return np.transpose(np.asarray(y), (0, 3, 1, 2))


def carried(jax_module, port_module, x, rng, kernel_scale=1.0):
    """(JAX output, port output) of the same input ``x`` (B, H, W, C) and
    weights, NCHW numpy; the port's carried weights go back to the flax
    tree unchanged."""
    shapes = jax.eval_shape(jax_module.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))
    variables = fill_variables(shapes, rng, kernel_scale)
    ref = jax.jit(jax_module.apply)(variables, jnp.asarray(x))
    state = mirror_from_jax(variables)
    port_module.load_state_dict(state, strict=True)
    back = mirror_to_jax(port_module.state_dict())
    flat = dict(jax.tree_util.tree_leaves_with_path(variables))
    assert len(jax.tree_util.tree_leaves(back)) == len(flat)
    for path, v in jax.tree_util.tree_leaves_with_path(back):
        assert np.array_equal(v, flat[path]), path
    with torch.no_grad():
        got = port_module(to_nchw(x))
    return ref, got


def assert_close(ref, got, name=''):
    ref = np.asarray(ref)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert ref.shape == got.shape, (name, ref.shape, got.shape)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=RTOL * max(np.abs(ref).max(), 1e-6),
                               err_msg=name)


BLOCKS = {
    'conv3x3_s2': (lambda: JB.ConvModule(12, 3, stride=2),
                   lambda c: PB.YOLOConvModule(c, 12, 3, 2)),
    'conv_depthwise5': (lambda: JB.ConvModule(12, 5, use_depthwise=True),
                        lambda c: PB.YOLOConvModule(c, 12, 5,
                                                    use_depthwise=True)),
    'darknet_identity': (lambda: JB.DarknetBottleneck(8),
                         lambda c: PB.DarknetBottleneck(c, 8)),
    'darknet_widen': (lambda: JB.DarknetBottleneck(16, expansion=1.0,
                                                   kernel_size=(3, 3)),
                      lambda c: PB.DarknetBottleneck(c, 16, 1.0,
                                                     kernel_size=(3, 3))),
    'cspnext_block': (lambda: JB.CSPNeXtBlock(8),
                      lambda c: PB.CSPNeXtBlock(c, 8)),
    'channel_attention': (lambda: JB.ChannelAttention(),
                          lambda c: PB.ChannelAttention(c)),
    'csp_cspnext_attn': (lambda: JB.CSPLayer(16, num_blocks=2,
                                             use_cspnext_block=True,
                                             channel_attention=True),
                         lambda c: PB.CSPLayer(c, 16, num_blocks=2,
                                               use_cspnext_block=True,
                                               channel_attention=True)),
    'csp_darknet_no_id': (lambda: JB.CSPLayer(12, num_blocks=1,
                                              add_identity=False),
                          lambda c: PB.CSPLayer(c, 12, num_blocks=1,
                                                add_identity=False)),
    'sppf': (lambda: JB.SPPFBottleneck(8), lambda c: PB.SPPFBottleneck(c, 8)),
    'c2f': (lambda: JB.CSPLayerWithTwoConv(16, num_blocks=2),
            lambda c: PB.CSPLayerWithTwoConv(c, 16, num_blocks=2)),
    'c2f_no_id': (lambda: JB.CSPLayerWithTwoConv(8, num_blocks=1,
                                                 add_identity=False),
                  lambda c: PB.CSPLayerWithTwoConv(c, 8, num_blocks=1,
                                                   add_identity=False)),
}


@pytest.mark.parametrize('name', sorted(BLOCKS))
def test_block_matches_jax(name):
    make_jax, make_port = BLOCKS[name]
    rng = np.random.default_rng(len(name))
    x = rng.normal(0, 1, (2, 16, 16, 8)).astype(np.float32)
    ref, got = carried(make_jax(), make_port(8), x, rng)
    assert_close(jax_nchw(ref), got, name)


@pytest.mark.parametrize('x', [0.4, 1, 3, 7.9, 64, 100, 255.5, 1024])
@pytest.mark.parametrize('factor', [0.125, 0.25, 0.33, 0.67, 0.75, 1.25])
def test_make_divisible_and_make_round_match_jax(x, factor):
    assert PB.make_divisible(x, factor) == JB.make_divisible(x, factor)
    assert PB.make_round(x, factor) == JB.make_round(x, factor)


BACKBONES = {
    'cspnext_msarc': (
        lambda: j_cspnext.CSPNeXtLarge(deepen_factor=0.33,
                                       widen_factor=0.125,
                                       last_stage_out_channels=768,
                                       stage_aux=1, reverse=True),
        lambda: CSPNeXt(deepen_factor=0.33, widen_factor=0.125,
                        last_stage_out_channels=768, stage_aux=1,
                        reverse=True)),
    'cspnext_last_aux_stem': (
        lambda: j_cspnext.CSPNeXt(deepen_factor=0.33, widen_factor=0.125,
                                  out_indices=(0, 3, 4), stage_aux=1,
                                  reverse=False),
        lambda: CSPNeXt(deepen_factor=0.33, widen_factor=0.125,
                        out_indices=(0, 3, 4), stage_aux=1, reverse=False)),
    'csp_darknet': (
        lambda: j_darknet.YOLOv8CSPDarknet(deepen_factor=0.33,
                                           widen_factor=0.125,
                                           last_stage_out_channels=768),
        lambda: YOLOv8CSPDarknet(deepen_factor=0.33, widen_factor=0.125,
                                 last_stage_out_channels=768)),
}


@pytest.mark.parametrize('name', sorted(BACKBONES))
def test_backbone_matches_jax(name):
    make_jax, make_port = BACKBONES[name]
    rng = np.random.default_rng(3 + len(name))
    x = rng.normal(0, 1, (2, 64, 64, 3)).astype(np.float32)
    port = make_port()
    ref, got = carried(make_jax(), port, x, rng)
    assert len(ref) == len(got) == len(port.out_widths)
    for i, (r, g) in enumerate(zip(ref, got)):
        assert g.shape[1] == port.out_widths[i]
        assert_close(jax_nchw(r), g, f'{name} level {i}')


def test_cspnext_aux_stages_follow_reverse():
    fwd = CSPNeXt(deepen_factor=0.33, widen_factor=0.125, stage_aux=2)
    back = CSPNeXt(deepen_factor=0.33, widen_factor=0.125, stage_aux=1,
                   reverse=False)
    assert [n for n, _ in fwd.named_children() if n.endswith('_aux')] == \
        ['stage1_aux', 'stage2_aux']
    assert [n for n, _ in back.named_children() if n.endswith('_aux')] == \
        ['stage4_aux']


@pytest.mark.parametrize('seed', range(3))
def test_rotation_interp_matrix_matches_jax(seed):
    thetas = np.random.default_rng(seed).uniform(-4, 4, (3, 4)).astype(
        np.float32)
    thetas[0, :2] = [0.0, np.pi / 2]
    got = PY.rotation_interp_matrix(torch.from_numpy(thetas))
    ref = np.asarray(JY.rotation_interp_matrix(jnp.asarray(thetas)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    # theta 0 is the identity; a quarter turn permutes the taps
    assert np.allclose(got[0, 0].numpy(), np.eye(9), atol=1e-6)
    assert np.allclose(got[0, 1].sum(-1).numpy(), 1, atol=1e-6)


JY_MODULES = {
    'routing': (lambda: JY.RountingFunction(kernel_number=4),
                lambda c: PY.RountingFunction(c, 4)),
    'arc': (lambda: JY.AdaptiveRotatedConv2d(12, kernel_number=4),
            lambda c: PY.AdaptiveRotatedConv2d(c, 12, 4)),
    'arc_stride2': (lambda: JY.AdaptiveRotatedConv2d(12, stride=2),
                    lambda c: PY.AdaptiveRotatedConv2d(c, 12, stride=2)),
    'msarc': (lambda: JY.MSARCModule(16), lambda c: PY.MSARCModule(c, 16)),
    'msarc_channel_only': (lambda: JY.MSARCModule(8, dilations=(1, 2),
                                                  spattn=False),
                           lambda c: PY.MSARCModule(c, 8, dilations=(1, 2),
                                                    spattn=False)),
    'rdc': (lambda: JY.RotationallyDeformableConvolution(12),
            lambda c: PY.RotationallyDeformableConvolution(c, 12)),
    'dattention': (lambda: JY.DAttentionBaseline(dim=16, num_heads=4,
                                                 stride=4),
                   lambda c: PY.DAttentionBaseline(c, dim=16, num_heads=4,
                                                   stride=4)),
}


@pytest.mark.parametrize('name', sorted(JY_MODULES))
def test_jy_module_matches_jax(name):
    make_jax, make_port = JY_MODULES[name]
    rng = np.random.default_rng(11 + len(name))
    x = rng.normal(0, 1, (2, 16, 16, 8)).astype(np.float32)
    ref, got = carried(make_jax(), make_port(8), x, rng)
    if name == 'routing':
        for r, g, what in zip(ref, got, ('alphas', 'thetas')):
            assert_close(r, g, what)
        return
    assert_close(jax_nchw(ref), got, name)


def test_arc_seeded_experts_are_he_normal():
    arc = PY.AdaptiveRotatedConv2d(32, 16, 4)
    arc.init_seeded(torch.Generator().manual_seed(0))
    std = float(arc.kernel.detach().std())
    assert abs(std - np.sqrt(2 / (4 * 9 * 32))) < 0.05 * std
