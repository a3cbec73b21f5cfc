"""Port parity, the YOLO block library (``models/yolo_blocks.py``) and the
YOLOv6 Rep-PAFPN neck: every class of the JAX package's
``models/yolo_blocks.py``, its aliases and re-exports, on numpy-seeded
inputs (two images) and variables carried from the JAX package by
``utils/jax_weights.py:mirror_from_jax`` (and back by ``mirror_to_jax``,
unchanged).

Small sizes: 6-56 channels, maps of 2-16 px, text guides of 5 tokens.
Outputs are held to 1e-5 of the reference's largest magnitude (float32;
the convolutions and the attention sums run in other orders)."""

import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orientedobjectdetection_tpu.models import yolo_blocks as J
from orientedobjectdetection_tpu.models.necks import pafpn as j_pafpn
from orientedobjectdetection_torch.models import blocks as PB
from orientedobjectdetection_torch.models import yolo_blocks as P
from orientedobjectdetection_torch.models.detectors.single_stage import \
    init_seeded_weights
from orientedobjectdetection_torch.models.necks.pafpn import YOLOv6RepPAFPN
from orientedobjectdetection_torch.utils.jax_weights import (mirror_from_jax,
                                                             mirror_to_jax)
from orientedobjectdetection_torch.utils.registry import NECKS
from test_torch_cspnext import assert_close, fill_variables

torch.set_num_threads(1)

B = 2


def maps(*specs):
    """Input builders: ``(size, width)`` maps NHWC, ``('tokens', n, width)``
    token rows, a list of specs a list of maps."""
    def build(rng):
        out = []
        for spec in specs:
            if isinstance(spec, list):
                out.append([rng.normal(0, 1, (B, s, s, c)).astype(np.float32)
                            for s, c in spec])
            elif spec[0] == 'tokens':
                out.append(rng.normal(0, 1, (B,) + spec[1:]).astype(
                    np.float32))
            else:
                s, c = spec
                out.append(rng.normal(0, 1, (B, s, s, c)).astype(np.float32))
        return out
    return build


def to_port(arg):
    if isinstance(arg, list):
        return [to_port(a) for a in arg]
    t = torch.from_numpy(arg)
    return t.permute(0, 3, 1, 2).contiguous() if arg.ndim == 4 else t


def to_jax(arg):
    if isinstance(arg, list):
        return [jnp.asarray(a) for a in arg]
    return jnp.asarray(arg)


def outputs(out):
    """A block's output(s) as a list of numpy arrays, maps NCHW (the JAX
    package's NHWC maps transposed)."""
    if isinstance(out, (tuple, list)):
        return [o for x in out for o in outputs(x)]
    if torch.is_tensor(out):
        return [out.detach().numpy()]
    out = np.asarray(out)
    return [np.transpose(out, (0, 3, 1, 2)) if out.ndim == 4 else out]


M16, M8 = (16, 8), (8, 8)
TEXT = ('tokens', 5, 12)
# name -> (JAX module, port module, inputs)
CASES = {
    'RepVGGBlock': (lambda: J.RepVGGBlock(8), lambda: P.RepVGGBlock(8, 8),
                    maps(M16)),
    'RepVGGBlock_stride2': (lambda: J.RepVGGBlock(12, stride=2),
                            lambda: P.RepVGGBlock(8, 12, 2), maps(M16)),
    'RepVGGBlock_widen': (lambda: J.RepVGGBlock(12),
                          lambda: P.RepVGGBlock(8, 12), maps(M16)),
    'RepStageBlock': (lambda: J.RepStageBlock(12, num_blocks=3),
                      lambda: P.RepStageBlock(8, 12, 3), maps(M16)),
    'SPPBottleneck': (lambda: J.SPPBottleneck(12),
                      lambda: P.SPPBottleneck(8, 12), maps(M16)),
    'CSPSPPFBottleneck': (lambda: J.CSPSPPFBottleneck(12),
                          lambda: P.CSPSPPFBottleneck(8, 12), maps(M16)),
    'C3': (lambda: J.C3(16, num_blocks=2),
           lambda: P.C3(8, 16, num_blocks=2), maps(M16)),
    'C3_no_identity': (lambda: J.C3(8, add_identity=False, expand_ratio=1.0),
                       lambda: P.C3(8, 8, add_identity=False,
                                    expand_ratio=1.0), maps(M16)),
    'CBAM': (lambda: J.CBAM(), lambda: P.CBAM(24), maps((16, 24))),
    'CBAM_wide': (lambda: J.CBAM(reduction=4),
                  lambda: P.CBAM(48, reduction=4), maps((8, 48))),
    'ESEAttn': (lambda: J.ESEAttn(), lambda: P.ESEAttn(8), maps(M16)),
    'LSKBlock': (lambda: J.LSKBlock(), lambda: P.LSKBlock(8), maps(M16)),
    'AFF': (lambda: J.AFF(), lambda: P.AFF(8), maps(M16, M16)),
    'iAFF': (lambda: J.iAFF(), lambda: P.iAFF(8), maps(M16, M16)),
    'AFF_wide': (lambda: J.AFF(reduction=2), lambda: P.AFF(24, 2),
                 maps((8, 24), (8, 24))),
    'ASFF_level0': (lambda: J.ASFF(level=0, out_channels=12),
                    lambda: P.ASFF([8, 12, 16], 0, 12),
                    maps([(16, 8), (8, 12), (4, 16)])),
    'ASFF_level1': (lambda: J.ASFF(level=1, out_channels=12),
                    lambda: P.ASFF([8, 12, 16], 1, 12),
                    maps([(16, 8), (8, 12), (4, 16)])),
    'ASFF_level2': (lambda: J.ASFF(level=2, out_channels=12),
                    lambda: P.ASFF([8, 12, 16], 2, 12),
                    maps([(16, 8), (8, 12), (4, 16)])),
    'BiFusion': (lambda: J.BiFusion(12),
                 lambda: P.BiFusion([8, 10, 6], 12),
                 maps((8, 8), (8, 10), (16, 6))),
    'BottleRep': (lambda: J.BottleRep(8), lambda: P.BottleRep(8, 8),
                  maps(M16)),
    'BottleRep_adaptive': (lambda: J.BottleRep(8, adaptive_weight=True),
                           lambda: P.BottleRep(8, 8, True), maps(M16)),
    'BottleRep_unequal': (lambda: J.BottleRep(12, adaptive_weight=True),
                          lambda: P.BottleRep(8, 12, True), maps(M16)),
    'ConvWrapper': (lambda: J.ConvWrapper(12, stride=2),
                    lambda: P.ConvWrapper(8, 12, stride=2), maps(M16)),
    'BepC3StageBlock': (lambda: J.BepC3StageBlock(16, num_blocks=4),
                        lambda: P.BepC3StageBlock(8, 16, 4), maps(M16)),
    'BepC3StageBlock_no_concat': (
        lambda: J.BepC3StageBlock(16, num_blocks=1, concat_all_layer=False),
        lambda: P.BepC3StageBlock(8, 16, 1, concat_all_layer=False),
        maps(M16)),
    'C3k': (lambda: J.C3k(16, num_blocks=2, kernel_size=5),
            lambda: P.C3k(8, 16, num_blocks=2, kernel_size=5), maps(M16)),
    'C3K2': (lambda: J.C3K2(16, num_blocks=2),
             lambda: P.C3K2(8, 16, num_blocks=2), maps(M16)),
    'PSAAttention': (lambda: J.PSAAttention(num_heads=2),
                     lambda: P.PSAAttention(16, num_heads=2),
                     maps((8, 16))),
    'PSABlock': (lambda: J.PSABlock(num_heads=2),
                 lambda: P.PSABlock(16, num_heads=2), maps((8, 16))),
    'PSABlock_no_shortcut': (lambda: J.PSABlock(shortcut=False,
                                                attn_ratio=1.0),
                             lambda: P.PSABlock(16, 1.0, shortcut=False),
                             maps((8, 16))),
    'C2PSA': (lambda: J.C2PSA(24, num_blocks=2),
              lambda: P.C2PSA(16, 24, num_blocks=2), maps((8, 16))),
    'C2PSA_two_heads': (lambda: J.C2PSA(256),
                        lambda: P.C2PSA(8, 256), maps((4, 8))),
    'MaxSigmoidAttnBlock': (
        lambda: J.MaxSigmoidAttnBlock(8, 16, num_heads=2, with_scale=True),
        lambda: P.MaxSigmoidAttnBlock(8, 8, 12, 16, 2, with_scale=True),
        maps(M16, TEXT)),
    'MaxSigmoidAttnBlock_no_embed_conv': (
        lambda: J.MaxSigmoidAttnBlock(12, 8),
        lambda: P.MaxSigmoidAttnBlock(8, 12, 12, 8), maps(M16, TEXT)),
    'RepConvMaxSigmoidAttnBlock': (
        lambda: J.RepConvMaxSigmoidAttnBlock(8, 16, num_heads=2,
                                             with_scale=True),
        lambda: P.RepConvMaxSigmoidAttnBlock(8, 8, 12, 16, 2,
                                             with_scale=True),
        maps(M16, TEXT)),
    'MaxSigmoidAttnBlock_rep_proj': (
        lambda: J.MaxSigmoidAttnBlock(8, 8, rep_proj=True),
        lambda: P.MaxSigmoidAttnBlock(8, 8, 12, 8, rep_proj=True),
        maps(M16, TEXT)),
    'MaxSigmoidCSPLayerWithTwoConv': (
        lambda: J.MaxSigmoidCSPLayerWithTwoConv(16, 12, 16, num_blocks=2,
                                                num_heads=2, depth=2,
                                                with_scale=True),
        lambda: P.MaxSigmoidCSPLayerWithTwoConv(8, 16, 12, 16, 2, 2, 2,
                                                with_scale=True),
        maps(M16, TEXT)),
    'RepConvMaxSigmoidCSPLayerWithTwoConv': (
        lambda: J.RepConvMaxSigmoidCSPLayerWithTwoConv(16, 12, 8,
                                                       with_scale=True),
        lambda: P.RepConvMaxSigmoidCSPLayerWithTwoConv(8, 16, 12, 8,
                                                       with_scale=True),
        maps(M16, TEXT)),
    'ImagePoolingAttentionModule': (
        lambda: J.ImagePoolingAttentionModule(12, 16, num_heads=2,
                                              with_scale=True),
        lambda: P.ImagePoolingAttentionModule([8, 10, 6], 12, 16, 2,
                                              with_scale=True),
        maps(TEXT, [(16, 8), (8, 10), (2, 6)])),
    'ImagePoolingAttentionModule_pool4': (
        lambda: J.ImagePoolingAttentionModule(12, 16, num_heads=4,
                                              pool_size=4),
        lambda: P.ImagePoolingAttentionModule([8, 10], 12, 16, 4,
                                              pool_size=4),
        maps(TEXT, [(7, 8), (3, 10)])),
    'AFF_CSP': (lambda: J.AFF_CSP(), lambda: P.AFF_CSP(16),
                maps((16, 16), M16)),
    'iAFF_CSP': (lambda: J.iAFF_CSP(reduction=8),
                 lambda: P.iAFF_CSP(16, reduction=8),
                 maps((16, 16), M16)),
    'SpatialAttention': (lambda: J.SpatialAttention(kernel_size=5),
                         lambda: P.SpatialAttention(8, kernel_size=5),
                         maps(M16)),
    'C2fCBAM': (lambda: J.C2fCBAM(16, num_blocks=2),
                lambda: P.C2fCBAM(8, 16, num_blocks=2), maps(M16)),
    'ESE': (lambda: J.ESE(), lambda: P.ESE(8), maps(M16)),
    'LSKAttention': (lambda: J.LSKAttention(), lambda: P.LSKAttention(8),
                     maps(M16)),
    'ConvMlp': (lambda: J.ConvMlp(hidden_ratio=2.0),
                lambda: P.ConvMlp(8, 2.0), maps(M16)),
    'LSKA': (lambda: J.LSKA(), lambda: P.LSKA(8), maps(M16)),
    'ESELSKA': (lambda: J.ESELSKA(), lambda: P.ESELSKA(8), maps(M16)),
    'ASFFDown': (lambda: J.ASFFDown(12), lambda: P.ASFFDown([8, 10], 12),
                 maps(M16, (16, 10))),
    'DCAttention': (lambda: J.DCAttention(), lambda: P.DCAttention(8),
                    maps(M16, M8)),
    'DCAttention_widths': (lambda: J.DCAttention(num_heads=2, stride=2),
                           lambda: P.DCAttention([8, 12], num_heads=2,
                                                 stride=2),
                           maps(M16, (16, 12))),
    'DASFF': (lambda: J.DASFF(8), lambda: P.DASFF([8, 12], 8),
              maps(M16, (16, 12))),
    'DCASFF': (lambda: J.DCASFF(8), lambda: P.DCASFF([8, 12], 8),
               maps(M16, (8, 12))),
    'LSKModule': (lambda: J.LSKModule(), lambda: P.LSKModule(8), maps(M16)),
    'CSPSPPFModule': (lambda: J.CSPSPPFModule(8),
                      lambda: P.CSPSPPFModule(8, 8), maps(M16)),
    'MMDarknetBottleneck': (lambda: J.MMDarknetBottleneck(8),
                            lambda: P.MMDarknetBottleneck(8, 8), maps(M16)),
    'CSPLayerWithTwoConv': (lambda: J.CSPLayerWithTwoConv(16),
                            lambda: P.CSPLayerWithTwoConv(8, 16), maps(M16)),
    'SPPFBottleneck': (lambda: J.SPPFBottleneck(12),
                       lambda: P.SPPFBottleneck(8, 12), maps(M16)),
    'ChannelAttention': (lambda: J.ChannelAttention(),
                         lambda: P.ChannelAttention(8), maps(M16)),
    'YOLOv6RepPAFPN': (
        lambda: j_pafpn.YOLOv6RepPAFPN(in_channels=[256, 512, 768],
                                       out_channels=[256, 512, 768],
                                       deepen_factor=0.33,
                                       widen_factor=0.125),
        lambda: YOLOv6RepPAFPN(in_channels=[256, 512, 768],
                               out_channels=[256, 512, 768],
                               deepen_factor=0.33, widen_factor=0.125,
                               feat_widths=[24, 40, 56]),
        maps([(16, 24), (8, 40), (4, 56)])),
    'YOLOv6RepPAFPN_int_out': (
        lambda: j_pafpn.YOLOv6RepPAFPN(in_channels=[64, 128, 256],
                                       out_channels=64, deepen_factor=0.33,
                                       widen_factor=0.25,
                                       num_csp_blocks=3),
        lambda: YOLOv6RepPAFPN(in_channels=[64, 128, 256], out_channels=64,
                               deepen_factor=0.33, widen_factor=0.25,
                               num_csp_blocks=3, feat_widths=[16, 32, 64]),
        maps([(16, 16), (8, 32), (4, 64)])),
}


ALIASES = ('LSKModule', 'CSPSPPFModule', 'MMDarknetBottleneck')
REEXPORTS = ('CSPLayerWithTwoConv', 'SPPFBottleneck', 'ChannelAttention')


def jax_classes():
    """The classes that the JAX block file defines."""
    return sorted(n for n, v in vars(J).items()
                  if inspect.isclass(v) and v.__module__ == J.__name__
                  and v.__name__ == n)


def test_every_jax_block_has_a_counterpart_and_a_case():
    """The 38 classes of the JAX file, its 3 aliases and its 3 re-exports
    of ``models/blocks.py``: each has a port class of the same name and a
    parity case below; the aliases and re-exports are the same classes in
    the port."""
    own = jax_classes()
    assert len(own) == 38, own
    for name in own + list(ALIASES) + list(REEXPORTS):
        assert hasattr(J, name) and hasattr(P, name), name
        assert any(k == name or k.startswith(name + '_') for k in CASES), \
            name
    assert P.LSKModule is P.LSKBlock
    assert P.CSPSPPFModule is P.CSPSPPFBottleneck
    assert P.MMDarknetBottleneck is P.DarknetBottleneck is \
        PB.DarknetBottleneck
    for name in REEXPORTS:
        assert getattr(P, name) is getattr(PB, name)
    assert NECKS.get('YOLOv6RepPAFPN') is YOLOv6RepPAFPN


@pytest.mark.parametrize('name', sorted(CASES))
def test_block_matches_jax(name):
    """The outputs within 1e-5 of the reference's largest magnitude (and
    DCAttention's sampling positions); the port's state dict has every
    variable of the flax tree, and returns it unchanged."""
    make_jax, make_port, build = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    args = build(rng)
    jmod, pmod = make_jax(), make_port()
    jargs = [to_jax(a) for a in args]
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), *jargs)
    variables = fill_variables(shapes, rng)
    ref = jax.jit(jmod.apply)(variables, *jargs)
    pmod.load_state_dict(mirror_from_jax(variables), strict=True)
    back = mirror_to_jax(pmod.state_dict())
    flat = dict(jax.tree_util.tree_leaves_with_path(variables))
    assert len(jax.tree_util.tree_leaves(back)) == len(flat)
    for path, v in jax.tree_util.tree_leaves_with_path(back):
        assert np.array_equal(v, flat[path]), path
    with torch.no_grad():
        got = pmod(*[to_port(a) for a in args])
    refs, gots = outputs(ref), outputs(got)
    assert len(refs) == len(gots)
    for i, (r, g) in enumerate(zip(refs, gots)):
        assert np.isfinite(r).all()
        assert_close(r, g, f'{name} output {i}')
    if hasattr(pmod, 'out_widths'):
        assert [g.shape[1] for g in gots] == pmod.out_widths


def test_asff_shrinks_by_half_pixel_nearest():
    """At level 1, the finer map shrunk by 2 is read at rows and columns
    1, 3, 5, ... (``jax.image.resize``'s half-pixel nearest): a map that
    differs only in its even rows gives the same output."""
    asff = P.ASFF([4, 4, 4], level=1, out_channels=4)
    init_seeded_weights(asff, 3)
    rng = np.random.default_rng(5)
    feats = [torch.from_numpy(rng.normal(0, 1, (1, 4, s, s)).astype(
        np.float32)) for s in (8, 4, 2)]
    other = feats[0].clone()
    other[:, :, ::2] = 7.0
    other[:, :, :, ::2] = -7.0
    with torch.no_grad():
        a = asff(feats)
        b = asff([other] + feats[1:])
    assert torch.equal(a, b)


def test_seeded_initializers_are_the_jax_package_s():
    """After ``init_weights``' seeding the learned scales hold the JAX
    initializers (``id_scale`` 1, ``id_bias`` 0, ``alpha`` 1, LSKA's layer
    scales 1e-2, the image-pooling scale 0, DCASFF's gates 0, the
    MaxSigmoid bias 0 and scale 1), and ESE's ``fc`` has ``normal(0.001)``
    weights and a zero bias."""
    mods = torch.nn.ModuleDict(dict(
        rep=P.RepVGGBlock(8, 8), bottle=P.BottleRep(8, 8, True),
        lska=P.LSKA(8), pool=P.ImagePoolingAttentionModule(
            [8], 12, 16, 2, with_scale=True),
        dcasff=P.DCASFF(8, 8), sig=P.MaxSigmoidAttnBlock(
            8, 8, 12, 8, with_scale=True), ese=P.ESE(64)))
    init_seeded_weights(mods, 0)
    assert torch.equal(mods.rep.id_scale, torch.ones(8))
    assert torch.equal(mods.rep.id_bias, torch.zeros(8))
    assert torch.equal(mods.bottle.alpha, torch.ones(1))
    assert torch.equal(mods.lska.layer_scale_1, torch.full((8,), 1e-2))
    assert torch.equal(mods.lska.layer_scale_2, torch.full((8,), 1e-2))
    assert torch.equal(mods.pool.scale, torch.zeros(1))
    assert not mods.dcasff.alpha.any() and not mods.dcasff.beta.any()
    assert not mods.sig.bias.any() and torch.equal(mods.sig.scale,
                                                   torch.ones(1))
    fc = mods.ese.fc
    assert not fc.bias.any()
    assert 0.0005 < float(fc.weight.detach().std()) < 0.0015
    # a LeCun-normal conv elsewhere: std 1 / sqrt(fan in)
    w = mods.ese.conv.conv.weight
    assert 0.08 < float(w.detach().std()) < 0.17


def test_conv_module_activations():
    """``act``: SiLU by default, ReLU or none; anything else raises."""
    x = torch.linspace(-3, 3, 2 * 4 * 5 * 5).reshape(2, 4, 5, 5)
    mods = {a: PB.YOLOConvModule(4, 4, 3, act=a)
            for a in ('silu', 'relu', None)}
    for m in mods.values():
        m.load_state_dict(mods['silu'].state_dict())
    with torch.no_grad():
        pre = mods[None](x)
        torch.testing.assert_close(mods['silu'](x), torch.nn.functional.silu(
            pre), rtol=0, atol=0)
        torch.testing.assert_close(mods['relu'](x), pre.clamp(min=0), rtol=0,
                                   atol=0)
    assert sorted(mods['silu'].state_dict()) == ['bn.bias', 'bn.running_mean',
                                                 'bn.running_var',
                                                 'bn.weight', 'conv.weight']
    with pytest.raises(ValueError):
        PB.YOLOConvModule(4, 4, act='lrelu')
