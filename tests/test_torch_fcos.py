"""Port parity, Rotated FCOS: the FPN's ``on_output`` / ``on_lateral``
extra levels, ``MlvlPointGenerator``, ``DistanceAnglePointCoder``, and the
head (forward, point targets, each loss term, per-parameter gradients and
the decode) for the published recipe and its ``kld``, ``sep_angle`` and CSL
variants, against the JAX package on numpy-seeded features and weights
carried by ``from_jax_variables``; then one train step of each variant's
whole detector in the port.

Small sizes: one stacked conv, 64-wide towers (GroupNorm(32) with two
channels a group, so a conv bias before it has a gradient), 4 classes,
128 px. Tolerances are stated at each comparison."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orientedobjectdetection_tpu.core.anchors import \
    MlvlPointGenerator as JPoints
from orientedobjectdetection_tpu.core.coders import \
    DistanceAnglePointCoder as JPointCoder
from orientedobjectdetection_tpu.models import build_detector as j_build
from orientedobjectdetection_tpu.utils.registry import HEADS as J_HEADS
from orientedobjectdetection_tpu.utils.registry import NECKS as J_NECKS
from orientedobjectdetection_torch.core import (DistanceAnglePointCoder,
                                                MlvlPointGenerator)
from orientedobjectdetection_torch.models import build_detector
from orientedobjectdetection_torch.parallel import (build_lr_schedule,
                                                    build_optimizer,
                                                    create_train_state,
                                                    make_train_step)
from orientedobjectdetection_torch.utils import Config
from orientedobjectdetection_torch.utils.jax_weights import (
    from_jax_variables, to_jax_layout)
from orientedobjectdetection_torch.utils.registry import HEADS, NECKS

torch.set_num_threads(1)

SIZE = 128
STRIDES = [8, 16, 32, 64, 128]
CONFIGS = {
    'base': 'configs/rotated_fcos/rotated_fcos_r50_fpn_1x_dota_le90.py',
    'kld': 'configs/rotated_fcos/rotated_fcos_kld_r50_fpn_1x_dota_le90.py',
    'sep_angle':
        'configs/rotated_fcos/rotated_fcos_sep_angle_r50_fpn_1x_dota_le90.py',
    'csl': 'configs/csl/rotated_fcos_csl_gaussian_r50_fpn_1x_dota_le90.py',
}


def small_model(variant, channels=64):
    """The published model config, cut to ResNet-18, ``channels``-wide FPN
    and head, one stacked conv and 4 classes."""
    model = copy.deepcopy(dict(Config.fromfile(CONFIGS[variant]).model))
    model['backbone'] = dict(model['backbone'], depth=18, init_cfg=None)
    model['neck'] = dict(model['neck'], in_channels=[64, 128, 256, 512],
                         out_channels=channels)
    model['bbox_head'] = dict(model['bbox_head'], num_classes=4,
                              in_channels=channels, feat_channels=channels,
                              stacked_convs=1)
    model['test_cfg'] = dict(model['test_cfg'], nms_pre=100,
                             max_per_img=60, max_candidates=200)
    return model


def fill_variables(shapes, rng):
    """numpy values in the flax tree's shapes: every kernel, norm term and
    bias carries information; ``conv_reg``'s bias makes each predicted
    side a few strides long, so predicted boxes overlap their targets
    (with random regression weights the ReLU zeroes most sides and every
    box gradient vanishes)."""
    def fill(path, leaf):
        name, parent = path[-1].key, path[-2].key
        if name == 'kernel':
            v = rng.normal(0, 1 / np.sqrt(np.prod(leaf.shape[:-1])),
                           leaf.shape)
        elif name in ('scale', 'var'):
            v = rng.uniform(0.5, 1.5, leaf.shape)
        elif parent == 'conv_reg':
            v = rng.uniform(2.0, 3.0, leaf.shape)
        else:                                   # bias, mean
            v = rng.normal(0, 0.1, leaf.shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def head_state(variables):
    """Carried JAX head parameters -> the port head's state dict."""
    sd = from_jax_variables({'params': {'bbox_head': variables['params']}})
    return {k[len('bbox_head.'):]: v for k, v in sd.items()}


def make_gts(rng, bsz=2, g=8, valid=5):
    """Padded gts: ``valid`` random boxes of 10-70 px, one centred on a
    grid point, zeros after."""
    gts = np.zeros((bsz, g, 5), np.float32)
    gts[:, :valid, :2] = rng.uniform(16, SIZE - 16, (bsz, valid, 2))
    gts[:, :valid, 2:4] = rng.uniform(10, 70, (bsz, valid, 2))
    gts[:, :valid, 4] = rng.uniform(-1.5, 1.5, (bsz, valid))
    gts[:, 0, :2] = 60.0                         # on a stride-8 point
    labels = rng.integers(0, 4, (bsz, g)).astype(np.int32)
    mask = np.arange(g)[None].repeat(bsz, 0) < valid
    return gts, labels, mask


class HeadRun:
    """One variant's head in both packages on the same features and
    weights: JAX outputs, targets, losses, gradients and detections."""

    def __init__(self, variant, seed):
        rng = np.random.default_rng(seed)
        cfg = small_model(variant)
        head_cfg = dict(cfg['bbox_head'], train_cfg=cfg.get('train_cfg'),
                        test_cfg=cfg['test_cfg'])
        self.head_cfg = head_cfg
        c = head_cfg['in_channels']
        self.feats = [rng.normal(0, 1, (2, SIZE // s, SIZE // s, c))
                      .astype(np.float32) for s in STRIDES]
        self.gts = make_gts(rng)
        jh = J_HEADS.build(dict(head_cfg))
        self.jh = jh
        feats = [jnp.asarray(f) for f in self.feats]
        shapes = jax.eval_shape(jh.init, jax.random.PRNGKey(0), feats)
        self.variables = fill_variables(shapes, rng)
        gts = [jnp.asarray(a) for a in self.gts]

        def loss_fn(params):
            out = jh.apply({'params': params}, feats)
            losses = jh.loss(out, *gts)
            return sum(losses.values()), (losses, out)

        (_, (losses, out)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(
                self.variables['params'])
        self.j_out = jax.tree_util.tree_map(np.asarray, out)
        self.j_losses = {k: float(v) for k, v in losses.items()}
        self.j_grads = jax.tree_util.tree_map(np.asarray, grads)
        sizes = [f.shape[1:3] for f in self.feats]
        points, ranges, strides = jh._flat_points(sizes)
        self.j_targets = jax.tree_util.tree_map(np.asarray, jax.vmap(
            lambda gb, gl, gm: jh._targets_single(points, ranges, strides,
                                                  gb, gl, gm))(*gts))
        self.j_dets = None

    def port_head(self):
        head = HEADS.build(dict(self.head_cfg))
        head.load_state_dict(head_state(self.variables))
        return head

    def port_feats(self):
        return [torch.from_numpy(f).permute(0, 3, 1, 2) for f in self.feats]

    def jax_dets(self):
        if self.j_dets is None:
            self.j_dets = jax.tree_util.tree_map(np.asarray, jax.jit(
                self.jh.get_bboxes)(self.j_out))
        return self.j_dets


_RUNS = {}


def head_run(variant):
    if variant not in _RUNS:
        _RUNS[variant] = HeadRun(variant, seed=list(CONFIGS).index(variant))
    return _RUNS[variant]


def test_fpn_extra_levels_match_jax():
    """``on_output`` with a ReLU before the later extra convs (the FCOS
    neck) and ``on_lateral`` without: 5 levels from 4 inputs (start level
    1), 3 of them extra."""
    rng = np.random.default_rng(0)
    ins = [rng.normal(0, 1, (1, 32 // 2 ** i, 32 // 2 ** i, c))
           .astype(np.float32) for i, c in enumerate([8, 16, 24, 32])]
    for mode, relu in (('on_output', True), ('on_lateral', False)):
        cfg = dict(type='FPN', in_channels=[8, 16, 24, 32], out_channels=16,
                   start_level=1, add_extra_convs=mode, num_outs=5,
                   relu_before_extra_convs=relu)
        jn = J_NECKS.build(dict(cfg))
        shapes = jax.eval_shape(jn.init, jax.random.PRNGKey(0),
                                [jnp.asarray(x) for x in ins])
        variables = fill_variables(shapes, rng)
        ref = jn.apply(variables, [jnp.asarray(x) for x in ins])
        neck = NECKS.build(dict(cfg))
        sd = from_jax_variables({'params': {'neck': variables['params']}})
        neck.load_state_dict({k[len('neck.'):]: v for k, v in sd.items()})
        assert sorted(to_jax_layout(sd)['params']['neck']) == \
            sorted(variables['params'])
        got = neck([torch.from_numpy(x).permute(0, 3, 1, 2) for x in ins])
        assert len(got) == len(ref) == 5
        for g, r in zip(got, ref):              # rtol 1e-4: float32 convs
            np.testing.assert_allclose(g.permute(0, 2, 3, 1).detach(),
                                       np.asarray(r), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize('with_stride', [False, True])
def test_point_generator_matches_jax(with_stride):
    sizes = [(16, 12), (8, 6), (4, 3), (2, 2), (1, 1)]
    got = MlvlPointGenerator(STRIDES).grid_priors(sizes, 'cpu',
                                                  with_stride=with_stride)
    ref = JPoints(STRIDES).grid_priors(sizes, with_stride=with_stride)
    for g, r in zip(got, ref):                  # exact: the same float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize('angle_range', ['le90', 'le135', 'oc'])
def test_distance_angle_point_coder_matches_jax(angle_range):
    rng = np.random.default_rng(1)
    points = rng.uniform(0, 128, (64, 2)).astype(np.float32)
    gts = np.concatenate([rng.uniform(20, 100, (64, 2)),
                          rng.uniform(5, 60, (64, 2)),
                          rng.uniform(-3, 3, (64, 1))], -1).astype(np.float32)
    coder, ref = DistanceAnglePointCoder(angle_range), JPointCoder(angle_range)
    enc = coder.encode(torch.from_numpy(points), torch.from_numpy(gts))
    np.testing.assert_allclose(enc.numpy(), np.asarray(ref.encode(
        jnp.asarray(points), jnp.asarray(gts))), rtol=1e-5, atol=1e-4)
    clipped = coder.encode(torch.from_numpy(points), torch.from_numpy(gts),
                           max_dis=40.0)
    np.testing.assert_allclose(clipped.numpy(), np.asarray(ref.encode(
        jnp.asarray(points), jnp.asarray(gts), max_dis=40.0)),
        rtol=1e-5, atol=1e-4)
    dec = coder.decode(torch.from_numpy(points), enc, max_shape=(100, 90))
    np.testing.assert_allclose(dec.numpy(), np.asarray(ref.decode(
        jnp.asarray(points), jnp.asarray(enc.numpy()), max_shape=(100, 90))),
        rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize('variant', list(CONFIGS))
def test_head_forward_matches_jax(variant):
    run = head_run(variant)
    out = run.port_head()(run.port_feats())
    assert len(out) == 4
    for got_maps, ref_maps in zip(out, run.j_out):
        for g, r in zip(got_maps, ref_maps):    # rtol 1e-4: float32 convs
            np.testing.assert_allclose(g.permute(0, 2, 3, 1).detach(), r,
                                       rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('variant', ['base', 'sep_angle'])
def test_point_targets_match_jax(variant):
    """Exact labels and positives (gt 0 is centred on a point of level 0,
    padded gts are never matched); box and angle targets to float32."""
    run = head_run(variant)
    head = run.port_head()
    sizes = [f.shape[1:3] for f in run.feats]
    points, ranges, strides = head.flat_points(sizes, 'cpu')
    gts = [torch.from_numpy(a) for a in run.gts]
    labels, bt, at, pos = head.targets(points, ranges, strides, *gts)
    r_labels, r_bt, r_at, r_pos, _ = run.j_targets
    np.testing.assert_array_equal(pos.numpy(), r_pos)
    np.testing.assert_array_equal(labels.numpy(), r_labels)
    assert r_pos.sum() > 10
    np.testing.assert_allclose(bt.numpy()[r_pos], r_bt[r_pos], rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(at.numpy(), r_at, rtol=0, atol=0)


@pytest.mark.parametrize('variant', list(CONFIGS))
def test_head_loss_and_gradients_match_jax(variant):
    run = head_run(variant)
    head = run.port_head()
    out = head(run.port_feats())
    losses = head.loss(out, *[torch.from_numpy(a) for a in run.gts])
    assert sorted(losses) == sorted(run.j_losses)
    for k, v in losses.items():                  # rtol 1e-4: float32 sums
        np.testing.assert_allclose(v.item(), run.j_losses[k], rtol=1e-4,
                                   err_msg=k)
        assert run.j_losses[k] > 0
    sum(losses.values()).backward()
    grads = to_jax_layout({f'bbox_head.{n}': p.grad
                           for n, p in head.named_parameters()})
    got = dict(jax.tree_util.tree_leaves_with_path(
        grads['params']['bbox_head']))
    ref = dict(jax.tree_util.tree_leaves_with_path(run.j_grads))
    assert sorted(map(str, got)) == sorted(map(str, ref))
    for name in ('conv_reg', 'conv_angle', 'conv_cls', 'conv_centerness'):
        assert np.abs(run.j_grads[name]['kernel']).max() > 0, name
    for path, r in ref.items():                  # 1e-3 of each tensor's max
        np.testing.assert_allclose(got[path], r, rtol=0,
                                   atol=1e-3 * np.abs(r).max(),
                                   err_msg=str(path))


@pytest.mark.parametrize('variant', ['base', 'csl'])
def test_head_decode_matches_jax(variant):
    """Detections with the centerness as NMS score factors: labels and
    valid flags exact, boxes and scores to 1e-4. The CSL head reads its
    angles from the argmax bin."""
    run = head_run(variant)
    head = run.port_head()
    with torch.no_grad():
        dets, labels, valid = head.get_bboxes(head(run.port_feats()))
    r_dets, r_labels, r_valid = run.jax_dets()
    assert r_valid.sum() > 20
    np.testing.assert_array_equal(valid.numpy(), r_valid)
    np.testing.assert_array_equal(labels.numpy(), r_labels)
    np.testing.assert_allclose(dets.numpy(), r_dets, rtol=0, atol=1e-4)


def batch(rng, bsz=2):
    gts, labels, mask = make_gts(rng, bsz)
    return dict(images=torch.from_numpy(rng.normal(
        0, 1, (bsz, SIZE, SIZE, 3)).astype(np.float32)),
        gt_bboxes=torch.from_numpy(gts),
        gt_labels=torch.from_numpy(labels),
        gt_mask=torch.from_numpy(mask))


def test_detector_forward_and_loss_match_jax():
    """The whole published detector (ResNet-18, ``on_output`` FPN with a
    ReLU, FCOS head), 32 wide: the weights' names both ways, forward maps
    and losses."""
    cfg = small_model('base', channels=32)
    det = j_build(cfg)
    rng = np.random.default_rng(7)
    images = rng.normal(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    shapes = jax.eval_shape(det.init, jax.random.PRNGKey(0),
                            jnp.asarray(images))
    variables = fill_variables(shapes, rng)
    b = batch(rng)
    jb = {k: jnp.asarray(v.numpy()) for k, v in b.items()}
    out, losses = jax.jit(lambda v: (lambda o: (o, det.loss_from_outputs(
        o, jb)))(det.apply(v, jnp.asarray(images))))(variables)
    port = build_detector(cfg)
    state = from_jax_variables(variables)
    # mmrotate names, every flax leaf carried, none left over (strict load)
    assert {'bbox_head.cls_convs.0.gn.weight', 'bbox_head.scales.0.scale',
            'bbox_head.scale_angles.4.scale', 'bbox_head.conv_centerness.bias',
            'neck.fpn_convs.3.conv.weight'} <= set(state)
    assert state['bbox_head.scales.0.scale'].shape == ()
    port.load_state_dict(state)
    back = dict(jax.tree_util.tree_leaves_with_path(
        to_jax_layout(port.state_dict())))
    for path, v in jax.tree_util.tree_leaves_with_path(variables):
        np.testing.assert_array_equal(back[path], v, err_msg=str(path))
    got = port(torch.from_numpy(images).permute(0, 3, 1, 2))
    for got_maps, ref_maps in zip(got, out):
        for g, r in zip(got_maps, ref_maps):
            np.testing.assert_allclose(g.permute(0, 2, 3, 1).detach(),
                                       np.asarray(r), rtol=1e-4, atol=1e-4)
    b['images'] = torch.from_numpy(images)
    got_losses = port.loss_from_outputs(got, b)
    for k, v in losses.items():                  # rtol 1e-4: float32 sums
        np.testing.assert_allclose(got_losses[k].item(), float(v),
                                   rtol=1e-4, err_msg=k)


@pytest.mark.parametrize('variant', list(CONFIGS))
def test_variant_takes_a_train_step(variant):
    """Each recipe's whole detector builds from its config and takes one
    SGD step in the port: finite losses, the trainable tensors move."""
    cfg = small_model(variant, channels=32)
    detector = build_detector(cfg)
    tx = build_optimizer(dict(type='sgd', momentum=0.9, weight_decay=1e-4),
                         build_lr_schedule(dict(policy='step', step=[8]),
                                           0.01, 10),
                         grad_clip=dict(max_norm=35), frozen_stages=1)
    state = create_train_state(detector, tx, device='cpu')
    # predicted sides of a few strides: at a side of exactly 0 (ReLU of a
    # seeded init) the KLD of the ``kld`` recipe is NaN in both packages,
    # and the weight 0 of a negative point does not clear a NaN (ROADMAP C)
    with torch.no_grad():
        detector.bbox_head.conv_reg.bias.fill_(2.5)
    before = {n: p.detach().clone() for n, p in detector.named_parameters()
              if p.requires_grad}
    state, metrics = make_train_step(detector, tx)(
        state, batch(np.random.default_rng(8)))
    expect = {'loss_cls', 'loss_bbox', 'loss_centerness', 'loss', 'grad_norm'}
    if variant in ('sep_angle', 'csl'):
        expect.add('loss_angle')
    assert set(metrics) == expect
    assert all(np.isfinite(float(v)) for v in metrics.values())
    # every trainable tensor moves, but one that is zero with a zero
    # gradient: at 128 px the 1x1 top level reaches the head through a
    # GroupNorm of one element a group, which passes no gradient back
    still = [n for n, p in detector.named_parameters()
             if n in before and torch.equal(p, before[n])]
    assert all(not before[n].any() and not p.grad.any()
               for n, p in detector.named_parameters() if n in still), still
    assert len(still) <= 1
