"""Port parity, the point-set families: Rotated RepPoints, Oriented
RepPoints, G-RepPoints, SASM and CFA, each from its published DOTA config
cut to size, on weights carried from the JAX package
(``utils/jax_weights.py`` both ways): forward outputs, the targets of the
batched assigners, the losses with every parameter's gradient, and the
decode; every one of the 18 point-set configs builds.

Small sizes: ResNet-18, 64-wide FPN and head (GroupNorm(32) on 64 channels
keeps two channels a group, so the tower biases have a gradient), one
stacked conv, 2 classes, 128 px, G = 8 padded gts with 5 valid. The seeded
point outputs start on a 3 x 3 grid of 1.5 cells (``pts_init_out``'s bias)
so the point sets have a real hull. Tolerances are stated at each
comparison. Each detector's JAX loss and gradients are one jitted
``value_and_grad``, its decode one jitted call (module-scoped runs)."""

import copy
import glob

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orientedobjectdetection_tpu.models import build_detector as j_build
from orientedobjectdetection_torch.apis import init_detector
from orientedobjectdetection_torch.models import build_detector
from orientedobjectdetection_torch.models.backbones.resnet import \
    FrozenBatchNorm
from orientedobjectdetection_torch.utils import Config
from orientedobjectdetection_torch.utils.jax_weights import (
    from_jax_variables, to_jax_layout)
from orientedobjectdetection_torch.utils.registry import (BBOX_ASSIGNERS,
                                                          DETECTORS, HEADS,
                                                          LOSSES)
from test_torch_refine import leaves, same_detection_sets

torch.set_num_threads(1)

SIZE = 128
CONFIGS = {
    'rotated': 'configs/rotated_reppoints/'
               'rotated_reppoints_r50_fpn_1x_dota_oc.py',
    'oriented': 'configs/oriented_reppoints/'
                'oriented_reppoints_r50_fpn_1x_dota_le135.py',
    'g': 'configs/g_reppoints/g_reppoints_r50_fpn_1x_dota_le135.py',
    'sasm': 'configs/sasm_reppoints/sasm_reppoints_r50_fpn_1x_dota_oc.py',
    'cfa': 'configs/cfa/cfa_r50_fpn_1x_dota_le135.py',
}
TINY_CONFIGS = {
    'oriented': 'configs/oriented_reppoints/oriented_reppoints_tiny_synth.py',
    'cfa': 'configs/cfa/cfa_tiny_synth.py',
    'sasm': 'configs/sasm_reppoints/sasm_tiny_synth.py',
    'g': 'configs/g_reppoints/g_reppoints_tiny_synth.py',
}
POINT_SET_CONFIGS = sorted(
    f for d in ('rotated_reppoints', 'oriented_reppoints', 'sasm_reppoints',
                'g_reppoints', 'cfa')
    for f in glob.glob(f'configs/{d}/*.py'))
# the 3 x 3 grid the seeded initial points start on, (dy, dx) in cells
GRID = np.stack(np.meshgrid([-1.5, 0.0, 1.5], [-1.5, 0.0, 1.5],
                            indexing='ij'), -1).reshape(-1)


def small_model(key, channels=64, classes=2, tiny=False):
    """The published model config cut to ResNet-18, ``channels``-wide FPN
    and head, one stacked conv and ``classes`` classes; ``tiny``: the
    tiny-synth config as it stands (already R18, 64 wide)."""
    if tiny:
        return copy.deepcopy(dict(Config.fromfile(TINY_CONFIGS[key]).model))
    model = copy.deepcopy(dict(Config.fromfile(CONFIGS[key]).model))
    model['backbone'] = dict(model['backbone'], depth=18, init_cfg=None)
    model['neck'] = dict(model['neck'], in_channels=[64, 128, 256, 512],
                         out_channels=channels)
    model['bbox_head'] = dict(model['bbox_head'], num_classes=classes,
                              in_channels=channels, feat_channels=channels,
                              point_feat_channels=channels, stacked_convs=1)
    model['test_cfg'] = dict(model['test_cfg'], nms_pre=100,
                             max_per_img=60, max_candidates=200)
    return model


def fill_variables(shapes, rng):
    """numpy values in the flax tree's shapes: LeCun-normal kernels (the
    point outputs' x 0.1), the initial points' bias on :data:`GRID`, zero
    class biases (scores near 0.5, so NMS sees real candidates), random
    frozen BN and small random biases."""
    def fill(path, leaf):
        name, parent = path[-1].key, path[-2].key
        if name == 'kernel':
            scale = 0.1 if parent in ('pts_init_out', 'pts_refine_out') \
                else 1.0
            v = rng.normal(0, scale / np.sqrt(np.prod(leaf.shape[:-1])),
                           leaf.shape)
        elif name in ('scale', 'var'):
            v = rng.uniform(0.5, 1.5, leaf.shape)
        elif parent == 'cls_out':
            v = np.zeros(leaf.shape)
        elif parent == 'pts_init_out':
            v = GRID + rng.normal(0, 0.1, leaf.shape)
        else:                                   # bias, mean
            v = rng.normal(0, 0.1, leaf.shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def random_gts(rng, bsz=2, g=8, valid=5, classes=2, size=SIZE):
    """Padded rotated gts of 12-70 px inside the image; zero boxes after
    ``valid``."""
    obb = np.stack([rng.uniform(20, size - 20, (bsz, g)),
                    rng.uniform(20, size - 20, (bsz, g)),
                    rng.uniform(12, 70, (bsz, g)),
                    rng.uniform(12, 70, (bsz, g)),
                    rng.uniform(-0.7, 0.7, (bsz, g))], -1).astype(np.float32)
    mask = np.arange(g)[None].repeat(bsz, 0) < valid
    obb[~mask] = 0
    labels = rng.integers(0, classes, (bsz, g)).astype(np.int32)
    return obb, labels, mask


def to_port(tree):
    """JAX outputs -> the port's: NHWC maps NCHW, (B, H, W) maps as they
    are."""
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_port(v) for v in tree)
    v = torch.from_numpy(np.array(tree))
    return v.permute(0, 3, 1, 2) if v.dim() == 4 else v


def to_jax(tree):
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_jax(v) for v in tree)
    v = tree.detach()
    return (v.permute(0, 2, 3, 1) if v.dim() == 4 else v).numpy()


class DetRun:
    """One detector in both packages on carried weights: the JAX outputs,
    losses and gradients (one jitted value_and_grad), its targets
    (``_loss_common``, jitted) and its jitted decode of those outputs."""

    def __init__(self, cfg, seed, classes=2):
        rng = np.random.default_rng(seed)
        self.cfg = cfg
        det = j_build(cfg)
        self.images = rng.normal(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
        shapes = jax.eval_shape(det.init, jax.random.PRNGKey(0),
                                jnp.asarray(self.images))
        self.variables = fill_variables(shapes, rng)
        gts = random_gts(rng, classes=classes)
        self.batch = dict(images=self.images, gt_bboxes=gts[0],
                          gt_labels=gts[1], gt_mask=gts[2])
        batch = {k: jnp.asarray(v) for k, v in self.batch.items()}
        stats = self.variables['batch_stats']

        def loss_fn(params, images):
            out = det.apply({'params': params, 'batch_stats': stats}, images)
            losses = det.loss_from_outputs(out, batch)
            return sum(losses.values()), (losses, out)

        value_and_grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        (_, (losses, out)), grads = value_and_grad(self.variables['params'],
                                                   batch['images'])
        self.j_losses = {k: float(v) for k, v in losses.items()}
        self.j_grads = jax.tree_util.tree_map(np.asarray, grads)
        self.j_out = jax.tree_util.tree_map(np.asarray, out)
        # the JAX package's own spread: its gradients for images scaled by
        # 1 -+ 3e-6 and with N(0, 1e-6) added (a discrete choice near its
        # edge, a hull vertex or an assignment, moves some tensors'
        # gradients by percents)
        self.j_spread = jax.tree_util.tree_map(np.zeros_like, self.j_grads)
        for nudge in (self.images * np.float32(1 + 3e-6),
                      self.images * np.float32(1 - 3e-6),
                      self.images + rng.normal(0, 1e-6, self.images.shape)
                      .astype(np.float32)):
            nudged = value_and_grad(self.variables['params'],
                                    jnp.asarray(nudge))[1]
            self.j_spread = jax.tree_util.tree_map(
                lambda s, a, b: np.maximum(s, np.abs(a - np.asarray(b))),
                self.j_spread, self.j_grads, nudged)
        self.j_out_grads = jax.tree_util.tree_map(np.asarray, jax.jit(
            jax.grad(lambda o: sum(det.loss_from_outputs(
                o, batch).values())))(out))
        head = det.make_head()
        keys = ('init_w', 'arg_r', 'pos_r', 'neg_r', 'labels_r', 'init_tgt',
                'ref_tgt')
        self.j_targets = jax.tree_util.tree_map(np.asarray, jax.jit(
            lambda o: {k: v for k, v in head._loss_common(
                o, batch['gt_bboxes'], batch['gt_labels'],
                batch['gt_mask']).items() if k in keys})(out))
        self.j_dets = jax.tree_util.tree_map(
            np.asarray, jax.jit(det.bboxes_from_outputs)(out))

    def port(self):
        detector = build_detector(self.cfg)
        detector.load_state_dict(from_jax_variables(self.variables))
        return detector

    def port_images(self):
        return torch.from_numpy(self.images).permute(0, 3, 1, 2)

    def port_batch(self):
        return {k: torch.from_numpy(v) for k, v in self.batch.items()}


_RUNS = {}


def det_run(key):
    if key not in _RUNS:
        _RUNS[key] = DetRun(small_model(key), seed=list(CONFIGS).index(key))
    return _RUNS[key]


# the parameters ``frozen_stages=1`` freezes (every point-set config): no
# update reads their gradients, the last of the backward
FROZEN = ('backbone/conv1/', 'backbone/bn1/', 'backbone/layer1_')


def check_grads(detector, j_grads, j_spread=None, rel=2e-3, frozen_rel=5e-3,
                floor=1e-5):
    """Every parameter's gradient within ``rel`` of its tensor's largest
    (float32 sums over a ResNet-18 and the point-set losses in another
    order: layer 2's come within 1.1e-3; the frozen stem and layer 1,
    ``frozen_rel``, within 2.4e-3), at least ``floor`` of
    the detector's largest gradient (a tower conv's bias before a GroupNorm
    of two channels a group has a gradient of sums that cancel, some 1e-4 of
    the largest), or within twice the JAX package's own spread of that
    tensor (:class:`DetRun`); none of them 0."""
    grads = dict(leaves(to_jax_layout(
        {n: p.grad for n, p in detector.named_parameters()
         if p.grad is not None})['params']))
    ref = dict(leaves(j_grads))
    spread = dict(leaves(j_spread)) if j_spread is not None else {}
    assert sorted(grads) == sorted(ref)
    largest = max(np.abs(r).max() for r in ref.values())
    for name, r in ref.items():
        assert np.abs(r).max() > 0, name
        atol = max((frozen_rel if name.startswith(FROZEN) else rel) *
                   np.abs(r).max(), floor * largest)
        if name in spread:
            atol = max(atol, 2 * spread[name].max())
        err = np.abs(grads[name] - r)
        assert (err <= atol).all(), \
            f'{name}: {float((err - atol).max())} beyond the tolerance'


# ---- builds --------------------------------------------------------------
def test_the_point_set_configs_are_listed():
    assert len(POINT_SET_CONFIGS) == 18
    for name in ('RotatedRepPoints',):
        assert name in DETECTORS
    for name in ('RotatedRepPointsHead', 'OrientedRepPointsHead',
                 'SAMRepPointsHead', 'KLDRepPointsHead'):
        assert name in HEADS
    for name in ('ConvexAssigner', 'MaxConvexIoUAssigner', 'SASAssigner',
                 'ATSSKldAssigner'):
        assert name in BBOX_ASSIGNERS
    for name in ('ConvexGIoULoss', 'BCConvexGIoULoss', 'KLDRepPointsLoss',
                 'SpatialBorderLoss'):
        assert name in LOSSES


@pytest.mark.parametrize('path', POINT_SET_CONFIGS)
def test_config_builds(path):
    """Every point-set config builds on the CPU through ``init_detector``
    with seeded weights, its head of the config's type."""
    cfg = Config.fromfile(path)
    bundle = init_detector(cfg, device='cpu')
    head = bundle.detector.bbox_head
    assert type(head).__name__ == cfg.model.bbox_head['type']
    assert bundle.num_classes == head.num_classes
    assert type(bundle.detector).__name__ == 'RotatedRepPoints'


def test_every_parameter_seeded_and_cast():
    """The Oriented RepPoints config at full width: ``init_weights(seed)``
    alone sets every parameter (the deformable projections and their
    biases included), and a bfloat16 bundle holds every parameter outside
    the frozen BN in bfloat16."""
    cfg = Config.fromfile(CONFIGS['oriented'])
    built = []
    for global_seed in (1, 2):
        torch.manual_seed(global_seed)
        detector = build_detector(dict(cfg.model))
        detector.init_weights(0)
        built.append(dict(detector.named_parameters()))
    for name, p in built[0].items():
        assert torch.equal(p, built[1][name]), f'{name} not seeded'
    assert built[0]['bbox_head.reppoints_cls_conv.weight'].shape == \
        (256, 256, 3, 3)
    assert float(built[0]['bbox_head.reppoints_cls_conv.weight'].detach()
                 .std()) > 0
    torch.manual_seed(3)
    bundle = init_detector(cfg, device='cpu', dtype=torch.bfloat16)
    frozen = {f'{m}.{p}' for m, mod in bundle.detector.named_modules()
              if isinstance(mod, FrozenBatchNorm)
              for p, _ in mod.named_parameters()}
    gn = {n for n, _ in bundle.detector.named_parameters() if '.gn.' in n}
    for name, p in bundle.detector.named_parameters():
        want = torch.float32 if name in frozen | gn else torch.bfloat16
        assert p.dtype == want, name


# ---- the detectors ---------------------------------------------------------
@pytest.mark.parametrize('key', list(CONFIGS))
def test_forward_matches_jax(key):
    """Every map within 1e-4 of its output's largest value over the levels
    (Oriented RepPoints' correlation maps included)."""
    run = det_run(key)
    with torch.no_grad():
        out = run.port()(run.port_images())
    got, ref = to_jax(out), run.j_out
    assert len(got) == len(ref) == (4 if key == 'oriented' else 3)
    for g_lv, r_lv in zip(got, ref):
        scale = max(np.abs(r).max() for r in r_lv)
        for g, r in zip(g_lv, r_lv):
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize('key', list(CONFIGS))
def test_targets_match_jax(key):
    """The init (ConvexAssigner) and refine (MaxConvexIoU, SAS or ATSS-KLD)
    assignments of the JAX package's own outputs: the positives, negatives
    and labels equal, and each positive's gt and target polygon (within
    1e-4 px). Elsewhere the gt index is an argmax of overlaps that may all
    be 0 or tie within rounding, and no loss reads it."""
    run = det_run(key)
    detector = run.port()
    b = run.port_batch()
    tg = detector.bbox_head.targets(to_port(run.j_out), b['gt_bboxes'],
                                    b['gt_labels'], b['gt_mask'])
    ref = run.j_targets
    for k in ('pos_r', 'neg_r', 'labels_r', 'init_w'):
        np.testing.assert_array_equal(tg[k].numpy(), ref[k], err_msg=k)
    pos_i, pos_r = ref['init_w'] > 0, ref['pos_r']
    np.testing.assert_array_equal(tg['arg_r'].numpy()[pos_r],
                                  ref['arg_r'][pos_r])
    for k, pos in (('init_tgt', pos_i), ('ref_tgt', pos_r)):
        np.testing.assert_allclose(tg[k].numpy()[pos], ref[k][pos], rtol=0,
                                   atol=1e-4, err_msg=k)
    assert 0 < pos_i.sum() and 0 < pos_r.sum()


@pytest.mark.parametrize('key', list(CONFIGS))
def test_loss_and_gradients_match_jax(key):
    """The losses at rtol 1e-5, each positive (CFA's and APAA's keeps and
    SASM's weights among them); every parameter's gradient within 2e-3 of
    its tensor's largest (5e-3 in the frozen stem and layer 1), 1e-5 of the
    detector's, or twice the JAX
    package's own spread for inputs 3e-6 apart (:func:`check_grads`)."""
    run = det_run(key)
    detector = run.port()
    losses = detector.loss_from_outputs(detector(run.port_images()),
                                        run.port_batch())
    assert sorted(losses) == sorted(run.j_losses)
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), run.j_losses[k], rtol=1e-5,
                                   err_msg=k)
        assert run.j_losses[k] > 0, k
    sum(losses.values()).backward()
    check_grads(detector, run.j_grads, run.j_spread)


@pytest.mark.parametrize('key', list(CONFIGS))
def test_loss_gradient_at_the_outputs_matches_jax(key):
    """The total loss's gradient in every output map, both packages fed the
    JAX outputs: within 1e-4 of each map's largest entry."""
    run = det_run(key)
    outs = tuple(tuple(t.clone().requires_grad_() for t in lv)
                 for lv in to_port(run.j_out))
    losses = run.port().loss_from_outputs(outs, run.port_batch())
    sum(losses.values()).backward()
    n_maps = 0
    for lv, j_lv in zip(outs, run.j_out_grads):
        for t, r in zip(lv, j_lv):
            if t.grad is None:                      # the correlation maps
                assert not np.abs(r).any()
                continue
            got = to_jax(t.grad)
            np.testing.assert_allclose(got, r, rtol=0,
                                       atol=1e-4 * np.abs(r).max())
            n_maps += 1
    assert n_maps == 15


@pytest.mark.parametrize('key', list(CONFIGS))
def test_decode_matches_jax(key):
    """``bboxes_from_outputs`` of the JAX package's outputs: the same
    detection sets, boxes within 1e-3, scores within 1e-5."""
    run = det_run(key)
    with torch.no_grad():
        got = run.port().bboxes_from_outputs(to_port(run.j_out))
    assert got[0].shape == (2, 60, 6)
    assert same_detection_sets(got, run.j_dets) > 20


# ---- weights -------------------------------------------------------------
@pytest.mark.parametrize('key', ['rotated', 'oriented'])
def test_weights_round_trip(key):
    """JAX variables -> the port's state dict (loaded strictly) -> the flax
    layout gives back the same tree."""
    cfg = small_model(key)
    det = j_build(cfg)
    shapes = jax.eval_shape(det.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, SIZE, SIZE, 3)))
    variables = fill_variables(shapes, np.random.default_rng(1))
    detector = build_detector(cfg)
    detector.load_state_dict(from_jax_variables(variables))
    assert {'bbox_head.reppoints_cls_conv.weight',
            'bbox_head.reppoints_cls_conv.bias',
            'bbox_head.reppoints_pts_refine_conv.bias',
            'bbox_head.reppoints_pts_init_out.weight',
            'bbox_head.reppoints_cls_out.bias',
            'bbox_head.cls_convs.0.gn.weight',
            'bbox_head.reg_convs.0.conv.bias'} <= set(detector.state_dict())
    back = dict(leaves(to_jax_layout(detector.state_dict())))
    ref = dict(leaves(variables))
    assert sorted(back) == sorted(ref)
    for name, r in ref.items():
        np.testing.assert_array_equal(back[name], r, err_msg=name)


@pytest.mark.parametrize('flax_name, port_name', [
    ('cls_dcn', 'reppoints_cls_conv'),
    ('refine_dcn', 'reppoints_pts_refine_conv')])
def test_dcn_weight_meets_its_tap(flax_name, port_name):
    """``bbox_head.<port_name>.weight[:, :, ky, kx]`` is the flax dense
    kernel's rows of tap ``ky * 3 + kx`` (the align projections'
    reshape), and the bias carries as it is."""
    rng = np.random.default_rng(0)
    w, bias = rng.normal(0, 1, (6, 4, 3, 3)), rng.normal(0, 1, 6)
    tree = to_jax_layout({f'bbox_head.{port_name}.weight': w,
                          f'bbox_head.{port_name}.bias': bias})
    dense = tree['params']['bbox_head'][flax_name]
    assert dense['kernel'].shape == (36, 6)
    for ky in range(3):
        for kx in range(3):
            t = ky * 3 + kx
            np.testing.assert_array_equal(dense['kernel'][t * 4:(t + 1) * 4],
                                          w[:, :, ky, kx].T)
    np.testing.assert_array_equal(dense['bias'], bias)
    back = from_jax_variables({'params': {'bbox_head': {
        flax_name: dense, 'pts_init_conv': {'bias': np.zeros(1)}}}})
    np.testing.assert_array_equal(back[f'bbox_head.{port_name}.weight'],
                                  w.astype(np.float32))
