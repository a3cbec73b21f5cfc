"""Port parity, the refine detectors S2ANet and R3Det: ``filter_bboxes``
(the same best anchors, ties to the first), ``refine_bboxes``, both
detectors' forward outputs on carried weights (and their second stage fed
the JAX package's own rois, so that a roi difference cannot compound),
``loss_from_outputs`` with the per-parameter gradients, and
``bboxes_from_outputs`` as detection sets up to near-ties; the weight
carry both ways, and every parameter seeded by ``init_weights`` and cast by
``init_detector``.

Small sizes: ResNet-18, 32-wide FPN and heads, one stacked conv, 2
classes, 128 px, G = 8 padded gts with 5 valid. Tolerances are stated at
each comparison. Each detector's JAX loss, gradients and decode are jitted
once (module-scoped runs)."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orientedobjectdetection_tpu.models import build_detector as j_build
from orientedobjectdetection_tpu.utils.registry import HEADS as J_HEADS
from orientedobjectdetection_torch.apis import init_detector
from orientedobjectdetection_torch.core import RotatedAnchorGenerator
from orientedobjectdetection_torch.models import build_detector
from orientedobjectdetection_torch.models.backbones.resnet import \
    FrozenBatchNorm
from orientedobjectdetection_torch.models.detectors.refine_detectors import \
    split_levels
from orientedobjectdetection_torch.ops.iou import box_iou_rotated
from orientedobjectdetection_torch.utils import Config
from orientedobjectdetection_torch.utils.jax_weights import (
    from_jax_variables, to_jax_layout)
from orientedobjectdetection_torch.utils.registry import HEADS

torch.set_num_threads(1)

SIZE = 128
STRIDES = [8, 16, 32, 64, 128]
SIZES = [(SIZE // s, SIZE // s) for s in STRIDES]
CONFIGS = {
    's2anet': 'configs/s2anet/s2anet_r50_fpn_1x_dota_le135.py',
    'r3det': 'configs/r3det/r3det_r50_fpn_1x_dota_oc.py',
    'r3det_refine': 'configs/r3det/r3det_refine_r50_fpn_1x_dota_oc.py',
    's2anet_kfiou': 'configs/kfiou/s2anet_kfiou_ln_r50_fpn_1x_dota_le135.py',
    'r3det_kfiou': 'configs/kfiou/r3det_kfiou_ln_r50_fpn_1x_dota_oc.py',
    's2anet_hrsc': 'configs/s2anet/s2anet_r50_fpn_3x_hrsc_le135.py',
}
# the class and regression output convolutions, flax names
CLS_OUT = ('cls_out', 'odm_cls')
REG_OUT = ('reg_out', 'odm_reg')


def small_model(key, channels=32, classes=2):
    """The published model config cut to ResNet-18, ``channels``-wide FPN,
    heads, align and refine modules, one stacked conv and ``classes``
    classes."""
    model = copy.deepcopy(dict(Config.fromfile(CONFIGS[key]).model))
    model['backbone'] = dict(model['backbone'], depth=18, init_cfg=None)
    model['neck'] = dict(model['neck'], in_channels=[64, 128, 256, 512],
                         out_channels=channels)
    cut = dict(num_classes=classes, in_channels=channels,
               feat_channels=channels, stacked_convs=1)
    for k in ('bbox_head', 'fam_head', 'odm_head'):
        if k in model:
            model[k] = dict(model[k], **cut)
    if 'refine_heads' in model:
        model['refine_heads'] = [dict(h, **cut)
                                 for h in model['refine_heads']]
        model['frm_cfgs'] = [dict(f, in_channels=channels)
                             for f in model['frm_cfgs']]
    if 'align_cfgs' in model:
        model['align_cfgs'] = dict(model['align_cfgs'], channels=channels)
    model['test_cfg'] = dict(model['test_cfg'], nms_pre=100,
                             max_per_img=60, max_candidates=200)
    return model


def fill_variables(shapes, rng):
    """numpy values in the flax tree's shapes: LeCun-normal kernels,
    regression outputs scaled by 0.05 (deltas of a trained head: rois near
    their anchors), zero class biases (scores near 0.5, so NMS sees real
    candidates), random frozen BN."""
    def fill(path, leaf):
        name, parent = path[-1].key, path[-2].key
        if name == 'kernel':
            scale = 0.05 if parent in REG_OUT else 1.0
            v = rng.normal(0, scale / np.sqrt(np.prod(leaf.shape[:-1])),
                           leaf.shape)
        elif name in ('scale', 'var'):
            v = rng.uniform(0.5, 1.5, leaf.shape)
        elif parent in CLS_OUT:
            v = np.zeros(leaf.shape)
        else:                                   # bias, mean
            v = rng.normal(0, 0.1, leaf.shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def first_stage_anchors():
    """R3Det's stage-0 anchors (9 a location) and S2ANet's FAM anchors (a
    32 px square at level 0) at 128 px."""
    r3det = RotatedAnchorGenerator(octave_base_scale=4, scales_per_octave=3,
                                   ratios=[1.0, 0.5, 2.0], strides=STRIDES)
    fam = RotatedAnchorGenerator(scales=[4], ratios=[1.0], strides=STRIDES)
    return [torch.cat(g.grid_priors(SIZES), 0) for g in (r3det, fam)]


def well_posed(gts, anchor_sets, thresholds=(0.4, 0.5), margin=1e-4):
    """Whether the MaxIoU assignment of these gts (G, 5) is decided with a
    ``margin`` against every anchor set: each gt's best anchor leads the
    next by more, and no anchor's best IoU lies that close to a threshold.
    Where it is not, the assignment turns on float32 rounding (anchors
    inside a gt, or crossed by it, tie in exact arithmetic), and the JAX
    package's eager and jitted runs disagree (ROADMAP C)."""
    for anchors in anchor_sets:
        iou = box_iou_rotated(torch.from_numpy(gts), anchors)    # (G, N)
        top2 = iou.topk(2, dim=1)[0]
        if (top2[:, 0] - top2[:, 1] <= margin).any():
            return False
        best = iou.amax(0)
        if any((best - t).abs().min() <= margin for t in thresholds):
            return False
    return True


def anchor_gts(rng, bsz=2, g=8, valid=5, classes=2):
    """Padded gts copied from R3Det's stage-0 anchors and perturbed, so each
    has positives; zero boxes after ``valid``. An image's draw is repeated
    until its assignment is :func:`well_posed`."""
    r3det, fam = first_stage_anchors()
    anchors = r3det.numpy()
    inside = anchors[(anchors[:, 2:4].max(1) < 70) &
                     (anchors[:, :2].min(1) > 8)]
    gts = np.zeros((bsz, g, 5), np.float32)
    for b in range(bsz):
        while True:
            pick = inside[rng.choice(len(inside), valid, replace=False)]
            pick[:, :2] += rng.uniform(-3, 3, (valid, 2))
            pick[:, 2:4] *= rng.uniform(0.8, 1.25, (valid, 2))
            pick[:, 4] = rng.uniform(0.05, 0.3, valid)
            if well_posed(pick, (r3det, fam)):
                break
        gts[b, :valid] = pick
    labels = rng.integers(0, classes, (bsz, g)).astype(np.int32)
    mask = np.arange(g)[None].repeat(bsz, 0) < valid
    return gts, labels, mask


def to_port(tree):
    """JAX outputs -> the port's: NHWC maps NCHW, rois as they are."""
    if isinstance(tree, dict):
        return {k: to_port(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_port(v) for v in tree)
    v = torch.from_numpy(np.array(tree))
    return v.permute(0, 3, 1, 2) if v.dim() == 4 else v


def to_jax(tree):
    """The port's outputs -> numpy in the JAX package's layout."""
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_jax(v) for v in tree)
    v = tree.detach()
    return (v.permute(0, 2, 3, 1) if v.dim() == 4 else v).numpy()


def leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, path + (k,))
        else:
            yield '/'.join(path + (k,)), np.asarray(v)


def output_leaves(tree, path=''):
    """(name, array) over a nested dict / list / tuple of outputs."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from output_leaves(v, f'{path}/{k}')
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from output_leaves(v, f'{path}/{i}')
    else:
        yield path, np.asarray(tree)


def batch_of(images, gts):
    gt_bboxes, gt_labels, gt_mask = gts
    return dict(images=images, gt_bboxes=gt_bboxes, gt_labels=gt_labels,
                gt_mask=gt_mask)


class DetRun:
    """One detector in both packages on carried weights: the JAX outputs,
    losses and gradients (one jitted value_and_grad) and, on request, its
    jitted decode of those outputs."""

    def __init__(self, key, seed, decode=True):
        rng = np.random.default_rng(seed)
        self.cfg = small_model(key)
        det = j_build(self.cfg)
        self.images = rng.normal(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
        shapes = jax.eval_shape(det.init, jax.random.PRNGKey(0),
                                jnp.asarray(self.images))
        self.variables = fill_variables(shapes, rng)
        self.batch = batch_of(self.images, anchor_gts(rng))
        batch = {k: jnp.asarray(v) for k, v in self.batch.items()}
        stats = self.variables['batch_stats']

        def loss_fn(params):
            out = det.apply({'params': params, 'batch_stats': stats},
                            batch['images'])
            losses = det.loss_from_outputs(out, batch)
            return sum(losses.values()), (losses, out)

        (_, (losses, out)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(
                self.variables['params'])
        self.j_losses = {k: float(v) for k, v in losses.items()}
        self.j_grads = jax.tree_util.tree_map(np.asarray, grads)
        self.j_out = jax.tree_util.tree_map(np.asarray, out)
        self.j_dets = jax.tree_util.tree_map(
            np.asarray, jax.jit(det.bboxes_from_outputs)(out)) \
            if decode else None

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
        _RUNS[key] = DetRun(key, seed=list(CONFIGS).index(key))
    return _RUNS[key]


def check_outputs(got, ref, err_msg):
    """Per map / roi tensor: |port - JAX| <= 1e-4 x its largest value."""
    got, ref = dict(output_leaves(got)), dict(output_leaves(ref))
    assert sorted(got) == sorted(ref)
    for name, r in ref.items():
        np.testing.assert_allclose(got[name], r, rtol=0,
                                   atol=1e-4 * np.abs(r).max(),
                                   err_msg=f'{err_msg} {name}')


def same_detection_sets(got, ref, box_atol=1e-3, score_band=1e-5):
    """Per image, the valid detections as sets: equal counts, and each
    JAX detection matched by a port detection of the same label with its
    box within ``box_atol`` and its score within ``score_band`` (rows may
    swap between near-tied scores)."""
    dets, labels, valid = (np.asarray(t) for t in got)
    r_dets, r_labels, r_valid = (np.asarray(t) for t in ref)
    np.testing.assert_array_equal(valid.sum(1), r_valid.sum(1))
    for b in range(len(valid)):
        mine = np.concatenate([dets[b][valid[b]],
                               labels[b][valid[b]][:, None]], 1)
        theirs = np.concatenate([r_dets[b][r_valid[b]],
                                 r_labels[b][r_valid[b]][:, None]], 1)
        for row in theirs:
            close = (mine[:, 6] == row[6]) & \
                (np.abs(mine[:, :5] - row[:5]).max(1) <= box_atol) & \
                (np.abs(mine[:, 5] - row[5]) <= score_band)
            assert close.any(), f'image {b}: no match for {row}'
    return int(r_valid.sum())


# ---- head logic -------------------------------------------------------------
def random_maps(rng, a_n, classes, ties=True):
    """Per-level NHWC class logits and deltas for ``a_n`` anchors a
    location; with ``ties`` a share of locations whose anchors share their
    best logit."""
    cls_scores, bbox_preds = [], []
    for h, w in SIZES:
        s = rng.normal(0, 1, (2, h, w, a_n * classes)).astype(np.float32)
        if ties and a_n > 1:
            tied = rng.random((2, h, w)) < 0.3
            s.reshape(2, h, w, a_n, classes)[tied] = 0.75
        cls_scores.append(s)
        bbox_preds.append(rng.normal(0, 0.3, (2, h, w, a_n * 5))
                          .astype(np.float32))
    return cls_scores, bbox_preds


@pytest.mark.parametrize('key, a_n', [('r3det', 9), ('s2anet', 1)])
def test_filter_bboxes_matches_jax(key, a_n):
    """R3Det's stage 0 (9 anchors, ties at 30% of the locations: the first
    anchor wins in both) and S2ANet's FAM (1 anchor): boxes within 1e-4 of
    their largest coordinate."""
    cfg = small_model(key)
    head_cfg = cfg['bbox_head' if key == 'r3det' else 'fam_head']
    head, jhead = HEADS.build(dict(head_cfg)), J_HEADS.build(dict(head_cfg))
    assert head.num_anchors == a_n
    cls_scores, bbox_preds = random_maps(np.random.default_rng(a_n), a_n, 2)
    got = head.filter_bboxes([torch.from_numpy(s).permute(0, 3, 1, 2)
                              for s in cls_scores],
                             [torch.from_numpy(d).permute(0, 3, 1, 2)
                              for d in bbox_preds])
    ref = jax.jit(jhead.filter_bboxes)([jnp.asarray(s) for s in cls_scores],
                                       [jnp.asarray(d) for d in bbox_preds])
    assert len(got) == len(ref) == len(SIZES)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert g.dtype == torch.float32 and g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=1e-4 * np.abs(r).max())


@pytest.mark.parametrize('key', ['r3det', 's2anet'])
def test_refine_bboxes_matches_jax(key):
    """The refine stage's deltas decoded against per-image anchors, in
    float32: within 1e-4 of the largest coordinate."""
    cfg = small_model(key)
    head_cfg = cfg['refine_heads'][0] if key == 'r3det' else cfg['odm_head']
    head, jhead = HEADS.build(dict(head_cfg)), J_HEADS.build(dict(head_cfg))
    rng = np.random.default_rng(7)
    _, bbox_preds = random_maps(rng, 1, 2)
    n = sum(h * w for h, w in SIZES)
    anchors = np.concatenate([rng.uniform(0, SIZE, (2, n, 2)),
                              rng.uniform(4, 60, (2, n, 2)),
                              rng.uniform(-1.5, 1.5, (2, n, 1))],
                             -1).astype(np.float32)
    got = head.refine_bboxes(
        (None, [torch.from_numpy(d).permute(0, 3, 1, 2)
                for d in bbox_preds]), torch.from_numpy(anchors))
    ref = np.asarray(jax.jit(jhead.refine_bboxes)(
        (None, [jnp.asarray(d) for d in bbox_preds]), jnp.asarray(anchors)))
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


# ---- the detectors -----------------------------------------------------
@pytest.mark.parametrize('key', ['s2anet', 'r3det'])
def test_forward_matches_jax(key):
    """Every map and roi within 1e-4 of its tensor's largest value."""
    run = det_run(key)
    detector = run.port()
    with torch.no_grad():
        out = detector(run.port_images())
    check_outputs(to_jax(out), run.j_out, key)


@pytest.mark.parametrize('key', ['s2anet', 'r3det'])
def test_second_stage_on_jax_rois_matches_jax(key):
    """The alignment and the refine head fed the JAX package's own rois:
    every map within 1e-5 of its tensor's largest value."""
    run = det_run(key)
    detector = run.port()
    ref = run.j_out
    with torch.no_grad():
        feats = detector.extract_feat(run.port_images())
        sizes = [tuple(f.shape[-2:]) for f in feats]
        if key == 's2anet':
            rois = [torch.tensor(ref['rois'])]
            aligned = detector.align_conv(feats, split_levels(rois[0],
                                                              sizes))
            got = [detector.odm_head(aligned)]
            want = [ref['odm_outputs']]
        else:
            rois = [torch.tensor(r) for r in ref['stage_rois']]
            got, want = [], ref['stage_outputs']
            for frm, head, r in zip(detector.feat_refine_module,
                                    detector.refine_head, rois):
                feats = frm(feats, split_levels(r, sizes))
                got.append(head(feats))
    for g, w in zip(to_jax(got), want):
        for name, r in output_leaves(w):
            np.testing.assert_allclose(dict(output_leaves(g))[name], r,
                                       rtol=0, atol=1e-5 * np.abs(r).max(),
                                       err_msg=name)


@pytest.mark.parametrize('key', ['s2anet', 'r3det'])
def test_loss_and_gradients_match_jax(key):
    """The losses at rtol 1e-4 (float32 sums), each positive; every
    parameter's gradient within 1e-3 of its tensor's largest."""
    run = det_run(key)
    detector = run.port()
    batch = run.port_batch()
    losses = detector.loss_from_outputs(detector(run.port_images()), batch)
    assert sorted(losses) == sorted(run.j_losses)
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), run.j_losses[k], rtol=1e-4,
                                   err_msg=k)
        assert run.j_losses[k] > 0, k
    sum(losses.values()).backward()
    grads = dict(leaves(to_jax_layout(
        {n: p.grad for n, p in detector.named_parameters()})['params']))
    ref = dict(leaves(run.j_grads))
    assert sorted(grads) == sorted(ref)
    for name, r in ref.items():
        assert np.abs(r).max() > 0, name
        np.testing.assert_allclose(grads[name], r, rtol=0,
                                   atol=1e-3 * np.abs(r).max(), err_msg=name)


@pytest.mark.parametrize('key', ['s2anet', 'r3det'])
def test_decode_matches_jax(key):
    """``bboxes_from_outputs`` of the JAX package's outputs: the same
    detection sets, boxes within 1e-3, scores within 1e-5."""
    run = det_run(key)
    detector = run.port()
    with torch.no_grad():
        got = detector.bboxes_from_outputs(to_port(run.j_out))
    assert got[0].shape == (2, 60, 6)
    assert same_detection_sets(got, run.j_dets) > 20


# ---- weights -------------------------------------------------------------
@pytest.mark.parametrize('key', ['s2anet', 'r3det', 'r3det_refine'])
def test_weights_round_trip(key):
    """JAX variables -> the port's state dict (loaded strictly: no key
    missing or left over) -> the flax layout gives back the same tree."""
    cfg = small_model(key)
    det = j_build(cfg)
    shapes = jax.eval_shape(det.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, SIZE, SIZE, 3)))
    variables = fill_variables(shapes, np.random.default_rng(1))
    state = from_jax_variables(variables)
    detector = build_detector(cfg)
    detector.load_state_dict(state)
    names = set(detector.state_dict())
    if key.startswith('s2anet'):
        assert {'odm_head.or_conv.weight', 'odm_head.or_conv.bias',
                'align_conv.ac.4.deform_conv.weight',
                'fam_head.retina_cls.weight', 'odm_head.odm_reg.bias'} \
            <= names
        assert detector.odm_head.or_conv.weight.shape == (4, 32, 1, 3, 3)
    else:
        stages = len(cfg['refine_heads'])
        assert {f'feat_refine_module.{stages - 1}.conv_5_1.weight',
                f'refine_head.{stages - 1}.retina_reg.bias'} <= names
    back = dict(leaves(to_jax_layout(detector.state_dict())))
    ref = dict(leaves(variables))
    assert sorted(back) == sorted(ref)
    for name, r in ref.items():
        np.testing.assert_array_equal(back[name], r, err_msg=name)


def test_deform_weight_meets_its_tap():
    """``align_conv.ac.{i}.deform_conv.weight[:, :, ky, kx]`` is the align
    projection's rows of tap ``ky * 3 + kx`` (``convert_deform_to_dense``)."""
    w = np.random.default_rng(0).normal(0, 1, (6, 4, 3, 3))
    dense = to_jax_layout({'align_conv.ac.0.deform_conv.weight': w})[
        'params']['align_conv']['align_proj_0']['kernel']
    assert dense.shape == (36, 6)
    for ky in range(3):
        for kx in range(3):
            t = ky * 3 + kx
            np.testing.assert_array_equal(dense[t * 4:(t + 1) * 4],
                                          w[:, :, ky, kx].T)


@pytest.mark.parametrize('key', list(CONFIGS))
def test_every_parameter_seeded_and_cast(key):
    """The published configs at full width: ``init_weights(seed)`` alone
    sets every parameter (two builds under different global seeds agree),
    and a bfloat16 bundle holds every parameter outside the frozen BN in
    bfloat16, ORConv's 5-D filter included."""
    cfg = Config.fromfile(CONFIGS[key])
    built = []
    for global_seed in (1, 2):
        torch.manual_seed(global_seed)
        detector = build_detector(dict(cfg.model))
        detector.init_weights(0)
        built.append(dict(detector.named_parameters()))
    for name, p in built[0].items():
        assert torch.isfinite(p).all(), name
        assert torch.equal(p, built[1][name]), f'{name} not seeded'
    torch.manual_seed(3)
    bundle = init_detector(cfg, device='cpu', dtype=torch.bfloat16)
    frozen = {f'{m}.{p}' for m, mod in bundle.detector.named_modules()
              if isinstance(mod, FrozenBatchNorm)
              for p, _ in mod.named_parameters()}
    for name, p in bundle.detector.named_parameters():
        want = torch.float32 if name in frozen else torch.bfloat16
        assert p.dtype == want, name
        assert torch.equal(p.float(), built[0][name].to(want).float()), name
    expect = 1 if key == 's2anet_hrsc' else 15
    assert bundle.num_classes == expect and not bundle.two_stage
