"""Port parity, prototype4 (``configs/jy/prototype4.py``) with its neck
replaced by the YOLOv6 Rep-PAFPN (``YOLOv6RepPAFPN``, 12 CSP blocks, as
``chip_smoke.py`` phase 50 builds it), cut to the size of
``tests/test_torch_live_bn.py``: backbone and neck at deepen 0.33 / widen
0.125 (4 RepVGG blocks a stage), 4 classes, at 128 px: the forward, the
decode, the losses and their gradients at the outputs, on weights carried
from the JAX package and gts whose assignment is decided
(``test_torch_yolov8.decided``), and one SGD step with frozen and with
live BatchNorm against the JAX package's jitted ``make_train_step``.

Tolerances, those of ``tests/test_torch_yolov8.py`` and
``tests/test_torch_yolov8_train.py``: outputs 1e-5 of each map's largest
magnitude; detections' labels and valid flags equal, scores and boxes
within 1e-3; loss terms at rtol 1e-4 (the whole detector's float32 sums,
as in the train steps); the gradients at the outputs within 1e-4 of the
largest gradient of that output; the frozen step as
``test_torch_live_bn.test_train_step_matches_jax`` holds it, the live
one the same way, each parameter's change also allowed twice JAX's own
move under a rounding-size change of the images (the form of
``tests/test_torch_reppoints.py``'s whole-detector rule; see
:func:`test_live_bn_step_matches_jax_within_its_own_spread`)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orientedobjectdetection_tpu.models import build_detector as j_build
from orientedobjectdetection_tpu.parallel import train_state as j_ts
from orientedobjectdetection_torch.models import build_detector
from orientedobjectdetection_torch.models.necks.pafpn import YOLOv6RepPAFPN
from orientedobjectdetection_torch.parallel import (build_lr_schedule,
                                                    build_optimizer,
                                                    create_train_state,
                                                    make_train_step)
from orientedobjectdetection_torch.utils import Config
from orientedobjectdetection_torch.utils.jax_weights import (
    from_jax_variables, to_jax_layout)
from test_torch_cspnext import assert_close
from test_torch_refine import leaves
from test_torch_live_bn import (CONFIG, LR, filled, small_model,
                                test_train_step_matches_jax)  # noqa: F401
from test_torch_yolov8 import decided, random_gts

torch.set_num_threads(1)

SIZE = 128
RANGES = ((-1, 48), (48, 96), (96, 192))
NUDGE = 3e-7     # a change of the images at float32 rounding size


def v6_model():
    """prototype4 cut as ``test_torch_live_bn.small_model`` cuts it, its
    neck the YOLOv6 Rep-PAFPN at the same cut."""
    m = small_model()
    m['neck'] = dict(type='YOLOv6RepPAFPN', in_channels=[256, 512, 768],
                     out_channels=[256, 512, 768], deepen_factor=0.33,
                     widen_factor=0.125, num_csp_blocks=12)
    m['bbox_head'] = dict(m['bbox_head'], regress_ranges=RANGES)
    return m


def nchw(images):
    return torch.from_numpy(images).permute(0, 3, 1, 2).contiguous()


@pytest.fixture(scope='module')
def case():
    cfg = v6_model()
    jdet = j_build(cfg)
    rng = np.random.default_rng(61)
    images = rng.normal(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    variables = filled(jdet, images, rng)
    jout = jax.jit(jdet.apply)(variables, jnp.asarray(images))
    det = build_detector(cfg)
    det.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        pout = det(nchw(images))
    for _ in range(50):
        gts = random_gts(rng, size=SIZE)
        if decided(det.bbox_head, pout, gts):
            break
    else:
        raise AssertionError('no decided draw of gts')
    return dict(jdet=jdet, det=det, variables=variables, jout=jout,
                pout=pout, gts=gts, images=images)


def test_the_neck_is_the_rep_pafpn(case):
    """The v6 neck with ``make_round(12, 0.33)`` = 4 RepVGG blocks a stage,
    192 / 384 / 576 at prototype4's width cut to 32 / 64 / 96, the reduce
    layers in both packages' trees."""
    neck = case['det'].neck
    assert isinstance(neck, YOLOv6RepPAFPN)
    assert neck.out_widths == [32, 64, 96]
    assert neck.top_down_0.num_blocks == 4
    jneck = case['variables']['params']['neck']
    assert sorted(k for k in jneck if k.startswith('reduce_')) == [
        'reduce_0', 'reduce_1']
    assert 'block_3' in jneck['bottom_up_1'] and \
        'block_4' not in jneck['bottom_up_1']


def test_forward_matches_jax(case):
    for name, ref, got in zip(('cls', 'box', 'angle'), case['jout'],
                              case['pout']):
        assert len(ref) == len(got) == 3
        for r, g in zip(ref, got):
            assert_close(np.transpose(np.asarray(r), (0, 3, 1, 2)), g, name)


def test_get_bboxes_matches_jax(case):
    jdet, det = case['jdet'], case['det']
    ref = jax.jit(lambda o: jdet.bboxes_from_outputs(o))(case['jout'])
    got = det.bboxes_from_outputs(case['pout'])
    dets, labels, valid = (np.asarray(v) for v in ref)
    assert valid.sum() > 10
    np.testing.assert_array_equal(got[2].numpy(), valid)
    np.testing.assert_array_equal(got[1].numpy(), labels)
    np.testing.assert_allclose(got[0].numpy(), dets, rtol=0, atol=1e-3)


def batch_of(case):
    gts, labels, mask = case['gts']
    return dict(gt_bboxes=gts, gt_labels=labels, gt_mask=mask)


def test_losses_match_jax(case):
    batch = batch_of(case)
    ref = jax.jit(lambda o: case['jdet'].loss_from_outputs(
        o, {k: jnp.asarray(v) for k, v in batch.items()}))(case['jout'])
    got = case['det'].loss_from_outputs(
        case['pout'], {k: torch.from_numpy(v) for k, v in batch.items()})
    assert sorted(ref) == sorted(got)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-4,
                                   err_msg=k)
        assert float(ref[k]) > 0, k


def test_loss_gradients_match_jax(case):
    batch = batch_of(case)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def total(o):
        return sum(case['jdet'].loss_from_outputs(o, jbatch).values())

    ref = jax.jit(jax.grad(total))(case['jout'])
    outs = tuple(tuple(m.clone().requires_grad_(True) for m in level)
                 for level in case['pout'])
    sum(case['det'].loss_from_outputs(outs, {
        k: torch.from_numpy(v) for k, v in batch.items()}).values()
        ).backward()
    for r_level, g_level in zip(ref, outs):
        largest = max(float(np.abs(np.asarray(r)).max()) for r in r_level)
        assert largest > 0
        for r, g in zip(r_level, g_level):
            r = np.transpose(np.asarray(r), (0, 3, 1, 2))
            np.testing.assert_allclose(g.grad.numpy(), r, rtol=0,
                                       atol=1e-4 * largest)


@functools.lru_cache(maxsize=None)
def run_step(norm_eval: bool) -> dict:
    """One SGD step of the cut v6-neck model in both packages with the
    config's optimizer (momentum, weight decay, clip, warmup) at
    ``test_torch_live_bn.LR``; the result in the form that
    ``test_train_step_matches_jax`` reads."""
    full = Config.fromfile(CONFIG)
    cfg = v6_model()
    det = j_build(cfg)
    rng = np.random.default_rng(62)
    images = rng.normal(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    variables = filled(det, images, rng)
    gts = random_gts(rng, valid=4, size=SIZE)
    batch = dict(images=images, gt_bboxes=gts[0], gt_labels=gts[1],
                 gt_mask=gts[2])
    opt = dict(full.optimizer)
    opt.pop('lr')
    grad_clip = dict(full.optimizer_config['grad_clip'])
    sched = j_ts.build_lr_schedule(dict(full.lr_config), LR, 10)
    tx = j_ts.build_optimizer(opt, sched, grad_clip=grad_clip,
                              params=variables['params'])
    start = j_ts.create_train_state(det, None, None, tx,
                                    variables=variables)
    step = jax.jit(j_ts.make_train_step(det, tx, norm_eval=norm_eval))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    state, j_metrics = step(start, jbatch)
    # JAX's own step on the images changed at rounding size
    nudged, _ = step(start, dict(jbatch, images=jbatch['images'] * (
        1 + NUDGE)))
    port_tx = build_optimizer(opt, build_lr_schedule(dict(full.lr_config),
                                                     LR, 10),
                              grad_clip=grad_clip)
    detector = build_detector(cfg)
    port_state = create_train_state(detector, port_tx, device='cpu',
                                    state_dict=from_jax_variables(variables))
    port_step = make_train_step(detector, port_tx, norm_eval=norm_eval)
    port_state, metrics = port_step(port_state, {
        k: torch.from_numpy(v) for k, v in batch.items()})
    return dict(norm_eval=norm_eval, variables=variables, state=state,
                decay=float(sched(0)) * opt['weight_decay'],
                j_metrics=j_metrics, detector=detector,
                port_state=port_state, metrics=metrics, nudged=nudged)


@pytest.fixture(scope='module')
def stepped():
    """The frozen-BN step, held by ``test_train_step_matches_jax``."""
    return run_step(True)


def test_live_bn_step_matches_jax_within_its_own_spread():
    """The live-BN step: loss terms at rtol 1e-4 and every running
    statistic within 1e-5 of JAX's (and moved); each parameter's change as
    ``test_torch_live_bn.check_param_changes`` holds it, or within twice
    the move of JAX's own step when the images change by a factor ``1 +
    NUDGE`` (rounding size), whichever is larger. Here the live step is
    that sensitive: that change moves 208 of JAX's 334 tensors beyond the
    plain tolerance (up to 17.9 times it), where the port's step differs
    beyond it in 36, by at most 1.17 times JAX's own move."""
    stepped = run_step(False)
    ref, got = stepped['j_metrics'], stepped['metrics']
    for k in ('loss_cls', 'loss_bbox', 'loss'):
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-4,
                                   err_msg=k)
    layout = to_jax_layout(stepped['detector'].state_dict())
    after = dict(leaves(layout['params']))
    params = dict(leaves(jax.tree_util.tree_map(np.asarray,
                                                stepped['state'].params)))
    nudged = dict(leaves(jax.tree_util.tree_map(np.asarray,
                                                stepped['nudged'].params)))
    before = dict(leaves(stepped['variables']['params']))
    assert sorted(after) == sorted(params) == sorted(before)
    for name, r in params.items():
        p = before[name]
        atol = max(2e-3 * np.abs(r - p).max()
                   + 2 * np.spacing(np.abs(p).max().astype(np.float32)),
                   2 * np.abs(nudged[name] - r).max())
        np.testing.assert_allclose(after[name], r, rtol=0, atol=atol,
                                   err_msg=name)
    stats = dict(leaves(layout['batch_stats']))
    ref_stats = dict(leaves(jax.tree_util.tree_map(
        np.asarray, stepped['state'].batch_stats)))
    start = dict(leaves(stepped['variables']['batch_stats']))
    assert sorted(stats) == sorted(ref_stats)
    for name, r in ref_stats.items():
        np.testing.assert_allclose(stats[name], r, rtol=0, atol=1e-5,
                                   err_msg=name)
        assert not np.array_equal(r, start[name]), name
