"""Port parity, the horizontal-proposal RPN (``RotatedRPNHead``) of Gliding
Vertex, Rotated Faster R-CNN and RoI Transformer: its forward, proposals,
targets and losses against the JAX package on the same inputs; and the
harness the three detectors' parity files share (:class:`Family`: a tiny
config at 128 px in both packages on the same random weights, the JAX
package's serving detections, its step-0 losses, outputs and gradients,
and its parameters after one ``make_train_step``).

The port cannot reproduce ``jax.random``'s bits, so the sampling tests
replace the port's one source of uniform numbers (``core.assigners
.uniform``) with one that returns the JAX package's draws for the same keys
(``jax_draws``).

Tolerances: network outputs rtol 1e-4 of each map's largest value (same
weights, other convolution algorithms); proposals 1e-4 and scores 1e-6;
targets 1e-5; losses rtol 1e-5.
"""

import functools
import os.path as osp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orientedobjectdetection_tpu.apis.inference import \
    DetectorBundle as JBundle
from orientedobjectdetection_tpu.core import assigners as j_assigners
from orientedobjectdetection_tpu.models import build_detector as j_build
from orientedobjectdetection_tpu.ops import boxes as j_boxes
from orientedobjectdetection_tpu.parallel import train_state as j_ts
from orientedobjectdetection_tpu.utils.config import Config as JConfig
from orientedobjectdetection_tpu.utils.registry import HEADS as JHEADS
from orientedobjectdetection_torch.apis import init_detector
from orientedobjectdetection_torch.core import assigners
from orientedobjectdetection_torch.core.assigners import SampleKey, \
    rng_from_gt
from orientedobjectdetection_torch.models import build_detector
from orientedobjectdetection_torch.parallel import (build_optimizer,
                                                    create_train_state,
                                                    frozen_mask,
                                                    make_train_step)
from orientedobjectdetection_torch.utils import Config
from orientedobjectdetection_torch.utils.jax_weights import (
    from_jax_variables, to_jax_layout)
from test_torch_two_stage_train import (jax_keys, jax_uniform, leaves,
                                        make_batch, to_torch)

torch.set_num_threads(1)

CONFIGS = osp.join(osp.dirname(__file__), '..', 'configs')
GV_TINY = osp.join(CONFIGS, 'gliding_vertex', 'gliding_vertex_tiny_synth.py')
FASTER = osp.join(CONFIGS, 'rotated_faster_rcnn',
                  'rotated_faster_rcnn_r50_fpn_1x_dota_le90.py')
SIZE = 128
OPT_CONFIG = dict(type='sgd', momentum=0.9, weight_decay=1e-2)
BASE_LR = 0.02
CLIP = dict(max_norm=0.5)       # below the gradient norm: the clip is active
FROZEN = 1                      # the stem and layer1
# the regression outputs scaled down, as a trained detector's are
SMALL_OUTPUTS = ('rpn_reg', 'fc_reg', 'fc_fix', 'fc_ratio')


@pytest.fixture
def jax_draws(monkeypatch):
    monkeypatch.setattr(assigners, 'uniform', jax_uniform)


def j_rng(step):
    return jax.random.fold_in(jax.random.PRNGKey(0), step)


def perturb_variables(variables, seed):
    """Random numpy values in the flax tree's shapes, the regression
    outputs scaled by 0.05."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == 'kernel':
            v = rng.normal(0, 1 / np.sqrt(int(np.prod(shape[:-1]))), shape)
            if path[-2].key in SMALL_OUTPUTS:
                v = v * 0.05
        elif name == 'scale':
            v = rng.uniform(0.5, 1.5, shape)
        elif name == 'var':
            v = rng.uniform(0.5, 2.0, shape)
        else:                               # bias, mean
            v = rng.normal(0, 0.1, shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, variables)


def nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2).contiguous()


def random_levels(seed, channels=64, count=5):
    """Random NHWC pyramid levels of a SIZE px image, strides 4 up."""
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (2, SIZE // s, SIZE // s, channels)
                       ).astype(np.float32)
            for s in (4, 8, 16, 32, 64)[:count]]


def rpn_anchors():
    """The RPN's anchors of a SIZE px image as the assigner compares them
    (theta-0 rotated boxes)."""
    head = build_detector(dict(Config.fromfile(GV_TINY).model)).rpn_head
    sizes = [(-(-SIZE // s), -(-SIZE // s)) for s in (4, 8, 16, 32, 64)]
    return head.train_anchors(sizes, 'cpu')[1]


def well_posed_batch(seed, margin=1e-4, thresholds=(0.3, 0.7)):
    """:func:`make_batch` with each image's gts drawn again until the RPN's
    assignment is decided by more than ``margin``: each gt's best anchor
    leads the next, and no anchor's best IoU lies that close to a
    threshold. Horizontal anchors inside a gt's circumscribed box, or
    crossed by it, tie in exact arithmetic; there float32 rounding decides
    the low-quality match, and two jitted programs of the JAX package
    decide it differently (ROADMAP C)."""
    from orientedobjectdetection_torch.ops import box_iou_rotated
    from orientedobjectdetection_torch.ops.boxes import obb2hbb
    anchors = rpn_anchors()
    batch = make_batch(seed)
    rng = np.random.default_rng(seed)
    for b in range(batch['gt_bboxes'].shape[0]):
        for _ in range(1000):
            gts = torch.from_numpy(batch['gt_bboxes'][b][batch['gt_mask'][b]])
            iou = box_iou_rotated(obb2hbb(gts, 'le90'), anchors)
            top2 = iou.topk(2, dim=1)[0]
            best = iou.amax(0)
            if (top2[:, 0] - top2[:, 1] > margin).all() and all(
                    (best - t).abs().min() > margin for t in thresholds):
                break
            batch['gt_bboxes'][b] = make_batch(
                int(rng.integers(1 << 30)))['gt_bboxes'][0]
        else:
            raise AssertionError('no well-posed gts')
    return batch


class Family:
    """One detector config in both packages on the same random weights,
    with the JAX package's step-0 losses, outputs and gradients on :func:`well_posed_batch`'s batch
    (jitted, with the key ``fold_in(PRNGKey(0), 0)``), and its parameters
    after one step of ``make_train_step``. ``model`` overrides
    ``cfg.model`` (a narrowed published config). The stem and layer1 are
    frozen (``frozen_stages=1``, the published configs' setting), as in
    ``tests/test_torch_two_stage_train.py``. ``opt_config``: the optimizer
    of both steps (SGD with momentum and weight decay by default)."""

    def __init__(self, path, seed, model=None, opt_config=OPT_CONFIG):
        self.opt_config = opt_config
        self.jcfg = JConfig.fromfile(path)
        self.cfg = Config.fromfile(path)
        for cfg in (self.jcfg, self.cfg):
            if model is not None:
                cfg.model = model
            cfg.model['backbone']['frozen_stages'] = FROZEN
        det = self.jdet = j_build(dict(self.jcfg.model))
        shapes = jax.eval_shape(det.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, SIZE, SIZE, 3), jnp.float32))
        self.variables = perturb_variables(shapes, seed)
        self.state = from_jax_variables(self.variables)
        self.images = np.random.default_rng(seed + 1).normal(
            0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
        self.batch = well_posed_batch(seed + 2)

    @functools.cached_property
    def _jax_step(self):
        """The JAX package's step-0 losses, outputs and gradients, and its
        metrics and parameters after one ``make_train_step``: compiled at
        the first check that reads them (a file that only carries weights
        or serves compiles neither program)."""
        det = self.jdet
        batch = {k: jnp.asarray(v) for k, v in self.batch.items()}
        params = self.variables['params']
        # a transformer backbone has no BatchNorm statistics
        stats = self.variables.get('batch_stats', {})

        def loss_fn(p):
            out = det.apply({'params': p, 'batch_stats': stats},
                            batch['images'], batch=batch, train=True,
                            rng=j_rng(0))
            losses = det.loss_from_outputs(out, batch)
            return sum(losses.values()), (losses, out)

        (_, (losses, outputs)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(params)
        tx = j_ts.build_optimizer(self.opt_config, BASE_LR, grad_clip=CLIP,
                                  params=params, frozen_stages=FROZEN)
        state = j_ts.create_train_state(det, None, None, tx,
                                        variables=self.variables)
        state, metrics = jax.jit(j_ts.make_train_step(det, tx))(state, batch)
        return dict(j_losses=losses, j_outputs=outputs, j_grads=grads,
                    j_metrics={k: float(v) for k, v in metrics.items()},
                    j_params_after=state.params)

    j_losses = property(lambda self: self._jax_step['j_losses'])
    j_outputs = property(lambda self: self._jax_step['j_outputs'])
    j_grads = property(lambda self: self._jax_step['j_grads'])
    j_metrics = property(lambda self: self._jax_step['j_metrics'])
    j_params_after = property(lambda self: self._jax_step['j_params_after'])

    def detector(self):
        det = build_detector(dict(self.cfg.model))
        det.load_state_dict(self.state, strict=True)
        return det

    def port_state(self):
        """The detector on the carried weights with its optimizer (the
        frozen stages take no gradient) and its train state."""
        detector = build_detector(dict(self.cfg.model))
        tx = build_optimizer(self.opt_config, BASE_LR, grad_clip=CLIP,
                             frozen_stages=FROZEN)
        state = create_train_state(detector, tx, device='cpu',
                                   state_dict=self.state)
        return detector, tx, state

    def jax_head(self, name, stage):
        cfg = dict(self.jcfg.model[name])
        cfg['train_cfg'] = self.jcfg.model['train_cfg'][stage]
        cfg['test_cfg'] = self.jcfg.model['test_cfg'].get(stage)
        return JHEADS.build(cfg)

    # ---- the checks each family runs ---------------------------------
    def check_weights(self):
        """The carried state loads strictly and goes back unchanged."""
        detector = self.detector()
        assert set(self.state) == set(detector.state_dict())
        back = dict(leaves(to_jax_layout(detector.state_dict(),
                                         self.variables)))
        ref = dict(leaves(self.variables))
        assert sorted(back) == sorted(ref)
        for name, v in ref.items():
            np.testing.assert_array_equal(back[name], v, err_msg=name)

    def check_serving(self, num_classes=2, min_dets=5):
        """The bundle's detections on seeded images equal the JAX
        bundle's: valid flags and labels exactly, boxes and scores within
        1e-3 (float32 network, then decode and NMS on the same
        candidates)."""
        bundle = init_detector(self.cfg, self.state, device='cpu')
        assert bundle.two_stage and bundle.num_classes == num_classes
        outputs = bundle.forward(torch.from_numpy(self.images))
        dets, labels, valid = bundle.decode(outputs)
        r_dets, r_labels, r_valid = [np.asarray(x) for x in JBundle(
            self.jcfg, self.jdet, self.variables)(jnp.asarray(self.images))]
        assert r_valid.sum(1).min() >= min_dets
        np.testing.assert_array_equal(valid.numpy(), r_valid)
        np.testing.assert_array_equal(labels.numpy(), r_labels)
        np.testing.assert_allclose(dets.numpy(), r_dets, atol=1e-3)
        return outputs

    def check_step0(self, names):
        """Step 0 on the carried weights (the JAX draws swapped in): every
        loss term at rtol 1e-4 and every trainable tensor's gradient within
        1e-3 of its largest value. Returns the port's forward outputs."""
        detector = self.port_state()[0]
        batch = to_torch(self.batch)
        outputs = detector(batch['images'].permute(0, 3, 1, 2), batch=batch,
                           train=True, rng=SampleKey(step=0))
        losses = detector.loss_from_outputs(outputs, batch)
        assert sorted(losses) == sorted(names)
        for k, v in losses.items():
            np.testing.assert_allclose(float(v.detach()),
                                       float(self.j_losses[k]), rtol=1e-4,
                                       err_msg=k)
        sum(losses.values()).backward()
        got = dict(leaves(to_jax_layout(
            {n: p.grad for n, p in detector.named_parameters()
             if p.grad is not None}, self.variables)['params']))
        ref = dict(leaves(self.j_grads))
        assert len(got) == sum(frozen_mask(detector, FROZEN).values())
        for name, g in got.items():
            np.testing.assert_allclose(g, ref[name], rtol=0,
                                       atol=1e-3 * np.abs(ref[name]).max(),
                                       err_msg=name)
        return outputs

    def check_train_step(self):
        """One step of ``make_train_step`` (SGD, momentum, weight decay,
        an active clip, the default rng): the metrics at rtol 1e-4, every
        parameter after it within 1e-5."""
        detector, tx, state = self.port_state()
        state, metrics = make_train_step(detector, tx)(
            state, to_torch(self.batch))
        for k, v in metrics.items():
            if k != 'grad_norm':
                np.testing.assert_allclose(float(v), self.j_metrics[k],
                                           rtol=1e-4, err_msg=k)
        assert float(metrics['grad_norm']) > CLIP['max_norm']
        after = dict(leaves(to_jax_layout(detector.state_dict(),
                                          self.variables)['params']))
        ref = dict(leaves(self.j_params_after))
        assert sorted(after) == sorted(ref)
        for name, v in after.items():
            np.testing.assert_allclose(v, ref[name], rtol=0, atol=1e-5,
                                       err_msg=name)


# ---- the RPN ----------------------------------------------------------------
@pytest.fixture(scope='module')
def heads():
    """The tiny Gliding Vertex config's RPN head in both packages on the
    same random weights."""
    jcfg = JConfig.fromfile(GV_TINY)
    cfg = Config.fromfile(GV_TINY)
    jhead = JHEADS.build(dict(jcfg.model['rpn_head'],
                              train_cfg=jcfg.model['train_cfg']['rpn'],
                              test_cfg=jcfg.model['test_cfg']['rpn']))
    feats = random_levels(50)
    shapes = jax.eval_shape(jhead.init, jax.random.PRNGKey(0),
                            tuple(jnp.asarray(f) for f in feats))
    variables = perturb_variables(shapes, 51)
    state = {k.split('.', 1)[1]: v for k, v in from_jax_variables(
        {'params': {'rpn_head': variables['params']}}).items()}
    head = build_detector(dict(cfg.model)).rpn_head
    head.load_state_dict(state, strict=True)
    return jhead, variables, head, cfg, feats


def test_rpn_forward_and_proposals_match_jax(heads):
    jhead, variables, head, cfg, feats = heads
    j_out = jax.jit(jhead.apply)(variables,
                                 tuple(jnp.asarray(f) for f in feats))
    with torch.no_grad():
        t_out = head([nchw(f) for f in feats])
    assert t_out[1][0].shape[1] == 3 * 4          # A * 4 deltas
    for got, ref in zip(t_out[0] + t_out[1], j_out[0] + j_out[1]):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref,
                                   rtol=1e-4, atol=1e-4 * np.abs(ref).max())
    # proposals from the SAME maps (the JAX head's)
    test_cfg = jhead.test_cfg
    r_boxes, r_scores, r_valid = jax.jit(
        lambda o: jhead.get_proposals(o, cfg=test_cfg))(j_out)
    same = (tuple(nchw(s) for s in j_out[0]),
            tuple(nchw(p) for p in j_out[1]))
    with torch.no_grad():
        boxes, scores, valid = head.get_proposals(
            same, cfg=cfg.model['test_cfg']['rpn'])
    r_valid = np.asarray(r_valid)
    assert boxes.shape == (2, 256, 4) and valid.dtype == torch.bool
    assert 50 < r_valid.sum(1).min()
    np.testing.assert_array_equal(valid.numpy(), r_valid)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(r_boxes), atol=1e-4)
    np.testing.assert_allclose(scores.numpy(), np.asarray(r_scores),
                               atol=1e-6)
    assert (boxes[~valid] == 0).all()
    assert (boxes[..., 2] >= boxes[..., 0]).all()


def test_rpn_loss_and_targets_match_jax(heads, jax_draws):
    """Random RPN outputs and seeded gts: both losses, and the sampled
    anchors and 4-parameter targets of the JAX package's own pieces."""
    jhead, _, head, _, _ = heads
    rng = np.random.default_rng(52)
    sizes = [SIZE // s for s in (4, 8, 16, 32, 64)]
    cls = [rng.normal(0, 2, (2, s, s, 3)).astype(np.float32) for s in sizes]
    reg = [rng.normal(0, 0.5, (2, s, s, 12)).astype(np.float32)
           for s in sizes]
    batch = make_batch(53)
    j_batch = [jnp.asarray(batch[k]) for k in ('gt_bboxes', 'gt_labels',
                                               'gt_mask')]
    j_xyxy = jhead._flat_anchors_xyxy([(s, s) for s in sizes])
    j_rot = j_boxes.hbb2obb(j_xyxy, 'le90')

    def j_targets(gb, gm, key):
        assign = jhead.assigner(j_rot, j_boxes.obb2hbb(gb, 'le90'),
                                jnp.zeros(gm.shape, jnp.int32), gm)
        pos, neg = j_assigners.random_sample_masks(
            assign.assigned_gt_inds >= 0, assign.assigned_gt_inds == -1,
            256, 0.5, key)
        deltas = jhead.coder.encode(j_xyxy, j_boxes.obb2xyxy(
            gb[jnp.clip(assign.assigned_gt_inds, 0, None)], 'le90'))
        return pos, pos | neg, jnp.where(pos[:, None], deltas, 0.0)

    tb = to_torch(batch)
    ref, (pos, sampled, deltas) = jax.jit(
        lambda outputs, keys: (jhead.loss(outputs, *j_batch),
                               jax.vmap(j_targets)(j_batch[0], j_batch[2],
                                                   keys)))(
        (tuple(map(jnp.asarray, cls)), tuple(map(jnp.asarray, reg))),
        jnp.stack(jax_keys(rng_from_gt(tb['gt_bboxes']))))
    nchw_maps = [torch.from_numpy(x).permute(0, 3, 1, 2) for x in cls + reg]
    got = head.loss((tuple(nchw_maps[:5]), tuple(nchw_maps[5:])),
                    tb['gt_bboxes'], tb['gt_labels'], tb['gt_mask'])
    for k in ('loss_rpn_cls', 'loss_rpn_bbox'):
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5)
    xyxy, rot = head.train_anchors([(s, s) for s in sizes], 'cpu')
    fg, lw, bt, bw = head.targets(xyxy, rot, tb['gt_bboxes'], tb['gt_mask'])
    np.testing.assert_array_equal(fg.numpy(), np.asarray(pos))
    np.testing.assert_array_equal(lw.numpy(), np.asarray(sampled))
    np.testing.assert_allclose(bt.numpy(), np.asarray(deltas), rtol=1e-5,
                               atol=1e-5)
    assert bt.shape[-1] == 4 and 0 < fg.sum() < 256


def test_rpn_forces_its_generator_and_coder():
    """The Faster R-CNN config names mmdet's ``AnchorGenerator``; the head
    builds a ``RotatedAnchorGenerator`` and a ``DeltaXYWHBBoxCoder`` with
    the config's stds, dropping an ``angle_range``, as the JAX head."""
    from orientedobjectdetection_torch.core import (DeltaXYWHBBoxCoder,
                                                    RotatedAnchorGenerator)
    cfg = Config.fromfile(FASTER)
    rpn = dict(cfg.model['rpn_head'])
    assert rpn['anchor_generator']['type'] == 'AnchorGenerator'
    rpn['bbox_coder'] = dict(rpn['bbox_coder'], angle_range='le90',
                             target_stds=[1.0, 1.0, 2.0, 2.0])
    head = build_detector(dict(cfg.model, rpn_head=rpn)).rpn_head
    assert isinstance(head.prior_generator, RotatedAnchorGenerator)
    assert isinstance(head.coder, DeltaXYWHBBoxCoder)
    assert head.coder.stds == (1.0, 1.0, 2.0, 2.0)
    assert head.rpn_reg.out_channels == 12 and head.default_nms_thr == 0.7
