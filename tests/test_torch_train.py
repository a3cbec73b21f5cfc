"""Port parity, the training slice: head loss, detector loss and gradients,
two optimizer steps, the LR schedule, the frozen mask, the weight mapping
back to the flax layout, and checkpoints, against the JAX package on
carried weights and numpy-seeded batches.

Small sizes: ResNet-18 and a narrow ResNet-50, 32-wide FPN and head, one
stacked conv, 4 classes, 128 px, G = 8 padded gts with 3 valid. Tolerances
are stated at each comparison. The JAX train step is jitted once per model
(module-scoped fixtures)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _retina_cfg
from orientedobjectdetection_tpu.models import build_detector as j_build
from orientedobjectdetection_tpu.parallel import train_state as j_ts
from orientedobjectdetection_tpu.utils.registry import HEADS as J_HEADS
from orientedobjectdetection_torch.models import build_detector
from orientedobjectdetection_torch.parallel import (build_lr_schedule,
                                                    build_optimizer,
                                                    create_train_state,
                                                    frozen_mask,
                                                    make_train_step)
from orientedobjectdetection_torch.utils.checkpoint import (
    find_checkpoints, find_latest_checkpoint, load_checkpoint,
    save_checkpoint)
from orientedobjectdetection_torch.utils.jax_weights import (
    from_jax_variables, to_jax_layout)
from orientedobjectdetection_torch.utils.registry import HEADS

torch.set_num_threads(1)

SIZE = 128
LR_CONFIG = dict(policy='step', step=[8, 11], warmup='linear',
                 warmup_iters=5, warmup_ratio=1.0 / 3)
OPT_CONFIG = dict(type='sgd', momentum=0.9, weight_decay=1e-2)
MAX_NORM = 0.05          # far below the gradient norm: the clip is active
BASE_LR = 0.05


def model_cfg(depth):
    return _retina_cfg(num_classes=4, depth=depth, channels=32, stacked=1)


def random_variables(det, seed):
    """numpy values in the flax tree's shapes (no JAX init compile): every
    kernel, BN term and bias carries information."""
    shapes = jax.eval_shape(det.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, SIZE, SIZE, 3), jnp.float32))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == 'kernel':
            v = rng.normal(0, 1 / np.sqrt(np.prod(leaf.shape[:-1])),
                           leaf.shape)
        elif name == 'scale' and path[-2].key == 'bn3':
            # a bottleneck's last BN: a small residual branch keeps the 16
            # blocks of the random ResNet-50 well conditioned
            v = rng.uniform(0.1, 0.3, leaf.shape)
        elif name in ('scale', 'var'):
            v = rng.uniform(0.5, 1.5, leaf.shape)
        else:                               # bias, mean
            v = rng.normal(0, 0.1, leaf.shape)
        return np.asarray(v, np.float32)

    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    # the focal prior, so the class loss starts where training starts
    variables['params']['bbox_head']['cls_out']['bias'][...] = -4.595
    return variables


def make_batch(seed, bsz=2, g=8, valid=3):
    """Images, and gts copied from anchors and perturbed so that each has
    positives; 3 valid of 8, zero boxes after."""
    from orientedobjectdetection_torch.core import RotatedAnchorGenerator
    rng = np.random.default_rng(seed)
    strides = [8, 16, 32, 64, 128]
    anchors = torch.cat(RotatedAnchorGenerator(
        octave_base_scale=4, scales_per_octave=3, ratios=[1.0, 0.5, 2.0],
        strides=strides).grid_priors(
            [(-(-SIZE // s), -(-SIZE // s)) for s in strides]), 0).numpy()
    inside = anchors[(anchors[:, 2:4].max(1) < 80)]
    gts = np.zeros((bsz, g, 5), np.float32)
    for b in range(bsz):
        pick = inside[rng.choice(len(inside), valid, replace=False)]
        gts[b, :valid] = pick
        gts[b, :valid, :2] += rng.uniform(-3, 3, (valid, 2))
        gts[b, :valid, 2:4] *= rng.uniform(0.8, 1.25, (valid, 2))
        gts[b, :valid, 4] = rng.uniform(-0.3, 0.3, valid)
    return dict(
        images=rng.normal(0, 1, (bsz, SIZE, SIZE, 3)).astype(np.float32),
        gt_bboxes=gts,
        gt_labels=rng.integers(0, 4, (bsz, g)).astype(np.int32),
        gt_mask=np.arange(g)[None, :].repeat(bsz, 0) < valid)


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, path + (k,))
        else:
            yield '/'.join(path + (k,)), np.asarray(v)


class Run:
    """Both packages on one model: JAX losses, gradients and the state
    after two jitted steps; the port's detector on the same weights."""

    def __init__(self, depth, seed):
        cfg = model_cfg(depth)
        self.cfg = cfg
        det = j_build(cfg)
        self.variables = random_variables(det, seed)
        self.batch = make_batch(seed + 1)
        batch = {k: jnp.asarray(v) for k, v in self.batch.items()}
        params = self.variables['params']
        stats = self.variables['batch_stats']

        def loss_fn(p):
            out = det.apply({'params': p, 'batch_stats': stats},
                            batch['images'])
            losses = det.loss_from_outputs(out, batch)
            return sum(losses.values()), losses

        (_, self.j_losses), self.j_grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(params)

        sched = j_ts.build_lr_schedule(LR_CONFIG, BASE_LR, 10)
        tx = j_ts.build_optimizer(OPT_CONFIG, sched,
                                  grad_clip=dict(max_norm=MAX_NORM),
                                  params=params, frozen_stages=1)
        state = j_ts.create_train_state(det, None, None, tx,
                                        variables=self.variables)
        step = jax.jit(j_ts.make_train_step(det, tx))
        self.j_metrics = []
        for _ in range(2):
            state, metrics = step(state, batch)
            self.j_metrics.append({k: float(v) for k, v in metrics.items()})
        self.j_params_after = state.params

    def port_state(self):
        tx = build_optimizer(
            OPT_CONFIG, build_lr_schedule(LR_CONFIG, BASE_LR, 10),
            grad_clip=dict(max_norm=MAX_NORM), frozen_stages=1)
        detector = build_detector(self.cfg)
        state = create_train_state(
            detector, tx, device='cpu',
            state_dict=from_jax_variables(self.variables))
        return detector, tx, state


@pytest.fixture(scope='module')
def r18():
    return Run(18, seed=11)


@pytest.fixture(scope='module')
def r50():
    return Run(50, seed=21)


def trainable_norm(run):
    """sqrt(sum g^2) of the JAX gradients over the parameters the port
    trains (everything but the stem and layer1)."""
    total = 0.0
    for name, g in leaves(run.j_grads):
        if not name.startswith(('backbone/conv1/', 'backbone/bn1/',
                                'backbone/layer1_')):
            total += float((g.astype(np.float64) ** 2).sum())
    return np.sqrt(total)


@pytest.mark.parametrize('model', ['r18', 'r50'])
def test_loss_and_gradients_match_jax(model, request):
    run = request.getfixturevalue(model)
    detector, _, state = run.port_state()
    batch = to_torch(run.batch)
    outputs = detector(batch['images'].permute(0, 3, 1, 2))
    losses = detector.loss_from_outputs(outputs, batch)
    for k in ('loss_cls', 'loss_bbox'):          # rtol 1e-4: float32 sums
        np.testing.assert_allclose(losses[k].item(), float(run.j_losses[k]),
                                   rtol=1e-4)
    assert float(run.j_losses['loss_bbox']) > 0  # the batch has positives
    sum(losses.values()).backward()
    grads = to_jax_layout({n: p.grad for n, p in
                           detector.named_parameters()
                           if p.grad is not None})['params']
    got = dict(leaves(grads))
    ref = dict(leaves(run.j_grads))
    mask = frozen_mask(detector, 1)
    assert len(got) == sum(mask.values())        # frozen ones have no grad
    for name, g in got.items():                  # 1e-3 of each tensor's max
        np.testing.assert_allclose(g, ref[name], rtol=0,
                                   atol=1e-3 * np.abs(ref[name]).max(),
                                   err_msg=name)
    assert not any(n.startswith(('backbone/conv1/', 'backbone/bn1/',
                                 'backbone/layer1_')) for n in got)


@pytest.mark.parametrize('model', ['r18', 'r50'])
def test_two_train_steps_match_jax(model, request):
    """Warmup LR, weight decay on every trainable tensor, an active clip,
    momentum, frozen stem and layer1."""
    run = request.getfixturevalue(model)
    detector, tx, state = run.port_state()
    before = {n: p.detach().clone() for n, p in detector.named_parameters()}
    step = make_train_step(detector, tx)
    metrics = []
    for _ in range(2):
        state, m = step(state, to_torch(run.batch))
        assert all(isinstance(v, torch.Tensor) and v.dim() == 0
                   for v in m.values())
        metrics.append({k: float(v) for k, v in m.items()})
    assert state.step == 2
    for got, ref in zip(metrics, run.j_metrics):
        for k in ('loss_cls', 'loss_bbox', 'loss'):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-4)
    # grad_norm is the trainable parameters' (what the clip sees); the JAX
    # package logs the norm over all parameters, frozen ones included
    np.testing.assert_allclose(metrics[0]['grad_norm'], trainable_norm(run),
                               rtol=1e-3)
    assert metrics[0]['grad_norm'] > 10 * MAX_NORM
    assert metrics[0]['grad_norm'] <= run.j_metrics[0]['grad_norm'] * 1.001

    mask = frozen_mask(detector, 1)
    after = dict(leaves(to_jax_layout(detector.state_dict())['params']))
    start = dict(leaves(run.variables['params']))
    ref = dict(leaves(run.j_params_after))
    assert sorted(after) == sorted(ref)
    moved = 0
    for name, p in detector.named_parameters():
        if not mask[name]:                       # frozen: bit-identical
            assert torch.equal(p, before[name]), name
    for name, v in after.items():
        np.testing.assert_allclose(v, ref[name], rtol=0, atol=1e-5,
                                   err_msg=name)
        moved += int(not np.array_equal(v, start[name]))
    assert moved == sum(mask.values())           # every trainable one moved
    # the statistics are buffers and never change
    stats = dict(leaves(to_jax_layout(detector.state_dict())['batch_stats']))
    for name, v in leaves(run.variables['batch_stats']):
        np.testing.assert_array_equal(stats[name], v)


def test_adamw_step_matches_optax():
    """AdamW with decoupled weight decay, no clip: one parameter tensor and
    a fixed gradient through both update rules."""
    import optax
    rng = np.random.default_rng(0)
    w = rng.normal(0, 1, (7, 5)).astype(np.float32)
    grads = [rng.normal(0, 1, (7, 5)).astype(np.float32) for _ in range(3)]
    cfg = dict(type='AdamW', lr=1e-2, weight_decay=0.05, betas=(0.8, 0.99))
    j_tx = j_ts.build_optimizer(cfg, 1e-2)
    j_p, j_state = jnp.asarray(w), j_tx.init(jnp.asarray(w))
    model = torch.nn.Linear(5, 7, bias=False)
    with torch.no_grad():
        model.weight.copy_(torch.from_numpy(w))
    tx = build_optimizer(cfg, 1e-2)
    from orientedobjectdetection_torch.parallel import TrainState
    state = TrainState(0, model, tx.init(model))
    for g in grads:
        upd, j_state = j_tx.update(jnp.asarray(g), j_state, j_p)
        j_p = optax.apply_updates(j_p, upd)
        model.weight.grad = torch.from_numpy(g.copy())
        tx.update(state)
        state.step += 1
    np.testing.assert_allclose(model.weight.detach().numpy(),
                               np.asarray(j_p), atol=1e-6)


@pytest.mark.parametrize('lr_config', [
    dict(policy='step', step=[1, 2], gamma=0.1, warmup='linear',
         warmup_iters=4, warmup_ratio=0.25),
    dict(policy='step', step=[1]),
    dict(policy='CosineAnnealing', warmup='linear', warmup_iters=3,
         warmup_ratio=0.1, min_lr_ratio=0.05),
    dict(policy='cosine', max_steps=15),
], ids=['step-warmup', 'step', 'cosine-warmup', 'cosine-max-steps'])
def test_lr_schedule_matches_jax(lr_config):
    """20 steps, 6 per epoch: equal to float32 rounding. The JAX schedule
    computes in float32, the port in Python floats: rtol 1e-6, plus 1e-7 of
    the base LR for the end of the cosine, where ``1 + cos`` cancels."""
    ref = j_ts.build_lr_schedule(lr_config, 0.02, 6, total_steps=18)
    got = build_lr_schedule(lr_config, 0.02, 6, total_steps=18)
    for step in range(20):
        assert isinstance(got(step), float)
        np.testing.assert_allclose(got(step), float(ref(jnp.asarray(step))),
                                   rtol=1e-6, atol=1e-7 * 0.02,
                                   err_msg=f'step {step}')
    with pytest.raises(ValueError):
        build_lr_schedule(dict(policy='poly'), 0.02, 6)


@pytest.mark.parametrize('depth', [18, 50])
def test_frozen_mask_names(depth):
    detector = build_detector(model_cfg(depth))
    names = [n for n, _ in detector.named_parameters()]
    assert all(frozen_mask(detector, -1).values())
    stem = frozen_mask(detector, 0)
    assert sorted(n for n in names if not stem[n]) == [
        'backbone.bn1.bias', 'backbone.bn1.weight', 'backbone.conv1.weight']
    one = frozen_mask(detector, 1)
    for n in names:
        frozen = n.startswith(('backbone.conv1.', 'backbone.bn1.',
                               'backbone.layer1.'))
        assert one[n] == (not frozen), n
    # no neck or head name is caught, nor a block's own conv1 / bn1
    assert all(one[n] for n in names if not n.startswith('backbone.'))
    assert one['backbone.layer2.0.conv1.weight']
    assert one['backbone.layer2.0.bn1.weight']
    # the same partition as the JAX package's mask over the flax tree
    det = j_build(model_cfg(depth))
    shapes = jax.eval_shape(det.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))
    j_mask = dict(leaves(j_ts.frozen_mask(shapes['params'], 1)))
    ours = dict(leaves(to_jax_layout(
        {n: torch.full_like(p, float(one[n]))
         for n, p in detector.named_parameters()})['params']))
    assert sorted(ours) == sorted(j_mask)
    for n, v in ours.items():
        assert bool(v.flat[0]) == bool(j_mask[n]), n


@pytest.mark.parametrize('depth', [18, 50])
def test_weight_mapping_round_trips(depth):
    det = j_build(model_cfg(depth))
    variables = random_variables(det, depth)
    back = to_jax_layout(from_jax_variables(variables))
    ref = dict(leaves(variables))
    got = dict(leaves(back))
    assert sorted(got) == sorted(ref)            # no leftover key
    for name, v in ref.items():
        np.testing.assert_array_equal(got[name], v, err_msg=name)
    again = from_jax_variables(back)
    state = from_jax_variables(variables)
    assert sorted(again) == sorted(state)
    assert all(torch.equal(again[k], state[k]) for k in state)


def head_cfg(**kw):
    cfg = dict(model_cfg(18)['bbox_head'],
               train_cfg=dict(model_cfg(18)['train_cfg']))
    cfg.update(kw)
    return cfg


@pytest.mark.parametrize('kw,with_ignore', [
    (dict(), False),
    (dict(loss_bbox=dict(type='SmoothL1Loss', beta=0.11, loss_weight=1.0),
          reg_decoded_bbox=True), False),
    (dict(assign_by_circumhbbox='le90'), False),
    (dict(train_cfg=dict(assigner=dict(
        type='MaxIoUAssigner', pos_iou_thr=0.5, neg_iou_thr=0.4,
        min_pos_iou=0, ignore_iof_thr=0.5))), True),
], ids=['retina', 'reg-decoded-smooth-l1', 'circumhbbox', 'ignore-regions'])
def test_head_loss_matches_jax(kw, with_ignore):
    """The head's loss on random maps: NCHW maps in the port, the same
    values NHWC in the JAX package, so anchors, logits and deltas line up
    (rtol 1e-4: float32 sums over ~3000 anchors x 4 classes)."""
    cfg = head_cfg(**kw)
    batch = make_batch(5)
    rng = np.random.default_rng(6)
    maps = [(rng.normal(-2, 1, (2, n, n, 9 * 4)).astype(np.float32),
             rng.normal(0, 0.3, (2, n, n, 9 * 5)).astype(np.float32))
            for n in (16, 8, 4, 2, 1)]
    ignore = {}
    if with_ignore:
        ign = np.zeros((2, 2, 5), np.float32)
        ign[:, 0] = [70., 60., 60., 40., 0.5]
        ignore = dict(gt_ignore=ign,
                      gt_ignore_mask=np.array([[True, False]] * 2))
    j_head = J_HEADS.build(cfg)
    ref = jax.jit(lambda o, b, i: j_head.loss(
        o, b['gt_bboxes'], b['gt_labels'], b['gt_mask'], **i))(
            ([m[0] for m in maps], [m[1] for m in maps]), batch, ignore)
    head = HEADS.build(cfg)
    nchw = lambda x: torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    tb = to_torch(batch)
    got = head.loss(([nchw(m[0]) for m in maps], [nchw(m[1]) for m in maps]),
                    tb['gt_bboxes'], tb['gt_labels'], tb['gt_mask'],
                    **to_torch(ignore))
    for k in ('loss_cls', 'loss_bbox'):
        np.testing.assert_allclose(got[k].item(), float(ref[k]), rtol=1e-4)
    if with_ignore:
        without = head.loss(
            ([nchw(m[0]) for m in maps], [nchw(m[1]) for m in maps]),
            tb['gt_bboxes'], tb['gt_labels'], tb['gt_mask'])
        assert without['loss_cls'] != got['loss_cls']   # the region bites


def test_head_without_training_config_refuses_loss():
    cfg = dict(model_cfg(18)['bbox_head'])
    head = HEADS.build(cfg)
    with pytest.raises(RuntimeError, match='assigner'):
        head.loss(([], []), None, None, None)


def test_train_entry_points_refuse_a_missing_card_and_live_bn():
    detector = build_detector(model_cfg(18))
    tx = build_optimizer(OPT_CONFIG, 0.01)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            create_train_state(detector, tx)
    with pytest.raises(NotImplementedError):
        make_train_step(detector, tx, norm_eval=False)
    with pytest.raises(NotImplementedError):
        build_detector(dict(model_cfg(18), backbone=dict(
            type='ResNet', depth=18, norm_eval=False)))


def test_checkpoint_round_trip_and_rotation(tmp_path):
    cfg = model_cfg(18)
    batch = to_torch(make_batch(9))

    def fresh(seed):
        tx = build_optimizer(OPT_CONFIG,
                             build_lr_schedule(LR_CONFIG, BASE_LR, 10),
                             grad_clip=dict(max_norm=MAX_NORM),
                             frozen_stages=1)
        detector = build_detector(cfg)
        state = create_train_state(detector, tx, device='cpu', seed=seed)
        return state, make_train_step(detector, tx)

    state, step = fresh(0)
    work = str(tmp_path / 'run')
    assert find_latest_checkpoint(work) is None
    for i in range(1, 6):
        state, _ = step(state, batch)            # momentum is non-zero
        path = save_checkpoint(work, state, state.step, keep=3)
    names = [p.rsplit('/', 1)[-1] for p in find_checkpoints(work)]
    assert names == ['ckpt_00000003.pth', 'ckpt_00000004.pth',
                     'ckpt_00000005.pth']
    assert find_latest_checkpoint(work) == path
    save_checkpoint(work, state, 2, prefix='best')
    save_checkpoint(work, state, 4, prefix='best')
    assert len(find_checkpoints(work)) == 3      # outside the rotation
    assert sorted(p.name for p in (tmp_path / 'run').iterdir()
                  if p.name.startswith('best')) == ['best_00000004.pth']
    assert not list((tmp_path / 'run').glob('*.tmp'))

    other, other_step = fresh(1)                 # different weights
    other = load_checkpoint(path, other)
    assert other.step == state.step == 5
    for (n, a), (_, b) in zip(state.model.state_dict().items(),
                              other.model.state_dict().items()):
        assert torch.equal(a, b), n
    state, m1 = step(state, batch)               # resumes identically
    other, m2 = other_step(other, batch)
    assert torch.equal(m1['loss'], m2['loss'])
    for a, b in zip(state.model.parameters(), other.model.parameters()):
        assert torch.equal(a, b)
