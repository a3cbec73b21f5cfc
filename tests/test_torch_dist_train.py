"""Port parity, data-parallel training: ``make_train_step`` over two ranks
(``torch.distributed`` with gloo on the CPU) against the port's
one-process step on the whole batch, against the JAX package's
``make_train_step`` jitted over a 2-device CPU mesh (the set-up of
``tests/test_parallel/test_multidevice.py``), and against a negative
control that the batch must tell apart; then the loader's shards.

Three cases, each one SGD step on a global batch of 4 images (2 a rank)
whose halves hold different numbers of valid gts:

- ``retinanet``: ResNet-18 RetinaNet, 32-wide FPN and head, frozen BN,
  128 px; the control takes each rank's own loss with its own normalizers
  and averages the gradients (a plain ``DistributedDataParallel``);
- ``orcnn``: ``configs/oriented_rcnn/oriented_rcnn_tiny_synth.py`` at
  128 px with the JAX package's draws for the sampling keys (as
  ``tests/test_torch_two_stage_train.py``); the control samples with each
  rank's local image indices;
- ``yolov8``: prototype4 cut as ``tests/test_torch_live_bn.py`` cuts it,
  128 px (at 64 px the deepest BN statistics pool 16 values, and a 1e-7
  change of the images moves ``grad_norm`` by 2e-5), live BN; the control
  normalizes with each rank's own statistics.

Two more families, against the one-process step alone (their
single-process steps are held to JAX by ``tests/test_torch_refine_train.py``
and ``tests/test_torch_reppoints_train.py``): ``s2anet`` (refine) and
``oriented_reppoints`` (point set), their tiny-synth configs with the
port's seeded weights, boxes of 12-48 px at 128 px, and a clip of 1.0,
below their gradients' norms. Then every family's training outputs are
checked to be per image (what ``mesh.gather_batch`` gathers), and the
gather's refusal of any other tensor.

Each case steps with its published config's SGD, warmup and clip
(``RECIPES``) at 400 times the configs' rate of 0.0025 (as
``tests/test_torch_live_bn.py`` steps), so each parameter moves well above
its float32 rounding, and the clip is active. The ranks are two
processes started once for the module (``file://`` rendezvous in a
temporary directory); each join has its own time limit.

Tolerances: against the one-process step in float32, each loss and
``grad_norm`` within 1e-5 relative, each parameter tensor within 1e-5 of
its largest element, the sampled RoIs' labels and weights equal and their
boxes within 1e-4, the live BN running statistics within 1e-6 of their
largest magnitude; against JAX, the losses at rtol 1e-4 and each
parameter's change within 2e-3 of that tensor's largest change in JAX plus
2 float32 ulps of its largest value (``tests/test_torch_live_bn.py``).
"""

import glob
import os.path as osp
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from orientedobjectdetection_tpu.core import assigners as j_assigners
from orientedobjectdetection_tpu.models import build_detector as j_build
from orientedobjectdetection_tpu.parallel import train_state as j_ts
from orientedobjectdetection_tpu.parallel.mesh import make_mesh
from orientedobjectdetection_tpu.utils.config import Config as JConfig
from orientedobjectdetection_torch.core import assigners
from orientedobjectdetection_torch.core.assigners import SampleKey
from orientedobjectdetection_torch.datasets.loader import DataLoader
from orientedobjectdetection_torch.models import build_detector
from orientedobjectdetection_torch.parallel import (build_lr_schedule,
                                                    build_optimizer,
                                                    create_train_state,
                                                    make_train_step, mesh)
from orientedobjectdetection_torch.utils import Config
from orientedobjectdetection_torch.utils.jax_weights import (
    from_jax_variables, to_jax_layout)

torch.set_num_threads(1)

TESTS = osp.dirname(osp.abspath(__file__))
ROOT = osp.dirname(TESTS)
ORCNN = osp.join(ROOT, 'configs', 'oriented_rcnn',
                 'oriented_rcnn_tiny_synth.py')
WORLD = 2
GLOBAL = 4
JOIN_S = 420
LR = 1.0                        # 400 x the configs' 0.0025
# each case's optimizer, warmup and clip: its published config's
RECIPES = {
    'retinanet': osp.join(ROOT, 'configs', 'rotated_retinanet',
                          'rotated_retinanet_obb_r50_fpn_1x_dota_le90.py'),
    'orcnn': osp.join(ROOT, 'configs', 'oriented_rcnn',
                      'oriented_rcnn_r50_fpn_1x_dota_le90.py'),
    'yolov8': osp.join(ROOT, 'configs', 'jy', 'prototype4.py'),
    's2anet': osp.join(ROOT, 'configs', 's2anet', 's2anet_tiny_synth.py'),
    'oriented_reppoints': osp.join(ROOT, 'configs', 'oriented_reppoints',
                                   'oriented_reppoints_tiny_synth.py'),
}


def recipe(name):
    """(optimizer config without its rate, lr_config, grad_clip)."""
    cfg = Config.fromfile(RECIPES[name])
    opt = dict(cfg.optimizer)
    opt.pop('lr')
    max_norm = cfg.optimizer_config['grad_clip']['max_norm']
    if name in FAMILIES:          # below their seeded gradients' norms
        max_norm = 1.0
    return opt, dict(cfg.lr_config), dict(max_norm=max_norm)
VALID = (3, 3, 1, 0)            # per image: the halves differ


# ---- spawning ranks ---------------------------------------------------------
def start_ranks(module: str, function: str, workdir: str,
                world: int = WORLD) -> list:
    """Start ``module.function(rank, world, init_method, workdir)`` in
    ``world`` fresh Python processes (the tests directory on their path),
    with a ``file://`` rendezvous inside ``workdir``."""
    init = 'file://' + osp.join(workdir, 'rendezvous')
    code = (f'import sys; sys.path[:0] = [{TESTS!r}, {ROOT!r}]; '
            f'import {module} as m; '
            f'm.{function}(int(sys.argv[1]), {world}, {init!r}, '
            f'{workdir!r})')
    return [subprocess.Popen([sys.executable, '-c', code, str(r)],
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def join_ranks(procs: list, started: float, timeout: float = JOIN_S) -> None:
    """Wait for each rank with what is left of its own time limit; kill
    every rank still running when one fails or overruns, and fail the
    test with its output."""
    failures = []
    try:
        for r, p in enumerate(procs):
            left = max(1.0, timeout - (time.perf_counter() - started))
            try:
                out, _ = p.communicate(timeout=left)
            except subprocess.TimeoutExpired:
                failures.append(f'rank {r} ran past {timeout} s')
                break
            if p.returncode != 0:
                failures.append(f'rank {r} exited {p.returncode}:\n'
                                f'{out[-4000:]}')
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failures:
        pytest.fail('\n'.join(failures))


# ---- the JAX package's draws for the port's keys ----------------------------
def jax_keys(key: SampleKey):
    """The JAX keys that ``key`` stands for, one per image of the rank,
    their per-image splits taken at the images' places in the global
    batch (``offset``, ``total``)."""
    batch = key.batch_size()
    if key.gt_bboxes is not None:
        roots = jax.vmap(j_assigners.rng_from_gt)(
            jnp.asarray(key.gt_bboxes.cpu().numpy()))
        keys = [roots[b] for b in range(batch)]
    else:
        keys = [jax.random.fold_in(jax.random.PRNGKey(0), key.step)] * batch
    out = []
    for b, k in enumerate(keys):
        for n, i in key.path:
            if i is None:
                k = jax.random.split(k, key.total or n)[key.offset + b]
            else:
                k = jax.random.split(k, n)[i]
        out.append(k)
    return out


def jax_uniform(key, n, device):
    return torch.from_numpy(np.stack([
        np.asarray(jax.random.uniform(k, (n,))) for k in jax_keys(key)
    ])).to(device)


# ---- the cases --------------------------------------------------------------
def retina_model():
    from __graft_entry__ import _retina_cfg
    return _retina_cfg(num_classes=4, depth=18, channels=32, stacked=1)


def yolo_model():
    from test_torch_live_bn import small_model
    return small_model()


def orcnn_model():
    return dict(Config.fromfile(ORCNN).model)


def model_of(name):
    if name in FAMILIES:
        return dict(Config.fromfile(RECIPES[name]).model)
    return {'retinanet': retina_model, 'orcnn': orcnn_model,
            'yolov8': yolo_model}[name]()


SIZES = {'retinanet': 128, 'orcnn': 128, 'yolov8': 128}
FROZEN = {'retinanet': 1, 'orcnn': 1, 'yolov8': -1, 's2anet': -1,
          'oriented_reppoints': -1}


def family_case(name: str, size: int = 128) -> dict:
    """The port's seeded weights of a family's tiny-synth config and a
    global batch of boxes 12-48 px, ``VALID`` of them an image."""
    rng = np.random.default_rng(41)
    det = build_detector(model_of(name))
    det.init_weights(41)
    images = rng.normal(0, 1, (GLOBAL, size, size, 3)).astype(np.float32)
    gts = np.stack([rng.uniform(24, size - 24, (GLOBAL, 8)),
                    rng.uniform(24, size - 24, (GLOBAL, 8)),
                    rng.uniform(12, 48, (GLOBAL, 8)),
                    rng.uniform(12, 48, (GLOBAL, 8)),
                    rng.uniform(-0.7, 0.7, (GLOBAL, 8))], -1)
    mask = np.arange(8)[None] < np.asarray(VALID)[:, None]
    gts = np.where(mask[..., None], gts, 0).astype(np.float32)
    labels = rng.integers(0, 3, (GLOBAL, 8)).astype(np.int32)
    return dict(state_dict={k: v.clone()
                            for k, v in det.state_dict().items()},
                batch=dict(images=images, gt_bboxes=gts, gt_labels=labels,
                           gt_mask=mask))


def make_case(name: str) -> dict:
    """Weights in the flax tree (numpy) and the global batch of ``name``."""
    if name in FAMILIES:
        return family_case(name)
    size = SIZES[name]
    rng = np.random.default_rng({'retinanet': 11, 'orcnn': 31,
                                 'yolov8': 21}[name])
    images = rng.normal(0, 1, (GLOBAL, size, size, 3)).astype(np.float32)
    if name == 'retinanet':
        from test_torch_train import SIZE, random_variables
        assert SIZE == size
        det = j_build(retina_model())
        variables = random_variables(det, 11)
        gts = np.zeros((GLOBAL, 8, 5), np.float32)
        pool = make_anchor_pool(size)
        for b, v in enumerate(VALID):
            pick = pool[rng.choice(len(pool), v, replace=False)]
            gts[b, :v] = pick
            gts[b, :v, :2] += rng.uniform(-3, 3, (v, 2))
            gts[b, :v, 2:4] *= rng.uniform(0.8, 1.25, (v, 2))
            gts[b, :v, 4] = rng.uniform(-0.3, 0.3, v)
        labels = rng.integers(0, 4, (GLOBAL, 8)).astype(np.int32)
    elif name == 'orcnn':
        from test_torch_two_stage_train import perturb_variables
        det = j_build(dict(JConfig.fromfile(ORCNN).model))
        shapes = jax.eval_shape(det.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, size, size, 3), jnp.float32))
        variables = perturb_variables(shapes, 31)
        gts = np.zeros((GLOBAL, 8, 5), np.float32)
        for b, v in enumerate((3, 3, 1, 1)):   # every image samples
            gts[b, :v] = decided_rpn_gts(rng, v, size)
        labels = rng.integers(0, 2, (GLOBAL, 8)).astype(np.int32)
    else:
        from test_torch_live_bn import filled
        from test_torch_yolov8 import random_gts
        det = j_build(yolo_model())
        variables = filled(det, images[:2], rng)
        gts, labels, _ = random_gts(rng, bsz=GLOBAL, g=8, valid=4, size=size)
        gts[..., 2:4] *= 0.5
    valid = (3, 3, 1, 1) if name == 'orcnn' else VALID
    mask = np.arange(gts.shape[1])[None] < np.asarray(valid)[:, None]
    gts = np.where(mask[..., None], gts, 0).astype(np.float32)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    return dict(variables=variables, batch=dict(
        images=images, gt_bboxes=gts, gt_labels=labels, gt_mask=mask))


def decided_rpn_gts(rng, valid, size, margin=1e-4, thresholds=(0.3, 0.7)):
    """``valid`` pixel-aligned gts (integer centres and sizes, angles in
    1/64 rad, so JAX ``rng_from_gt``'s float32 sum is exact in any order),
    drawn again until the RPN's assignment is decided by more than
    ``margin``: each gt's best anchor leads the next and no anchor's best
    IoU lies that close to a threshold. Exact ties are decided by rounding,
    and two JAX programs decide them differently
    (``tests/test_torch_rotated_rpn.py:well_posed_batch``, ROADMAP C)."""
    from orientedobjectdetection_torch.ops import box_iou_rotated
    from orientedobjectdetection_torch.ops.boxes import obb2hbb
    head = build_detector(orcnn_model()).rpn_head
    sizes = [(size // s, size // s) for s in (4, 8, 16, 32, 64)]
    anchors = head.train_anchors(sizes, 'cpu')[1]
    for _ in range(1000):
        gts = np.stack([
            rng.integers(30, size - 30, valid),
            rng.integers(30, size - 30, valid),
            rng.integers(20, 60, valid), rng.integers(20, 60, valid),
            rng.integers(-77, 77, valid) / 64.0], -1).astype(np.float32)
        iou = box_iou_rotated(obb2hbb(torch.from_numpy(gts), 'le90'),
                              anchors)
        top2 = iou.topk(2, dim=1)[0]
        best = iou.amax(0)
        if (top2[:, 0] - top2[:, 1] > margin).all() and all(
                float((best - t).abs().min()) > margin for t in thresholds):
            return gts
    raise AssertionError('no decided gts')


def make_anchor_pool(size):
    from orientedobjectdetection_torch.core import RotatedAnchorGenerator
    strides = [8, 16, 32, 64, 128]
    anchors = torch.cat(RotatedAnchorGenerator(
        octave_base_scale=4, scales_per_octave=3, ratios=[1.0, 0.5, 2.0],
        strides=strides).grid_priors(
            [(-(-size // s), -(-size // s)) for s in strides]), 0).numpy()
    return anchors[anchors[:, 2:4].max(1) < 80]


def port_step(name, case):
    """One port step from the case's weights on its batch (a rank's shard
    inside a process group). Returns the metrics, the state dict after the
    step and, for Oriented R-CNN, the RoI sampler's outputs."""
    detector = build_detector(model_of(name))
    opt, lr_config, clip = recipe(name)
    tx = build_optimizer(opt, build_lr_schedule(lr_config, LR, 10),
                         grad_clip=clip, frozen_stages=FROZEN[name])
    state = create_train_state(
        detector, tx, device='cpu',
        state_dict=case.get('state_dict')
        or from_jax_variables(case['variables']))
    step = make_train_step(detector, tx, norm_eval=name != 'yolov8')
    batch = {k: torch.from_numpy(v) for k, v in case['batch'].items()}
    sampled = []
    if name == 'orcnn':
        head = detector.roi_head
        inner = head.sample_rois

        def sample_rois(*args, **kwargs):
            out = inner(*args, **kwargs)
            sampled.append([t.clone() for t in out[:3]])
            return out
        head.sample_rois = sample_rois
    state, metrics = step(state, batch)
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                state={k: v.detach().clone()
                       for k, v in detector.state_dict().items()},
                sampled=sampled[0] if sampled else None)


CASES = ('retinanet', 'orcnn', 'yolov8')
# a refine and a point-set family, held to the one-process step
FAMILIES = ('s2anet', 'oriented_reppoints')


def rank_main(rank, world, init, workdir):
    """A rank: each case's data-parallel step and its negative control on
    the rank's rows of the global batch."""
    torch.set_num_threads(1)
    assigners.uniform = jax_uniform              # the JAX package's draws
    mesh.init_distributed('cpu', init_method=init, rank=rank,
                          world_size=world)
    cases = torch.load(osp.join(workdir, 'cases.pt'), weights_only=False)
    out = {}
    for name in CASES + FAMILIES:
        case = dict(cases[name], batch=mesh.shard_batch(cases[name]['batch']))
        out[name] = port_step(name, case)
        if name in CASES:
            out[f'{name}_control'] = control_step(name, case)
    torch.save(out, osp.join(workdir, f'rank{rank}.pt'))
    mesh.destroy()


def control_step(name, case):
    """The negative control of ``name``: the data-parallel step with the one
    piece of the global batch's semantics that this case tests replaced by
    the rank's local version."""
    saved = (mesh.gather_batch, mesh.all_reduce_grads, mesh.all_reduce_sum,
             mesh.batch_offset)
    try:
        if name == 'retinanet':             # local normalizers, DDP's mean
            def mean_grads(grads):
                saved[1](grads)
                torch._foreach_div_(grads, float(mesh.world_size()))
            mesh.gather_batch = lambda tree, local: tree
            mesh.all_reduce_grads = mean_grads
        elif name == 'orcnn':               # local sampler indices
            mesh.batch_offset = lambda local: (0, local)
        else:                               # local BN statistics
            mesh.all_reduce_sum = lambda t: t
        return port_step(name, case)
    finally:
        (mesh.gather_batch, mesh.all_reduce_grads, mesh.all_reduce_sum,
         mesh.batch_offset) = saved


def jax_mesh_step(name, case):
    """JAX ``make_train_step`` jitted over a 2-device CPU mesh: the batch
    sharded, the state replicated."""
    det = j_build(model_of(name) if name != 'orcnn'
                  else dict(JConfig.fromfile(ORCNN).model))
    variables = jax.tree_util.tree_map(jnp.asarray, case['variables'])
    opt, lr_config, clip = recipe(name)
    sched = j_ts.build_lr_schedule(lr_config, LR, 10)
    tx = j_ts.build_optimizer(opt, sched, grad_clip=clip,
                              params=variables['params'],
                              frozen_stages=FROZEN[name])
    state = j_ts.create_train_state(det, None, None, tx, variables=variables)
    step = jax.jit(j_ts.make_train_step(det, tx,
                                        norm_eval=name != 'yolov8'))
    dmesh = make_mesh(jax.devices()[:WORLD])
    data, repl = NamedSharding(dmesh, P('data')), NamedSharding(dmesh, P())
    batch = {k: jax.device_put(jnp.asarray(v), data)
             for k, v in case['batch'].items()}
    state = jax.tree_util.tree_map(lambda x: jax.device_put(x, repl), state)
    state, metrics = step(state, batch)
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                state=jax.tree_util.tree_map(np.asarray, state))


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The cases, the ranks' results, the one-process steps and the JAX
    mesh steps (computed while the ranks run)."""
    workdir = str(tmp_path_factory.mktemp('dist_train'))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)             # as the ranks: the same sums
    cases = {name: make_case(name) for name in CASES + FAMILIES}
    torch.save(cases, osp.join(workdir, 'cases.pt'))
    t0 = time.perf_counter()
    procs = start_ranks('test_torch_dist_train', 'rank_main', workdir)
    try:
        saved = assigners.uniform
        assigners.uniform = jax_uniform
        try:
            single = {name: port_step(name, cases[name])
                      for name in CASES + FAMILIES}
        finally:
            assigners.uniform = saved
        jaxed = {name: jax_mesh_step(name, cases[name]) for name in CASES}
    finally:
        torch.set_num_threads(threads)
        join_ranks(procs, t0)
    ranks = [torch.load(osp.join(workdir, f'rank{r}.pt'),
                        weights_only=False) for r in range(WORLD)]
    return dict(cases=cases, single=single, jax=jaxed, ranks=ranks)


def same_step(got, ref, name, rtol=1e-5):
    """The port's comparison of two steps (the module docstring's first
    tolerances); raises AssertionError on the first difference."""
    for k, v in ref['metrics'].items():
        assert abs(got['metrics'][k] - v) <= rtol * abs(v), \
            (name, k, got['metrics'][k], v)
    for k, v in ref['state'].items():
        g = got['state'][k]
        if k.endswith(('running_mean', 'running_var')):
            atol = 1e-6 * float(v.abs().max())
        else:
            atol = 1e-5 * float(v.abs().max())
        assert float((g - v).abs().max()) <= atol, (name, k)


@pytest.mark.parametrize('name', CASES + FAMILIES)
def test_two_ranks_equal_the_one_process_step(runs, name):
    """Both ranks end where one process on the whole batch ends: every
    loss, ``grad_norm`` and parameter, and the running statistics."""
    ref = runs['single'][name]
    assert ref['metrics']['grad_norm'] > recipe(name)[2]['max_norm']
    for rank in runs['ranks']:
        same_step(rank[name], ref, name)
    a, b = (r[name]['state'] for r in runs['ranks'])
    for k in a:                          # the ranks agree bit for bit
        assert torch.equal(a[k], b[k]), k


def test_sampled_rois_are_the_global_batch_s(runs):
    """Oriented R-CNN: rank r's images sample what images ``2r`` and
    ``2r + 1`` sample in one process (the keys' offset and total)."""
    ref = runs['single']['orcnn']['sampled']
    got = [torch.cat([r['orcnn']['sampled'][i] for r in runs['ranks']])
           for i in range(3)]
    rois, labels, weights = got
    assert torch.equal(labels, ref[1]) and torch.equal(weights, ref[2])
    torch.testing.assert_close(rois, ref[0], rtol=0, atol=1e-4)
    assert int((ref[1] < 2).sum()) > 0               # positives sampled


@pytest.mark.parametrize('name', CASES)
def test_two_ranks_equal_the_jax_mesh_step(runs, name):
    """The losses at rtol 1e-4 and each parameter's change within 2e-3 of
    JAX's largest change in that tensor plus 2 float32 ulps; the live BN
    statistics within 1e-5 of JAX's."""
    from test_torch_refine import leaves
    got, ref = runs['ranks'][0][name], runs['jax'][name]
    for k in ref['metrics']:
        if 'loss' in k:
            np.testing.assert_allclose(got['metrics'][k], ref['metrics'][k],
                                       rtol=1e-4, err_msg=k)
    layout = to_jax_layout(got['state'])
    after = dict(leaves(layout['params']))
    jparams = dict(leaves(ref['state'].params))
    before = dict(leaves(runs['cases'][name]['variables']['params']))
    assert sorted(after) == sorted(jparams)
    moved = 0
    for k, r in jparams.items():
        p = before[k]
        change = r - p
        atol = (2e-3 * np.abs(change).max()
                + 2 * np.spacing(np.abs(p).max().astype(np.float32)))
        np.testing.assert_allclose(after[k] - p, change, rtol=0, atol=atol,
                                   err_msg=k)
        moved += bool(np.abs(change).max() > 0)
    assert moved > 0.5 * len(jparams)
    if name == 'yolov8':
        stats = dict(leaves(layout['batch_stats']))
        for k, r in leaves(ref['state'].batch_stats):
            np.testing.assert_allclose(stats[k], r, rtol=0, atol=1e-5,
                                       err_msg=k)


@pytest.mark.parametrize('name', CASES)
def test_the_negative_control_fails_the_comparison(runs, name):
    """Local normalizers (RetinaNet), local sampler indices (Oriented
    R-CNN) or local BN statistics (YOLOv8) do not pass the comparison on
    this batch: the batch tells the global semantics apart."""
    ref = runs['single'][name]
    for rank in runs['ranks']:
        with pytest.raises(AssertionError):
            same_step(rank[f'{name}_control'], ref, name)


def test_keys_with_an_offset_are_the_global_batch_s():
    """A rank's per-image keys (``offset``, ``total``) are the global
    batch's rows, on the device hash."""
    key = SampleKey(step=3).split(2, 1).split(6)
    whole = assigners.uniform(key.split(2, 0), 50, 'cpu')
    for offset in (0, 2, 4):
        part = SampleKey(step=3, offset=offset, total=6).split(2, 1).split(2)
        torch.testing.assert_close(assigners.uniform(part.split(2, 0), 50,
                                                     'cpu'),
                                   whole[offset:offset + 2], rtol=0, atol=0)
    local = SampleKey(step=3).split(2, 1).split(2)
    assert not torch.equal(assigners.uniform(local.split(2, 0), 50, 'cpu'),
                           whole[2:4])


# ---- the outputs that a data-parallel step gathers --------------------------
# one config of each detector family (and head) that the port trains
OUTPUT_CONFIGS = sorted(
    osp.relpath(p, osp.join(ROOT, 'configs')) for p in
    glob.glob(osp.join(ROOT, 'configs', '*', '*_tiny_synth.py'))
    + [osp.join(ROOT, 'configs', 'rotated_reppoints',
                'rotated_reppoints_hard_synth.py')])


@pytest.mark.parametrize('config', OUTPUT_CONFIGS)
def test_training_outputs_are_per_image(config):
    """Every tensor of a family's training outputs has the batch as its
    leading axis, at two batch sizes, or is 0-d: ``mesh.gather_batch``,
    which refuses any other tensor, takes the outputs of every family."""
    torch.manual_seed(0)
    det = build_detector(dict(Config.fromfile(
        osp.join(ROOT, 'configs', config)).model))
    det.init_weights(0)
    for bsz in (2, 3):
        rng = np.random.default_rng(bsz)
        gts = np.stack([rng.uniform(16, 48, (bsz, 4)),
                        rng.uniform(16, 48, (bsz, 4)),
                        rng.uniform(8, 24, (bsz, 4)),
                        rng.uniform(8, 24, (bsz, 4)),
                        rng.uniform(-0.7, 0.7, (bsz, 4))], -1)
        batch = dict(gt_bboxes=torch.from_numpy(gts.astype(np.float32)),
                     gt_labels=torch.zeros(bsz, 4, dtype=torch.int32),
                     gt_mask=torch.ones(bsz, 4, dtype=torch.bool))
        images = torch.from_numpy(
            rng.normal(0, 1, (bsz, 3, 64, 64)).astype(np.float32))
        outputs = det(images, batch=batch, train=True,
                      rng=SampleKey(step=0))
        mesh.gather_batch(outputs, bsz)


def test_gather_batch_refuses_what_is_not_per_image():
    """A flattened per-image tensor, or one the images share, is refused
    with its place in the outputs; a 0-d statistic becomes None."""
    per_image = torch.zeros(2, 5)
    got = mesh.gather_batch(dict(a=per_image, n=torch.tensor(3.0)), 2)
    assert got['a'] is per_image and got['n'] is None
    for bad in (torch.zeros(6, 5), torch.zeros(7)):
        with pytest.raises(ValueError, match=r"\['x'\]\[1\]"):
            mesh.gather_batch(dict(x=[per_image, bad]), 2)


# ---- the loader's shards ---------------------------------------------------
class FakeDataset:
    def __len__(self):
        return 33

    def __getitem__(self, i):
        img = np.zeros((8, 8, 3), np.float32)
        img[0, 0, 0] = i
        img[1, 1, 1] = np.random.default_rng(i).uniform()
        return dict(img=img, gt_bboxes=np.asarray([[4., 4., 2., 2., 0.]]),
                    gt_labels=np.asarray([0]), img_metas={'idx': i})


@pytest.mark.parametrize('shuffle', [False, True])
def test_dataset_sharding_covers_all_samples_once(shuffle):
    """Two shards of 33 samples: 16 each, disjoint, every sample but one
    (the JAX test of the same name, ``len(dataset) // num_shards``)."""
    seen = []
    for shard in range(2):
        loader = DataLoader(FakeDataset(), batch_size=4, shuffle=shuffle,
                            num_workers=2, shard_id=shard, num_shards=2,
                            drop_last=False)
        assert len(loader) == 4
        got = [int(v) for b in loader
               for v in b['images'][:, 0, 0, 0].tolist()]
        assert len(got) == 16
        seen.extend(got)
    assert len(set(seen)) == 32 and set(seen) <= set(range(33))
    with pytest.raises(ValueError, match='shard_id'):
        DataLoader(FakeDataset(), 4, shard_id=2, num_shards=2)
