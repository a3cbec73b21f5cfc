"""Port parity, training the point-set families: two steps through
``make_train_step`` against the JAX package's jitted step, with each
config's optimizer (SGD, its learning rate, momentum, weight decay, the
gradient clip, the warmup schedule and the frozen stem and layer 1), for
Rotated RepPoints (its DOTA config cut as ``tests/test_torch_reppoints.py``
cuts it) and the four tiny-synth configs as they stand (ResNet-18, 64
wide, two stacked convs): Oriented RepPoints, CFA, SASM and G-RepPoints.

Every loss term at rtol 1e-4 in both steps; every parameter after them
within 1e-5 (the SGD update of gradients that agree to 2e-3 of their
largest). Carried weights and gts as in ``tests/test_torch_reppoints.py``,
128 px."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orientedobjectdetection_tpu.models import build_detector as j_build
from orientedobjectdetection_tpu.parallel import train_state as j_ts
from orientedobjectdetection_torch.models import build_detector
from orientedobjectdetection_torch.parallel import (build_lr_schedule,
                                                    build_optimizer,
                                                    create_train_state,
                                                    make_train_step)
from orientedobjectdetection_torch.utils import Config
from orientedobjectdetection_torch.utils.jax_weights import (
    from_jax_variables, to_jax_layout)
from test_torch_refine import leaves
from test_torch_reppoints import (CONFIGS, SIZE, TINY_CONFIGS,
                                  fill_variables, random_gts, small_model)

torch.set_num_threads(1)

RECIPES = [('rotated', False), ('oriented', True), ('cfa', True),
           ('sasm', True), ('g', True)]


@pytest.mark.parametrize('key, tiny', RECIPES,
                         ids=[f'{k}{"_tiny" if t else ""}'
                              for k, t in RECIPES])
def test_two_train_steps_match_jax(key, tiny):
    full = Config.fromfile(TINY_CONFIGS[key] if tiny else CONFIGS[key])
    cfg = small_model(key, tiny=tiny)
    classes = cfg['bbox_head']['num_classes']
    det = j_build(cfg)
    rng = np.random.default_rng(70 + len(key) + tiny)
    images = rng.normal(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    shapes = jax.eval_shape(det.init, jax.random.PRNGKey(0),
                            jnp.asarray(images))
    variables = fill_variables(shapes, rng)
    gt_bboxes, gt_labels, gt_mask = random_gts(rng, classes=classes)
    batch = dict(images=images, gt_bboxes=gt_bboxes, gt_labels=gt_labels,
                 gt_mask=gt_mask)

    opt = dict(full.optimizer)
    lr = opt.pop('lr')
    grad_clip = dict(full.optimizer_config['grad_clip'])
    grad_clip.pop('norm_type', None)
    frozen = full.model['backbone']['frozen_stages']
    sched = j_ts.build_lr_schedule(dict(full.lr_config), lr, 10)
    tx = j_ts.build_optimizer(opt, sched, grad_clip=grad_clip,
                              params=variables['params'],
                              frozen_stages=frozen)
    state = j_ts.create_train_state(det, None, None, tx, variables=variables)
    step = jax.jit(j_ts.make_train_step(det, tx))
    j_metrics = []
    for _ in range(2):
        state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        j_metrics.append({k: float(v) for k, v in m.items()})

    port_tx = build_optimizer(opt, build_lr_schedule(dict(full.lr_config),
                                                     lr, 10),
                              grad_clip=grad_clip, frozen_stages=frozen)
    detector = build_detector(cfg)
    port_state = create_train_state(detector, port_tx, device='cpu',
                                    state_dict=from_jax_variables(variables))
    port_step = make_train_step(detector, port_tx)
    terms = [k for k in j_metrics[0] if 'loss_' in k]
    assert len(terms) == (5 if key == 'oriented' else 3)
    for ref in j_metrics:
        port_state, m = port_step(port_state, {
            k: torch.from_numpy(v) for k, v in batch.items()})
        for k in terms + ['loss']:
            np.testing.assert_allclose(float(m[k]), ref[k], rtol=1e-4,
                                       err_msg=k)
            assert ref[k] > 0, k
    after = dict(leaves(to_jax_layout(detector.state_dict())['params']))
    ref = dict(leaves(jax.tree_util.tree_map(np.asarray, state.params)))
    assert sorted(after) == sorted(ref)
    moved = 0
    for name, r in ref.items():
        np.testing.assert_allclose(after[name], r, rtol=0, atol=1e-5,
                                   err_msg=name)
        moved += not np.array_equal(r, dict(leaves(variables['params']))[
            name])
    assert moved > 10
