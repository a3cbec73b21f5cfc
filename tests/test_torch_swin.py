"""Port parity, the Swin Transformer backbone against the JAX package on the
same random weights (carried by ``from_jax_variables``), and the Swin
detectors built on it:

- the window helpers (the relative position index, the shifted-window
  mask of -1e9);
- the backbone's four outputs at 128 px, where stage 3 (4 x 4) shrinks its
  window to 4 and keeps the shift of 3, and at 90 x 70 px, a size the patch
  embedding's stride does not divide (``'SAME'`` padding), where stage 2
  shrinks to 5 (shift kept) and stage 3 to 3 (shift dropped);
- the patch merging's channel order: mmdet's channel-major unfold, with
  the JAX package's tap-major tensors permuted in the carry (an unpermuted
  carry gives other outputs);
- the carry both ways, a shrunk bias table cut back by the template;
- a narrow Swin Oriented R-CNN (``oriented_rcnn_swin_tiny_fpn_1x_dota_le90
  .py``'s backbone at 16 embedding dims and depths 2 in the tiny-synth
  Oriented R-CNN, 128 px): served detections, step-0 losses and
  gradients, and one AdamW step through ``make_train_step``
  (:class:`test_torch_rotated_rpn.Family`);
- a narrow Swin RoI Transformer (``roi_trans_swin_tiny_fpn_1x_dota_le90
  .py``'s backbone, the same cut, in the tiny-synth RoI Transformer):
  served detections.

Tolerances: backbone outputs 1e-5 of each map's largest value (float32,
other summation orders); the rest as the harness states, apart from the
AdamW step's parameters, see :func:`test_adamw_step_matches_jax`.
"""

import copy
import os.path as osp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orientedobjectdetection_tpu.models.backbones import swin as j_swin
from orientedobjectdetection_tpu.parallel import train_state as j_ts
from orientedobjectdetection_torch.models.backbones import SwinTransformer
from orientedobjectdetection_torch.models.backbones import swin
from orientedobjectdetection_torch.parallel import frozen_mask, make_train_step
from orientedobjectdetection_torch.utils import Config
from orientedobjectdetection_torch.utils.jax_weights import (
    from_jax_variables, to_jax_layout)
from test_torch_rotated_rpn import BASE_LR, CLIP, CONFIGS, Family
from test_torch_rotated_rpn import jax_draws  # noqa: F401 (a fixture)
from test_torch_two_stage_train import leaves, to_torch

torch.set_num_threads(1)

NARROW = dict(embed_dims=16, depths=(2, 2, 2, 2), num_heads=(1, 2, 2, 4))
ORCNN = osp.join(CONFIGS, 'oriented_rcnn',
                 'oriented_rcnn_swin_tiny_fpn_1x_dota_le90.py')
ROI_TRANS = osp.join(CONFIGS, 'roi_trans',
                     'roi_trans_swin_tiny_fpn_1x_dota_le90.py')
ORCNN_TINY = osp.join(CONFIGS, 'oriented_rcnn', 'oriented_rcnn_tiny_synth.py')
ROI_TRANS_TINY = osp.join(CONFIGS, 'roi_trans', 'roi_trans_tiny_synth.py')
ADAMW = dict(type='AdamW', betas=(0.9, 0.999), weight_decay=0.05)


def random_variables(shapes, seed):
    """numpy values in the flax tree's shapes: norm scales and variances
    about 1, weights (and steerable coefficients) scaled by their fan-in."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if path[-1].key in ('scale', 'var'):
            v = rng.uniform(0.5, 1.5, leaf.shape)
        elif path[-1].key in ('kernel', 'coeff'):
            v = rng.normal(0, 1 / np.sqrt(np.prod(leaf.shape[:-1])),
                           leaf.shape)
        else:
            v = rng.normal(0, 0.1, leaf.shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def backbone_pair(size, seed, window_size=7):
    """The narrow Swin in both packages on the same weights, and a batch
    of 2 NHWC images of ``size``."""
    jmod = j_swin.SwinTransformer(window_size=window_size, **NARROW)
    images = np.random.default_rng(seed).normal(
        0, 1, (2,) + size + (3,)).astype(np.float32)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                            jnp.asarray(images))
    variables = random_variables(shapes, seed + 1)
    port = SwinTransformer(window_size=window_size, **NARROW)
    port.load_state_dict({
        k[len('backbone.'):]: v for k, v in from_jax_variables(
            {'params': {'backbone': variables['params']}},
            window_size).items()}, strict=True)
    return jmod, variables, port, images


def run_port(port, images):
    with torch.no_grad():
        return [o.permute(0, 2, 3, 1).numpy() for o in
                port(torch.from_numpy(images).permute(0, 3, 1, 2))]


@pytest.mark.parametrize('ws', [2, 3, 4, 7])
def test_window_helpers_match_jax(ws):
    np.testing.assert_array_equal(swin._rel_pos_index(ws),
                                  j_swin._rel_pos_index(ws))
    for h, w in ((ws * 2, ws * 3), (ws * 4, ws)):
        for shift in range(1, ws):
            np.testing.assert_array_equal(
                swin._shift_mask(h, w, ws, shift),
                np.asarray(j_swin._shift_mask(h, w, ws, shift)))
    # a smaller window reads the central block of a 7-window table
    big = swin._rel_pos_index(ws, 7)
    offsets = big // 13 - 6, big % 13 - 6
    small = j_swin._rel_pos_index(ws)
    np.testing.assert_array_equal(offsets[0], small // (2 * ws - 1) - ws + 1)
    np.testing.assert_array_equal(offsets[1], small % (2 * ws - 1) - ws + 1)


@pytest.mark.parametrize('size,shrunk', [((128, 128), {3: (4, 3)}),
                                         ((90, 70), {2: (5, 3), 3: (3, 0)})])
def test_backbone_matches_jax(size, shrunk):
    """``shrunk``: stage -> (window, shift) where the window is below 7."""
    jmod, variables, port, images = backbone_pair(size, 1)
    ref = jax.jit(jmod.apply)(variables, jnp.asarray(images))
    got = run_port(port, images)
    for i, stage in enumerate(port.stages):
        h, w = got[i].shape[1:3]
        ws = min(7, h, w)
        if i in shrunk:
            block = stage.blocks[1]
            assert (ws, block.shift if 0 < block.shift < ws else 0) == \
                shrunk[i]
        else:
            assert ws == 7
        table = variables['params'][f'stage{i}_block0']['attn'][
            'rel_pos_bias']
        assert table.shape[0] == (2 * ws - 1) ** 2
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=1e-5 * np.abs(r).max())


def test_patch_merging_takes_the_permuted_jax_tensors():
    """The merge's 4C axis: mmdet's ``c * 4 + tap`` in the port, ``tap * C
    + c`` in the JAX package. Carried unpermuted, the outputs after the
    first merge part from the JAX package's."""
    jmod, variables, port, images = backbone_pair((64, 64), 3)
    ref = [np.asarray(r) for r in jax.jit(jmod.apply)(
        variables, jnp.asarray(images))]
    merge = variables['params']['merge_norm_1']['scale']
    loaded = port.stages[0].downsample.norm.weight.detach().numpy()
    assert not np.array_equal(loaded, merge)
    np.testing.assert_array_equal(np.sort(loaded), np.sort(merge))
    got = run_port(port, images)
    np.testing.assert_allclose(got[1], ref[1], rtol=0,
                               atol=1e-5 * np.abs(ref[1]).max())
    with torch.no_grad():
        down = port.stages[0].downsample
        down.norm.weight.copy_(torch.from_numpy(merge))
        down.norm.bias.copy_(torch.from_numpy(np.asarray(
            variables['params']['merge_norm_1']['bias'])))
        down.reduction.weight.copy_(torch.from_numpy(np.asarray(
            variables['params']['merge_reduce_1']['kernel']).T))
    wrong = run_port(port, images)
    np.testing.assert_array_equal(wrong[0], got[0])
    assert np.abs(wrong[1] - ref[1]).max() > 0.1 * np.abs(ref[1]).max()


@pytest.mark.parametrize('window_size', [4, 7])
def test_weights_round_trip(window_size):
    """At 128 px a window of 4 never shrinks; a window of 7 does at stage
    3, whose 49-row JAX table comes back through the template."""
    _, variables, port, _ = backbone_pair((128, 128), 5, window_size)
    state = {'backbone.' + k: v for k, v in port.state_dict().items()}
    table = state['backbone.stages.3.blocks.0.attn.w_msa.'
                  'relative_position_bias_table']
    assert table.shape[0] == (2 * window_size - 1) ** 2
    tree = {'params': {'backbone': variables['params']}}
    back = to_jax_layout(state, tree if window_size == 7 else None)
    got, ref = dict(leaves(back)), dict(leaves(tree))
    assert sorted(got) == sorted(ref)
    for name, v in ref.items():
        np.testing.assert_array_equal(got[name], v, err_msg=name)


def narrow_model(path, tiny):
    """The published Swin config's backbone at 16 embedding dims and
    depths 2, in the ``tiny`` config's model (its 64-wide FPN and heads, 2
    classes, its proposal counts)."""
    model = copy.deepcopy(dict(Config.fromfile(tiny).model))
    backbone = Config.fromfile(path).model['backbone']
    assert backbone['type'] == 'SwinTransformer'
    model['backbone'] = dict(backbone, **NARROW)
    model['neck'] = dict(model['neck'], in_channels=[16, 32, 64, 128])
    return model


@pytest.fixture(scope='module')
def orcnn():
    return Family(ORCNN, 30, model=narrow_model(ORCNN, ORCNN_TINY),
                  opt_config=ADAMW)


def test_orcnn_weights_round_trip(orcnn):
    """The carry both ways, and the trainable set at ``frozen_stages=1``:
    all of it in both packages (the JAX mask's names are not Swin's)."""
    orcnn.check_weights()
    detector = orcnn.detector()
    assert type(detector.backbone).__name__ == 'SwinTransformer'
    assert all(frozen_mask(detector, 1).values())
    assert all(jax.tree_util.tree_leaves(
        j_ts.frozen_mask(orcnn.variables['params'], 1)))


def test_orcnn_serving_matches_jax(orcnn):
    orcnn.check_serving()


def test_orcnn_step0_losses_and_gradients_match_jax(orcnn, jax_draws):
    orcnn.check_step0(['loss_rpn_cls', 'loss_rpn_bbox', 'loss_cls',
                       'loss_bbox'])


def check_adam_params(after, ref, grads, lr):
    """Parameters after one AdamW step against the JAX package's (flax
    layout, ``{path: array}``): each element within 1e-5 where the JAX
    gradient is at least 1e-4 of its tensor's largest, and within ``lr``
    elsewhere; those are under 5% of the elements. Adam's first step moves
    an element by ``lr * g / (|g| + 1e-8)``, so where ``g`` is as small as
    the two packages' float32 rounding of it (2e-5 of the tensor's largest
    seen), the step's size and sign are the rounding's."""
    assert sorted(after) == sorted(ref)
    held = small = 0
    for name, v in after.items():
        g = np.abs(grads[name])
        firm = g >= 1e-4 * g.max()
        np.testing.assert_allclose(v[firm], ref[name][firm], rtol=0,
                                   atol=1e-5, err_msg=name)
        assert (np.abs(v - ref[name])[~firm] <= lr).all(), name
        held, small = held + firm.sum(), small + (~firm).sum()
    assert small < 0.05 * held


def test_adamw_step_matches_jax(orcnn, jax_draws):
    """One AdamW step (weight decay 0.05 on every parameter, an active
    clip) through ``make_train_step``: the metrics at rtol 1e-4, the
    parameters as :func:`check_adam_params` holds them. The key third of
    each ``qkv`` bias has a gradient of 0 in exact arithmetic (softmax
    does not see a bias shared by a query's keys), rounding in both
    packages."""
    detector, tx, state = orcnn.port_state()
    state, metrics = make_train_step(detector, tx)(
        state, to_torch(orcnn.batch))
    for k, v in metrics.items():
        if k != 'grad_norm':
            np.testing.assert_allclose(float(v), orcnn.j_metrics[k],
                                       rtol=1e-4, err_msg=k)
    assert float(metrics['grad_norm']) > CLIP['max_norm']
    grads = dict(leaves(orcnn.j_grads))
    largest = max(np.abs(g).max() for g in grads.values())
    biases = [n for n in grads if n.endswith('attn/qkv/bias')]
    assert len(biases) == 8                       # one in each block
    for name in biases:
        third = grads[name].shape[0] // 3
        assert np.abs(grads[name][third:2 * third]).max() < 1e-6 * largest
    check_adam_params(
        dict(leaves(to_jax_layout(detector.state_dict(),
                                  orcnn.variables)['params'])),
        dict(leaves(orcnn.j_params_after)), grads, BASE_LR)


def test_roi_trans_serving_matches_jax():
    family = Family(ROI_TRANS, 40,
                    model=narrow_model(ROI_TRANS, ROI_TRANS_TINY))
    family.check_weights()
    outputs = family.check_serving()
    assert 'roi_outputs' in outputs
