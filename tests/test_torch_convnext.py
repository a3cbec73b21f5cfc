"""Port parity, the ConvNeXt backbone against the JAX package on the same
random weights (carried by ``from_jax_variables``), and the ConvNeXt
KLD-stable RetinaNet
(``configs/convnext/rotated_retinanet_obb_kld_stable_convnext_adamw_fpn_1x
_dota_le90.py``):

- the backbone's four outputs at 64 x 64 px and at 66 x 62 px, where the
  stem's and the downsamples' ``'SAME'`` padding adds rows and columns;
- the carry both ways;
- the detector cut narrow (a ``narrow`` arch of dims 16 / 32 / 48 / 64 and
  depths 1 / 1 / 2 / 1, added to both packages' ``ARCHS`` for the test;
  one stacked conv, 32-wide FPN and head, 4 classes, 128 px): one AdamW
  step through ``make_train_step`` against the JAX package's jitted step.

Tolerances: backbone outputs 1e-5 of each map's largest value (float32,
other summation orders); losses rtol 1e-4; the parameters after the AdamW
step as ``test_torch_swin.check_adam_params`` says (1e-5 where the
gradient is not at its rounding).
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orientedobjectdetection_tpu.models import build_detector as j_build
from orientedobjectdetection_tpu.models.backbones import convnext as j_cnx
from orientedobjectdetection_tpu.parallel import train_state as j_ts
from orientedobjectdetection_torch.models import build_detector
from orientedobjectdetection_torch.models.backbones import ConvNeXt
from orientedobjectdetection_torch.models.backbones import convnext
from orientedobjectdetection_torch.parallel import (build_optimizer,
                                                    create_train_state,
                                                    frozen_mask,
                                                    make_train_step)
from orientedobjectdetection_torch.utils import Config
from orientedobjectdetection_torch.utils.jax_weights import (
    from_jax_variables, to_jax_layout)
from test_torch_retina_variants import SIZE, anchor_gts, fill_variables
from test_torch_swin import check_adam_params, random_variables
from test_torch_two_stage_train import leaves

torch.set_num_threads(1)

CONFIG = ('configs/convnext/'
          'rotated_retinanet_obb_kld_stable_convnext_adamw_fpn_1x_dota_le90'
          '.py')
NARROW = dict(depths=(1, 1, 2, 1), dims=(16, 32, 48, 64))
ADAMW = dict(type='AdamW', betas=(0.9, 0.999), weight_decay=0.05)
LR = 1e-3


@pytest.fixture(scope='module', autouse=True)
def narrow_arch():
    with pytest.MonkeyPatch.context() as mp:
        for archs in (j_cnx.ARCHS, convnext.ARCHS):
            mp.setitem(archs, 'narrow', NARROW)
        yield


def backbone_pair(size, seed):
    jmod = j_cnx.ConvNeXt(arch='narrow', layer_scale_init_value=1.0)
    images = np.random.default_rng(seed).normal(
        0, 1, (2,) + size + (3,)).astype(np.float32)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                            jnp.asarray(images))
    variables = random_variables(shapes, seed + 1)
    port = ConvNeXt(arch='narrow', layer_scale_init_value=1.0)
    port.load_state_dict({
        k[len('backbone.'):]: v for k, v in from_jax_variables(
            {'params': {'backbone': variables['params']}}).items()},
        strict=True)
    return jmod, variables, port, images


@pytest.mark.parametrize('size,padded', [((64, 64), False),
                                         ((66, 62), True)])
def test_backbone_matches_jax(size, padded):
    jmod, variables, port, images = backbone_pair(size, 1)
    ref = jax.jit(jmod.apply)(variables, jnp.asarray(images))
    with torch.no_grad():
        got = port(torch.from_numpy(images).permute(0, 3, 1, 2))
    assert [tuple(g.shape[2:]) for g in got] == [
        tuple(-(-s // 2 ** (i + 2)) for s in size) for i in range(4)]
    assert padded == any(s % 32 for s in size)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert g.is_contiguous()
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), r, rtol=0,
                                   atol=1e-5 * np.abs(r).max())


def test_weights_round_trip():
    _, variables, port, _ = backbone_pair((64, 64), 3)
    tree = {'params': {'backbone': variables['params']}}
    back = to_jax_layout({'backbone.' + k: v
                          for k, v in port.state_dict().items()})
    got, ref = dict(leaves(back)), dict(leaves(tree))
    assert sorted(got) == sorted(ref)
    for name, v in ref.items():
        np.testing.assert_array_equal(got[name], v, err_msg=name)


def small_model():
    """The published model config at the narrow arch, a 32-wide FPN and
    head with one stacked conv, and 4 classes."""
    model = copy.deepcopy(dict(Config.fromfile(CONFIG).model))
    assert model['backbone']['type'] == 'ConvNeXt'
    model['backbone'] = dict(model['backbone'], arch='narrow')
    model['neck'] = dict(model['neck'], in_channels=list(NARROW['dims']),
                         out_channels=32)
    model['bbox_head'] = dict(model['bbox_head'], num_classes=4,
                              in_channels=32, feat_channels=32,
                              stacked_convs=1)
    return model


def test_adamw_step_matches_jax():
    """One AdamW step (weight decay 0.05, an active clip) of the whole
    detector: losses at rtol 1e-4, every parameter trainable in both
    packages, the parameters as ``check_adam_params`` holds them."""
    cfg = small_model()
    assert cfg['bbox_head']['loss_bbox']['type'] == 'GDLoss'
    det = j_build(cfg)
    rng = np.random.default_rng(5)
    images = rng.normal(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    shapes = jax.eval_shape(det.init, jax.random.PRNGKey(0),
                            jnp.asarray(images))
    variables = fill_variables(shapes, rng)
    gts, labels, mask = anchor_gts(rng, cfg['bbox_head'])
    batch = dict(images=images, gt_bboxes=gts, gt_labels=labels,
                 gt_mask=mask)
    frozen = cfg['backbone'].get('frozen_stages', -1)
    tx = j_ts.build_optimizer(ADAMW, LR, grad_clip=dict(max_norm=1.0),
                              params=variables['params'],
                              frozen_stages=frozen)
    j_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    grads = jax.jit(jax.grad(lambda p: sum(det.loss_from_outputs(
        det.apply({'params': p}, j_batch['images']), j_batch).values())))(
        variables['params'])
    state = j_ts.create_train_state(det, None, None, tx, variables=variables)
    state, ref = jax.jit(j_ts.make_train_step(det, tx))(state, j_batch)

    detector = build_detector(cfg)
    port_tx = build_optimizer(ADAMW, LR, grad_clip=dict(max_norm=1.0),
                              frozen_stages=frozen)
    port_state = create_train_state(detector, port_tx, device='cpu',
                                    state_dict=from_jax_variables(variables))
    # nothing is frozen in either package, even at frozen_stages=1: the
    # JAX mask's names (conv1, bn1, layer{s}_) are not ConvNeXt's
    assert all(frozen_mask(detector, frozen).values())
    assert all(frozen_mask(detector, 1).values())
    assert all(jax.tree_util.tree_leaves(
        j_ts.frozen_mask(variables['params'], 1)))
    port_state, metrics = make_train_step(detector, port_tx)(port_state, {
        k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ('loss_cls', 'loss_bbox', 'loss'):
        np.testing.assert_allclose(float(metrics[k]), float(ref[k]),
                                   rtol=1e-4, err_msg=k)
    assert float(ref['grad_norm']) > 1.0          # the clip is active
    check_adam_params(
        dict(leaves(to_jax_layout(detector.state_dict())['params'])),
        dict(leaves(jax.tree_util.tree_map(np.asarray, state.params))),
        dict(leaves(jax.tree_util.tree_map(np.asarray, grads))), LR)
