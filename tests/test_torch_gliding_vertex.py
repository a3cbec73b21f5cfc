"""Port parity, Gliding Vertex
(``configs/gliding_vertex/gliding_vertex_tiny_synth.py``: R18, 64-wide
FPN, 2 classes, at 128 px) against the JAX package on the same random
weights: the weight mapping (``fc_fix``, ``fc_ratio``), ``GVBBoxHead``,
``GVRatioRoIHead``'s sampling (the JAX draws swapped in), its fixed losses
and its decode (box deltas, gliding polygon, ``poly2obb``, the ratio
switch), the served detections, and one train step's losses, gradients and
parameter update (:class:`test_torch_rotated_rpn.Family`).

Tolerances: head outputs 1e-4 (float32 FC layers on the same pooled
features); sampled labels and weights exact, RoIs and targets 1e-5;
losses rtol 1e-5; detections 1e-4 on the same head outputs; the rest as
the harness states.
"""

import os.path as osp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orientedobjectdetection_torch.core.assigners import SampleKey
from test_torch_rotated_faster_rcnn import random_props
from test_torch_rotated_rpn import CONFIGS, SIZE, Family, j_rng
from test_torch_rotated_rpn import jax_draws  # noqa: F401 (a fixture)
from test_torch_two_stage_train import to_torch

torch.set_num_threads(1)

TINY = osp.join(CONFIGS, 'gliding_vertex', 'gliding_vertex_tiny_synth.py')


@pytest.fixture(scope='module')
def family():
    return Family(TINY, 70)


def test_weights_round_trip(family):
    family.check_weights()
    assert family.state['roi_head.bbox_head.fc_fix.weight'].shape == (4, 256)
    assert family.state['roi_head.bbox_head.fc_ratio.bias'].shape == (1,)


def test_bbox_head_matches_jax(family):
    rng = np.random.default_rng(71)
    pooled = rng.normal(0, 1, (2, 30, 7, 7, 64)).astype(np.float32)
    head = family.jax_head('roi_head', 'rcnn').make_bbox_head()
    ref = jax.jit(head.apply)(
        {'params': family.variables['params']['roi_head']['bbox_head']},
        jnp.asarray(pooled))
    with torch.no_grad():
        got = family.detector().roi_head.bbox_head(torch.from_numpy(pooled))
    assert [tuple(g.shape) for g in got] == [(2, 30, 3), (2, 30, 4),
                                             (2, 30, 4), (2, 30, 1)]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4)


def test_sample_rois_matches_jax(family, jax_draws):
    """The gts' circumscribed xyxy boxes first among the proposals; box,
    gliding and ratio targets against the matched rotated gts."""
    gts = family.batch['gt_bboxes']
    props, valid = random_props(gts, 72)
    jroi = family.jax_head('roi_head', 'rcnn')
    ref = jax.jit(jroi.sample_rois)(
        jnp.asarray(props), jnp.asarray(valid), jnp.asarray(gts),
        jnp.asarray(family.batch['gt_labels']),
        jnp.asarray(family.batch['gt_mask']), j_rng(5))
    tb = to_torch(family.batch)
    got = family.detector().roi_head.sample_rois(
        torch.from_numpy(props), torch.from_numpy(valid), tb['gt_bboxes'],
        tb['gt_labels'], tb['gt_mask'], SampleKey(step=5))
    assert got[0].shape == (2, 128, 4) and len(got) == len(ref) == 8
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    for i in (0, 3, 4, 5):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref[i]),
                                   rtol=1e-5, atol=1e-5, err_msg=str(i))
    for i in (2, 6, 7):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref[i]))
    assert 0 < float(got[7]) <= 64
    fix, ratio = got[4][got[6] > 0], got[5][got[6] > 0]
    assert ((fix >= 0) & (fix <= 1)).all() and (ratio <= 1 + 1e-6).all()


def test_loss_matches_jax(family):
    """The fixed losses (cross entropy; smooth L1 with beta 1 on deltas,
    offsets and ratio, the last x 16) on random outputs and targets."""
    rng = np.random.default_rng(73)
    b, r = 2, 40
    outputs = (rng.normal(0, 2, (b, r, 3)), rng.normal(0, 1, (b, r, 4)),
               rng.uniform(0, 1, (b, r, 4)), rng.uniform(0, 1, (b, r, 1)))
    labels = rng.integers(0, 3, (b, r))
    lw = (rng.uniform(size=(b, r)) < 0.9).astype(np.float32)
    bw = ((labels < 2) & (lw > 0)).astype(np.float32)
    targets = (np.zeros((b, r, 4)), labels, lw,
               rng.normal(0, 1, (b, r, 4)) * bw[..., None],
               rng.uniform(0, 1, (b, r, 4)) * bw[..., None],
               rng.uniform(0, 1, (b, r, 1)) * bw[..., None], bw,
               np.float32(max(bw.sum(), 1)))

    def f32(x):
        x = np.asarray(x)
        return x.astype(np.float32) if x.dtype.kind == 'f' else x

    ref = family.jax_head('roi_head', 'rcnn').loss(
        tuple(jnp.asarray(f32(x)) for x in outputs),
        tuple(jnp.asarray(f32(x)) for x in targets))
    got = family.detector().roi_head.loss(
        tuple(torch.from_numpy(f32(x)) for x in outputs),
        tuple(torch.as_tensor(f32(x)) for x in targets))
    assert sorted(got) == ['loss_bbox', 'loss_cls', 'loss_fix', 'loss_ratio']
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5,
                                   err_msg=k)


def test_get_bboxes_matches_jax(family):
    """Decode and NMS on the same head outputs: half the RoIs above the
    ratio threshold keep their horizontal box."""
    rng = np.random.default_rng(74)
    x1 = rng.uniform(0, SIZE - 40, (2, 120, 2))
    rois = np.concatenate([x1, x1 + rng.uniform(4, 40, x1.shape)],
                          -1).astype(np.float32)
    rois[:, -10:] = 0.0
    outputs = (rng.normal(0, 2, (2, 120, 3)), rng.normal(0, 0.5, (2, 120, 4)),
               rng.uniform(0.05, 0.95, (2, 120, 4)),
               rng.uniform(0.6, 1.0, (2, 120, 1)))
    outputs = tuple(x.astype(np.float32) for x in outputs)
    cfg = dict(family.jcfg.model['test_cfg']['rcnn'])
    jroi = family.jax_head('roi_head', 'rcnn')
    r_dets, r_labels, r_valid = jax.jit(
        lambda a, o: jroi.get_bboxes(a, o, cfg=cfg))(
        jnp.asarray(rois), tuple(map(jnp.asarray, outputs)))
    roi_head = family.detector().roi_head
    dets, labels, valid = roi_head.get_bboxes(
        torch.from_numpy(rois), tuple(map(torch.from_numpy, outputs)),
        cfg=cfg)
    assert 10 < np.asarray(r_valid).sum(1).min()
    np.testing.assert_array_equal(valid.numpy(), np.asarray(r_valid))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(r_labels))
    np.testing.assert_allclose(dets.numpy(), np.asarray(r_dets), atol=1e-4)
    boxes, _ = roi_head.decode(torch.from_numpy(rois),
                               tuple(map(torch.from_numpy, outputs)))
    rect = torch.from_numpy(outputs[3][..., 0] > 0.8)
    assert 50 < rect.sum() < 190
    assert (boxes[rect][:, 4] == 0).all() and (boxes[~rect][:, 4] != 0).any()


def test_serving_matches_jax(family):
    outputs = family.check_serving()
    assert outputs['proposals'].shape == (2, 256, 4)
    assert len(outputs['head_outputs']) == 4


def test_train_step_losses_and_gradients_match_jax(family, jax_draws):
    outputs = family.check_step0(['loss_rpn_cls', 'loss_rpn_bbox',
                                  'loss_cls', 'loss_bbox', 'loss_fix',
                                  'loss_ratio'])
    ref = family.j_outputs['targets']
    np.testing.assert_array_equal(outputs['targets'][1].numpy(),
                                  np.asarray(ref[1]))
    np.testing.assert_allclose(outputs['targets'][0].numpy(),
                               np.asarray(ref[0]), rtol=1e-4, atol=1e-3)
    assert float(family.j_losses['loss_fix']) > 0


def test_make_train_step_matches_jax(family, jax_draws):
    family.check_train_step()
