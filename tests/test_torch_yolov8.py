"""Port parity, the YOLOv8 stack: both PAFPNs, ``OBBLabelAssigner`` on gts
whose assignment is decided, the YOLOv8 head (with DFL, and the Angle
head): forward, loss and ``get_bboxes``.

Small sizes: 4 classes, 128 px, G = 6 padded gts
with 4 valid. Weights are carried from the JAX package by
``utils/jax_weights.py:mirror_from_jax``. Tolerances are stated at each
comparison."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orientedobjectdetection_tpu.models.necks import pafpn as j_pafpn
from orientedobjectdetection_tpu.utils.registry import HEADS as J_HEADS
from orientedobjectdetection_torch.models.necks.pafpn import (YOLOv8PAFPN,
                                                              YOLOv8PAFPN_E)
from orientedobjectdetection_torch.utils.jax_weights import mirror_from_jax
from orientedobjectdetection_torch.utils.registry import HEADS
from test_torch_cspnext import assert_close, fill_variables

torch.set_num_threads(1)

SIZE = 128
STRIDES = [8, 16, 32]
WIDTHS = [16, 32, 48]            # the features the head is fed
MARGIN = 1e-4                    # a decided assignment's least gap


# ---- necks ----------------------------------------------------------------
NECKS = {
    'pafpn': (lambda: j_pafpn.YOLOv8PAFPN(in_channels=[256, 512, 768],
                                          out_channels=[256, 512, 768],
                                          deepen_factor=0.33,
                                          widen_factor=0.125),
              lambda: YOLOv8PAFPN(in_channels=[256, 512, 768],
                                  out_channels=[256, 512, 768],
                                  deepen_factor=0.33, widen_factor=0.125,
                                  feat_widths=[24, 40, 56])),
    'pafpn_e': (lambda: j_pafpn.YOLOv8PAFPN_E(
        in_channels=[256, 512, 768], out_channels=[256, 512, 768],
        deepen_factor=0.33, widen_factor=0.125,
        expanded_down_feat_channels=[1024]),
        lambda: YOLOv8PAFPN_E(
            in_channels=[256, 512, 768], out_channels=[256, 512, 768],
            deepen_factor=0.33, widen_factor=0.125, feat_widths=[24, 40, 56],
            expanded_down_feat_channels=[1024])),
    'pafpn_e_two_extra': (lambda: j_pafpn.YOLOv8PAFPN_E(
        in_channels=[64, 128, 256], out_channels=64, deepen_factor=0.33,
        widen_factor=0.25, num_extra_levels=2),
        lambda: YOLOv8PAFPN_E(
            in_channels=[64, 128, 256], out_channels=64, deepen_factor=0.33,
            widen_factor=0.25, feat_widths=[24, 40, 56],
            num_extra_levels=2)),
}


@pytest.mark.parametrize('name', sorted(NECKS))
def test_neck_matches_jax(name):
    """Every level within 1e-5 of its largest magnitude; the widths the
    port announces are the widths it returns."""
    make_jax, make_port = NECKS[name]
    rng = np.random.default_rng(len(name))
    feats = [rng.normal(0, 1, (2, 32 // 2 ** i, 32 // 2 ** i, c)).astype(
        np.float32) for i, c in enumerate([24, 40, 56])]
    jneck, pneck = make_jax(), make_port()
    shapes = jax.eval_shape(jneck.init, jax.random.PRNGKey(0),
                            [jnp.asarray(f) for f in feats])
    variables = fill_variables(shapes, rng)
    ref = jax.jit(jneck.apply)(variables, [jnp.asarray(f) for f in feats])
    pneck.load_state_dict(mirror_from_jax(variables), strict=True)
    with torch.no_grad():
        got = pneck([torch.from_numpy(f).permute(0, 3, 1, 2).contiguous()
                     for f in feats])
    assert len(ref) == len(got) == len(pneck.out_widths)
    for i, (r, g) in enumerate(zip(ref, got)):
        assert g.shape[1] == pneck.out_widths[i]
        assert_close(np.transpose(np.asarray(r), (0, 3, 1, 2)), g,
                     f'{name} level {i}')


# ---- head, assigner ---------------------------------------------------------
def head_cfg(kind='RotatedYOLOv8Head', reg_max=0, classes=4, topk=6):
    cfg = dict(type=kind, num_classes=classes, in_channels=[256, 512, 768],
               widen_factor=0.25, reg_max=reg_max, featmap_strides=STRIDES,
               regress_ranges=((-1, 48), (48, 96), (96, 192)),
               bbox_coder=dict(type='DistanceAnglePointCoder',
                               angle_version='le90'),
               train_cfg=dict(assigner=dict(type='OBBLabelAssigner',
                                            num_classes=classes, topk=topk)),
               test_cfg=dict(nms_pre=300, score_thr=0.05,
                             nms=dict(iou_thr=0.1), max_per_img=60,
                             max_candidates=300))
    if kind in ('RotatedMSDCNHead', 'RotatedDecoupledObjHead',
                'RotatedDecoupledBGHead', 'RotatedDecoupled1x1ObjHead'):
        cfg.pop('reg_max')
    return cfg


def head_feats(rng, size=SIZE):
    return [rng.normal(0, 1, (2, size // s, size // s, c)).astype(np.float32)
            for s, c in zip(STRIDES, WIDTHS)]


def random_gts(rng, bsz=2, g=6, valid=4, classes=4, size=SIZE):
    obb = np.stack([rng.uniform(16, size - 16, (bsz, g)),
                    rng.uniform(16, size - 16, (bsz, g)),
                    rng.uniform(10, 70, (bsz, g)),
                    rng.uniform(10, 70, (bsz, g)),
                    rng.uniform(-1.4, 1.4, (bsz, g))], -1).astype(np.float32)
    mask = np.arange(g)[None].repeat(bsz, 0) < valid
    obb[~mask] = 0
    labels = rng.integers(0, classes, (bsz, g)).astype(np.int32)
    return obb, labels, mask


def decided(head, outputs, gts, margin=MARGIN) -> bool:
    """Whether the assignment of these gts is decided on ``outputs`` with a
    ``margin``: each valid gt's k-th and (k+1)-th positive costs, and its
    best and second-best centerness, differ by more; the valid gts' best
    points are distinct and not point 0 (the padded gts' best); no gate
    (inside, centre radius, regress range) is that close to its edge, in
    float64."""
    gt_bboxes, gt_labels, gt_mask = (torch.as_tensor(v) for v in gts)
    cls, box, ang = head._flat(outputs)
    points, strides, ranges = head.flat_points(
        [tuple(s.shape[-2:]) for s in outputs[0]], 'cpu')
    t = head.assigner.cost(points, strides, ranges, gt_bboxes, gt_labels,
                           gt_mask, box, ang, cls)
    k = head.assigner.topk
    cost = t['cost'].transpose(1, 2).sort(-1, descending=True)[0]
    kth, nxt = cost[..., k - 1], cost[..., k]
    if ((kth > 0) & (nxt > 0) & (kth - nxt <= margin))[gt_mask].any():
        return False
    ctr = t['centerness'].transpose(1, 2)
    top2, best = ctr.topk(2, -1)
    if ((top2[..., 0] - top2[..., 1]) <= margin)[gt_mask].any():
        return False
    for b in range(gt_mask.shape[0]):
        pts = best[b, :, 0][gt_mask[b]]
        if len(set(pts.tolist())) < len(pts) or (pts == 0).any():
            return False
    g = gt_bboxes.double()[:, None]
    p = points.double()
    dx = p[None, :, 0, None] - g[..., 0]
    dy = p[None, :, 1, None] - g[..., 1]
    ox = dx * torch.cos(g[..., 4]) + dy * torch.sin(g[..., 4])
    oy = -dx * torch.sin(g[..., 4]) + dy * torch.cos(g[..., 4])
    sides = torch.stack([g[..., 2] / 2 + ox, g[..., 3] / 2 + oy,
                         g[..., 2] / 2 - ox, g[..., 3] / 2 - oy], -1)
    radius = 1.5 * strides.double()[None, :, None]
    max_reg = sides.amax(-1)
    edges = torch.stack([sides.amin(-1), ox.abs() - radius,
                         oy.abs() - radius,
                         max_reg - ranges.double()[None, :, 0, None],
                         max_reg - ranges.double()[None, :, 1, None]], -1)
    return not (edges.abs() <= 1e-3).any(-1)[gt_mask[:, None, :].expand(
        -1, edges.shape[1], -1)].any()


def jax_head(cfg):
    cfg = dict(cfg)
    return J_HEADS.build(cfg)


def port_head(cfg):
    return HEADS.build(dict(cfg, feat_widths=WIDTHS))


def to_port(outputs):
    return tuple(tuple(torch.from_numpy(np.array(m)).permute(0, 3, 1, 2)
                       for m in level) for level in outputs)


def make_head_case(kind, reg_max=0):
    """A head of ``kind`` with carried weights (the class bias 0, so the
    decode keeps boxes; without DFL the regression bias 1, the JAX
    package's initializer, so that no side is clipped to exactly 0, where
    the IoU loss's gradient turns on rounding: ROADMAP C), its JAX and port
    outputs on the same features, and gts whose assignment is decided."""
    cfg = head_cfg(kind, reg_max)
    rng = np.random.default_rng(40 + reg_max + len(kind))
    jhead, phead = jax_head(cfg), port_head(cfg)
    feats = head_feats(rng)
    shapes = jax.eval_shape(jhead.init, jax.random.PRNGKey(0),
                            [jnp.asarray(f) for f in feats])
    variables = fill_variables(shapes, rng)
    bias = {'cls_pred': 0.0, 'fg_pred': 0.0}
    if reg_max <= 1:
        bias['reg_pred'] = 1.0
    variables['params'] = {
        k: ({**v, 'bias': np.full_like(v['bias'], bias[k.rsplit('_', 1)[0]])}
            if k.rsplit('_', 1)[0] in bias else v)
        for k, v in variables['params'].items()}
    jout = jax.jit(jhead.apply)(variables, [jnp.asarray(f) for f in feats])
    phead.load_state_dict(mirror_from_jax(variables), strict=True)
    with torch.no_grad():
        pout = phead([torch.from_numpy(f).permute(0, 3, 1, 2).contiguous()
                      for f in feats])
    for _ in range(50):
        gts = random_gts(rng)
        if decided(phead, pout, gts):
            break
    else:
        raise AssertionError('no decided draw of gts')
    return dict(cfg=cfg, jhead=jhead, phead=phead, jout=jout, pout=pout,
                gts=gts)


@pytest.fixture(scope='module', params=[
    ('RotatedYOLOv8Head', 0), ('RotatedYOLOv8Head', 8),
    ('RotatedYOLOv8AngleHead', 0)], ids=['yolov8', 'dfl', 'angle'])
def head_case(request):
    return make_head_case(*request.param)


def test_head_forward_matches_jax(head_case):
    """Every output map within 1e-5 of its largest magnitude; DFL's
    regression is the float32 expectation over 1 + reg_max bins."""
    assert len(head_case['jout']) == len(head_case['pout'])
    for name, ref, got in zip(('cls', 'box', 'angle', 'obj'),
                              head_case['jout'], head_case['pout']):
        assert len(ref) == len(got) == 3
        for r, g in zip(ref, got):
            assert_close(np.transpose(np.asarray(r), (0, 3, 1, 2)), g, name)
    assert all(b.dtype == torch.float32 for b in head_case['pout'][1])


def test_assigner_matches_jax(head_case):
    """Labels, positives and angle targets equal; the stride-normalized
    (l, t, r, b) targets within 1e-5 px of a stride."""
    jhead, phead = head_case['jhead'], head_case['phead']
    gts = head_case['gts']
    cls_flat, box_flat, ang_flat = jhead._flat(head_case['jout'][:3])
    pts, strides, ranges = jhead._points([s.shape[1:3] for s in
                                          head_case['jout'][0]])
    asg = jhead.assigner
    ref = jax.jit(jax.vmap(
        lambda gb, gl, gm, bp, ap, cs: asg.assign_single(
            pts, strides, ranges, gb, gl, gm, bp, ap, cs)))(
        *(jnp.asarray(v) for v in gts), box_flat, ang_flat, cls_flat)
    got = phead.targets(head_case['pout'], *(torch.from_numpy(v)
                                             for v in gts))
    labels, bt, at, pos = (np.asarray(v) for v in ref)
    assert pos.sum() > 8
    np.testing.assert_array_equal(got[3].numpy(), pos)
    np.testing.assert_array_equal(got[0].numpy(), labels)
    np.testing.assert_allclose(got[1].numpy()[pos], bt[pos], rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(got[2].numpy()[pos], at[pos])


def test_assigner_rematches_orphans_and_shared_points():
    """A gt that no point keeps takes its point of largest centerness; of
    two orphans that share that point, the higher index takes it (the JAX
    package's serial scatter): here two equal gts and one in the gate
    range of no level."""
    from orientedobjectdetection_torch.models.dense_heads import \
        rotated_yolov8_head as yh
    asg = yh.OBBLabelAssigner(num_classes=3, topk=4)
    head = HEADS.build(dict(head_cfg(classes=3), feat_widths=WIDTHS))
    points, strides, ranges = head.flat_points([(4, 4), (2, 2), (1, 1)],
                                               'cpu')
    n = len(points)
    gts = torch.tensor([[[14.0, 14.0, 6.0, 6.0, 0.0],
                         [14.0, 14.0, 6.0, 6.0, 0.0],
                         [16.0, 16.0, 2.0, 2.0, 0.3]]])
    labels = torch.tensor([[0, 1, 2]])
    mask = torch.ones(1, 3, dtype=torch.bool)
    box = torch.ones(1, n, 4)
    ang = torch.zeros(1, n, 1)
    cls = torch.zeros(1, n, 3)
    got_labels, _, _, pos = asg.assign(points, strides, ranges, gts, labels,
                                       mask, box, ang, cls)
    ref = jax.jit(jax.vmap(lambda gb, gl, gm, bp, ap, cs: J_HEADS.build(
        dict(head_cfg(classes=3))).assigner.assign_single(
        jnp.asarray(points.numpy()), jnp.asarray(strides.numpy()),
        jnp.asarray(ranges.numpy()), gb, gl, gm, bp, ap, cs)))(
        *(jnp.asarray(v.numpy()) for v in (gts, labels, mask, box, ang,
                                            cls)))
    np.testing.assert_array_equal(got_labels.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(ref[3]))
    assert int(pos.sum()) >= 1


def test_head_loss_matches_jax(head_case):
    """Every loss term within rtol 1e-5 (float32 sums over 336 points)."""
    jhead, phead = head_case['jhead'], head_case['phead']
    gts = head_case['gts']
    ref = jax.jit(lambda o, *g: jhead.loss(o, *g))(
        head_case['jout'], *(jnp.asarray(v) for v in gts))
    got = phead.loss(head_case['pout'], *(torch.from_numpy(v) for v in gts))
    assert sorted(ref) == sorted(got)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5,
                                   err_msg=k)
        assert float(ref[k]) > 0, k


def test_head_loss_gradient_matches_jax(head_case):
    """The loss's gradient at every output map within 1e-4 of the largest
    gradient of that output (over its levels: a level whose points are all
    negatives has gradients at rounding size)."""
    jhead, phead = head_case['jhead'], head_case['phead']
    gts = head_case['gts']

    def total(o):
        return sum(jhead.loss(o, *(jnp.asarray(v) for v in gts)).values())

    ref = jax.jit(jax.grad(total))(head_case['jout'])
    outs = tuple(tuple(m.clone().requires_grad_(True) for m in level)
                 for level in head_case['pout'])
    sum(phead.loss(outs, *(torch.from_numpy(v) for v in gts)).values()
        ).backward()
    for r_level, g_level in zip(ref, outs):
        largest = max(float(np.abs(np.asarray(r)).max()) for r in r_level)
        assert largest > 0
        for r, g in zip(r_level, g_level):
            r = np.transpose(np.asarray(r), (0, 3, 1, 2))
            np.testing.assert_allclose(g.grad.numpy(), r, rtol=0,
                                       atol=1e-4 * largest)


def test_get_bboxes_matches_jax(head_case):
    """Labels and valid flags equal, detections within 1e-4 (scores) and
    1e-3 px (boxes)."""
    jhead, phead = head_case['jhead'], head_case['phead']
    ref = jax.jit(lambda o: jhead.get_bboxes(o))(head_case['jout'])
    got = phead.get_bboxes(head_case['pout'])
    dets, labels, valid = (np.asarray(v) for v in ref)
    assert valid.sum() > 10
    np.testing.assert_array_equal(got[2].numpy(), valid)
    np.testing.assert_array_equal(got[1].numpy(), labels)
    np.testing.assert_allclose(got[0].numpy(), dets, rtol=0, atol=1e-3)
