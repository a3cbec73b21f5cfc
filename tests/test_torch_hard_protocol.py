"""The synth-hard protocol on the port: crowded-scene parity against the
JAX package, and the port's protocol runner (``tools/hard_protocol.py``)
on the CPU.

Parity, on scenes from the port's generator (15 classes, 100-600 crowded
objects of 8-32 px a 512² scene):

- (a) ``pad_collate`` of scenes whose objects outnumber a reduced
  ``max_gt``: kept gts, the ``gt_ignore`` overflow and the masks equal the
  JAX package's exactly;
- (b) one train step's losses of three hard configs at 128 px (Rotated
  RetinaNet with octave base scale 2 and ``ignore_iof_thr=0.5`` over the
  overflow; Oriented R-CNN with its RPN's 2048 / 1024 and 15 classes;
  RotatedYOLOv8 with ``topk=9``) on random weights carried by
  ``utils/jax_weights.py``, rtol 1e-4 (float32 networks summing in other
  orders), on gts whose assignment is decided and whose overflow lies in
  ``gt_ignore``; the sampler draws are the JAX package's
  (``test_torch_rotated_rpn.jax_draws``);
- (c) RetinaNet's ``get_bboxes`` at the hard ``test_cfg`` (``nms_pre``
  2000, ``iou_thr`` 0.1, ``max_per_img`` 800) on crowded scores: labels
  and valid flags exact, boxes and scores within 1e-3;
- (d) ``eval_rbbox_map`` over 15 classes on a crowded val scene with ~800
  detections: per-class AP, recall and counts within 1e-6, the dets near an
  IoU tie dropped first (``test_torch_eval_map.TIE_BAND``).
"""

import json
import os
import os.path as osp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orientedobjectdetection_tpu.core import eval_map as jax_eval
from orientedobjectdetection_tpu.datasets.loader import \
    pad_collate as jax_pad_collate
from orientedobjectdetection_tpu.models import build_detector as j_build
from orientedobjectdetection_tpu.utils.config import Config as JConfig
from orientedobjectdetection_tpu.utils.registry import HEADS as J_HEADS
from orientedobjectdetection_torch.core import eval_map
from orientedobjectdetection_torch.core.assigners import SampleKey
from orientedobjectdetection_torch.datasets import build_dataset, pad_collate
from orientedobjectdetection_torch.models import build_detector
from orientedobjectdetection_torch.ops.iou import box_iou_rotated
from orientedobjectdetection_torch.ops.iou_kernels import \
    box_iou_rotated_matrix_plain
from orientedobjectdetection_torch.tools import hard_protocol
from orientedobjectdetection_torch.tools.generate_synth import \
    generate_synth_hard
from orientedobjectdetection_torch.utils import Config
from orientedobjectdetection_torch.utils.jax_weights import \
    from_jax_variables
from orientedobjectdetection_torch.utils.registry import HEADS

import chip_smoke
from test_torch_chip_smoke import derived_config
from test_torch_chip_smoke_hard import CUTS, SMALL
from test_torch_cspnext import fill_variables
from test_torch_eval_map import TIE_BAND
from test_torch_rotated_rpn import jax_draws, perturb_variables  # noqa: F401
from test_torch_yolov8 import decided, random_gts

torch.set_num_threads(2)

CONFIGS = osp.join(osp.dirname(__file__), '..', 'configs')
RETINA = osp.join(CONFIGS, 'rotated_retinanet',
                  'rotated_retinanet_hard_synth.py')
ORCNN = osp.join(CONFIGS, 'oriented_rcnn', 'oriented_rcnn_hard_synth.py')
FASTER = osp.join(CONFIGS, 'rotated_faster_rcnn',
                  'rotated_faster_rcnn_hard_synth.py')
YOLOV8 = osp.join(CONFIGS, 'jy', 'rotated_yolov8_hard_synth.py')
SIZE = 128
MAX_GT = 8          # the step's batch: 10 gts an image, 2 overflow
DRAWN = 10
MARGIN = 1e-4       # a decided assignment's least gap


@pytest.fixture(scope='module')
def scenes(tmp_path_factory):
    """Two crowded trainval scenes at seed 0 and one val scene at seed 7,
    512², through the port's DOTA dataset (gts as the loader reads them)."""
    root = str(tmp_path_factory.mktemp('hard'))
    generate_synth_hard(root, 2, 512, seed=0)
    generate_synth_hard(root, 1, 512, seed=7, split='val')
    classes = Config.fromfile(RETINA).classes
    pipeline = [dict(type='LoadImageFromFile'),
                dict(type='LoadAnnotations', with_bbox=True)]
    return {split: build_dataset(dict(
        type='DOTADataset', version='le90', classes=classes,
        ann_file=f'{root}/{split}/annfiles/',
        img_prefix=f'{root}/{split}/images/', pipeline=pipeline))
        for split in ('trainval', 'val')}


# ---- (a) collation ---------------------------------------------------------
def test_crowded_collation_matches_jax(scenes):
    samples = [scenes['trainval'][i] for i in range(2)]
    counts = [len(s['gt_bboxes']) for s in samples]
    max_gt = 64
    assert min(counts) > 2 * max_gt         # both past the ignore slots too
    with pytest.warns(UserWarning, match='max_gt'):
        got = pad_collate(samples, max_gt=max_gt, pad_size=(512, 512))
    with pytest.warns(UserWarning, match='max_gt'):
        ref = jax_pad_collate(samples, max_gt=max_gt, pad_size=(512, 512))
    for key in ('images', 'gt_bboxes', 'gt_labels', 'gt_mask', 'gt_ignore',
                'gt_ignore_mask'):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    assert got['gt_mask'].all() and got['gt_ignore_mask'].all()
    # the largest areas kept, the next ones ignored
    areas = got['gt_bboxes'][..., 2] * got['gt_bboxes'][..., 3]
    ignored = got['gt_ignore'][..., 2] * got['gt_ignore'][..., 3]
    assert (areas.min(1) >= ignored.max(1)).all()


# ---- (b) one train step's losses -------------------------------------------
def pixel_gts(rng, n):
    """Pixel-aligned boxes, angles in 1/64 rad: JAX's ``rng_from_gt`` sums
    them exactly in any order."""
    return np.stack([rng.integers(16, SIZE - 16, n),
                     rng.integers(16, SIZE - 16, n),
                     rng.integers(8, 48, n), rng.integers(8, 48, n),
                     rng.integers(-96, 96, n) / 64.0], -1).astype(np.float32)


def decided_boxes(rng, anchors, thresholds, view=None, iof_thr=None):
    """``DRAWN`` pixel-aligned boxes whose MaxIoU assignment on ``anchors``
    is decided by more than ``MARGIN``: each box's best anchor leads its
    next, no anchor's best IoU lies that close to a threshold, no two boxes
    come that close on an anchor, and (``iof_thr``) no anchor's IoF over a
    box lies that close to the ignore threshold."""
    cands = torch.from_numpy(pixel_gts(rng, 200))
    seen = cands if view is None else view(cands)
    iou = box_iou_rotated_matrix_plain(seen, anchors)
    iof = None if iof_thr is None else box_iou_rotated_matrix_plain(
        anchors, cands, 'iof').T
    best, keep = torch.zeros(len(anchors)), []
    for i, row in enumerate(iou):
        if float(row.topk(2)[0].diff().abs()) <= MARGIN or \
                ((row - best).abs() <= MARGIN)[(row > 0) & (best > 0)].any() \
                or any(((row - t).abs() <= MARGIN)[row > best].any()
                       for t in thresholds) or \
                (iof is not None and ((iof[i] - iof_thr).abs()
                                      <= MARGIN).any()):
            continue
        keep.append(i)
        best = torch.maximum(best, row)
        if len(keep) == DRAWN:
            return cands[keep].numpy()
    raise AssertionError(f'{len(keep)} of {DRAWN} boxes decided')


def collate(images, boxes, labels):
    """The loader's collation of the drawn gts: the ``MAX_GT`` largest kept,
    the rest in ``gt_ignore``."""
    samples = [dict(img=img, gt_bboxes=b, gt_labels=lab)
               for img, b, lab in zip(images, boxes, labels)]
    with pytest.warns(UserWarning, match='max_gt'):
        batch = pad_collate(samples, max_gt=MAX_GT)
    assert batch['gt_ignore_mask'].sum(1).tolist() == [DRAWN - MAX_GT] * 2
    return {k: batch[k] for k in ('images', 'gt_bboxes', 'gt_labels',
                                  'gt_mask', 'gt_ignore', 'gt_ignore_mask')}


def retina_batch(det, rng, images):
    from chip_smoke import head_anchors
    anchors = head_anchors(det.bbox_head, SIZE, 'cpu')[0]
    boxes = [decided_boxes(rng, anchors, (0.4, 0.5), iof_thr=0.5)
             for _ in images]
    return collate(images, boxes, [rng.integers(0, 15, DRAWN)
                                   for _ in images])


def orcnn_batch(det, rng, images):
    anchor_sets, view = chip_smoke.hbb_anchor_view(SIZE, 'cpu', ORCNN)
    boxes = [decided_boxes(rng, anchor_sets[0], (0.3, 0.7), view=view)
             for _ in images]
    return collate(images, boxes, [rng.integers(0, 15, DRAWN)
                                   for _ in images])


def yolo_batch(det, rng, images):
    with torch.no_grad():
        outputs = det(torch.from_numpy(images).permute(0, 3, 1, 2))
    for _ in range(50):
        obb, labels, _ = random_gts(rng, bsz=2, g=DRAWN, valid=DRAWN,
                                    classes=15)
        batch = collate(images, obb, labels)
        if decided(det.bbox_head, outputs, (batch['gt_bboxes'],
                                            batch['gt_labels'],
                                            batch['gt_mask'])):
            return batch
    raise AssertionError('no decided draw of gts')


def yolo_weights(variables):
    """The class bias 0 and the regression bias 1 (the JAX initializer's),
    so that no side is clipped to exactly 0 (``test_torch_yolov8``)."""
    head = variables['params']['bbox_head']
    for name, leaf in head.items():
        kind = name.rsplit('_', 1)[0]
        if kind in ('cls_pred', 'reg_pred'):
            leaf['bias'] = np.full_like(leaf['bias'],
                                        0.0 if kind == 'cls_pred' else 1.0)
    return variables


STEPS = {
    'retinanet': (RETINA, retina_batch, ('loss_cls', 'loss_bbox')),
    'orcnn': (ORCNN, orcnn_batch, ('loss_rpn_cls', 'loss_rpn_bbox',
                                   'loss_cls', 'loss_bbox')),
    'yolov8': (YOLOV8, yolo_batch, None),
}


@pytest.mark.parametrize('label', sorted(STEPS))
def test_hard_step_losses_match_jax(label, jax_draws):  # noqa: F811
    path, make_batch, names = STEPS[label]
    cfg, jcfg = Config.fromfile(path), JConfig.fromfile(path)
    jdet = j_build(dict(jcfg.model))
    shapes = jax.eval_shape(jdet.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, SIZE, SIZE, 3), jnp.float32))
    rng = np.random.default_rng(len(label))
    if label == 'yolov8':
        variables = yolo_weights(fill_variables(shapes, rng))
    else:
        variables = perturb_variables(shapes, len(label))
    if label == 'retinanet':       # the focal prior, where training starts
        head = variables['params']['bbox_head']
        head['cls_out']['bias'][...] = -4.595
    det = build_detector(dict(cfg.model))
    det.load_state_dict(from_jax_variables(variables), strict=True)
    images = rng.normal(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    batch = make_batch(det, rng, images)
    assert det.bbox_head.num_classes == 15 if label != 'orcnn' else \
        det.roi_head.bbox_head.num_classes == 15

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    two_stage = label == 'orcnn'

    def j_loss(v):
        kwargs = dict(batch=jb, train=True, rng=jax.random.fold_in(
            jax.random.PRNGKey(0), 0)) if two_stage else {}
        return jdet.loss_from_outputs(jdet.apply(v, jb['images'], **kwargs),
                                      jb)

    ref = jax.jit(j_loss)(variables)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    nchw = tb['images'].permute(0, 3, 1, 2)

    def port_loss(b):
        outputs = det(nchw, batch=b, train=True, rng=SampleKey(step=0))
        return det.loss_from_outputs(outputs, b)

    got = port_loss(tb)
    assert sorted(got) == sorted(ref)
    if names is not None:
        assert sorted(got) == sorted(names)
    for k in ref:
        np.testing.assert_allclose(float(got[k].detach()), float(ref[k]),
                                   rtol=1e-4, err_msg=k)
    # the overflow bites where the JAX head reads it, nowhere else
    without = port_loss({k: v for k, v in tb.items()
                         if not k.startswith('gt_ignore')})
    same = {k: float(got[k].detach()) == float(without[k].detach())
            for k in got}
    if label == 'retinanet':
        assert not same['loss_cls']
    else:
        assert all(same.values()), same


# ---- (c) crowded decode ----------------------------------------------------
@pytest.fixture
def few_nms_blocks(monkeypatch):
    """The JAX package's NMS in row blocks of 1024: on the CPU it unrolls
    one fused program a block, 125 of them at the default 16 rows for 2000
    candidates (a minute of compiling); the mask is the same for any
    block."""
    from orientedobjectdetection_tpu.ops import nms as j_nms
    upper = j_nms._upper_pair_mask

    def blocked(boxes, iou_fn, iou_thr, block=None, class_ids=None):
        return upper(boxes, iou_fn, iou_thr, block=1024, class_ids=class_ids)

    monkeypatch.setattr(j_nms, '_upper_pair_mask', blocked)


def test_crowded_decode_matches_jax(few_nms_blocks):
    """The hard RetinaNet head's decode on crowded scores of a 256² image:
    more than 800 candidates survive NMS, so ``max_per_img`` cuts the
    kept set."""
    size = 256
    model = Config.fromfile(RETINA).model
    head_cfg = dict(model['bbox_head'], train_cfg=dict(model['train_cfg']),
                    test_cfg=dict(model['test_cfg']))
    assert (head_cfg['test_cfg']['nms_pre'], head_cfg['test_cfg']['nms'][
        'iou_thr'], head_cfg['test_cfg']['max_per_img']) == (2000, 0.1, 800)
    rng = np.random.default_rng(11)
    maps = [(rng.normal(-1, 1, (1, n, n, 9 * 15)).astype(np.float32),
             rng.normal(0, 0.3, (1, n, n, 9 * 5)).astype(np.float32))
            for n in (size // s for s in (8, 16, 32, 64, 128))]
    j_head = J_HEADS.build(dict(JConfig.fromfile(RETINA).model['bbox_head'],
                                test_cfg=head_cfg['test_cfg']))
    rd, rl, rv = (np.asarray(x) for x in jax.jit(j_head.get_bboxes)(
        ([m[0] for m in maps], [m[1] for m in maps])))
    head = HEADS.build(head_cfg)
    nchw = lambda x: torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    dets, labels, valid = head.get_bboxes(
        ([nchw(m[0]) for m in maps], [nchw(m[1]) for m in maps]))
    assert rv.sum() == 800 and len(np.unique(rl[rv])) == 15
    np.testing.assert_array_equal(valid.numpy(), rv)
    np.testing.assert_array_equal(labels.numpy(), rl)
    np.testing.assert_allclose(dets.numpy(), rd, atol=1e-3)


# ---- (d) 15-class evaluation -----------------------------------------------
def crowded_dets(rng, gts, labels, num_classes=15, iou_thr=0.5):
    """Per class: perturbed copies of ~80% of its gts, a duplicate and
    false dets; those near an IoU tie dropped (``TIE_BAND``)."""
    per_class = []
    for c in range(num_classes):
        near = gts[labels == c]
        hits = near[rng.random(len(near)) < 0.8]
        hits = hits + rng.normal(0, [1.5, 1.5, 2, 2, 0.1],
                                 hits.shape).astype(np.float32)
        false = np.stack([rng.uniform(20, 492, 12), rng.uniform(20, 492, 12),
                          rng.uniform(8, 32, 12), rng.uniform(8, 32, 12),
                          rng.uniform(-1.5, 1.5, 12)], -1)
        boxes = np.concatenate([hits, hits[:1], false]).astype(np.float32)
        boxes[:, 2:4] = np.abs(boxes[:, 2:4]) + 1
        if len(near):
            ious = box_iou_rotated(torch.from_numpy(boxes),
                                   torch.from_numpy(near)).numpy()
            top = np.sort(ious, 1)[:, ::-1]
            clear = (np.abs(ious - iou_thr) >= TIE_BAND).all(1)
            if len(near) > 1:
                clear &= (top[:, 0] - top[:, 1] >= TIE_BAND) | \
                    (top[:, 0] < iou_thr - TIE_BAND)
            boxes = boxes[clear]
        scores = rng.random(len(boxes)).astype(np.float32)
        per_class.append(np.concatenate([boxes, scores[:, None]], 1))
    return per_class


def test_crowded_eval_map_matches_jax(scenes):
    scene = scenes['val'][0]
    gts, labels = scene['gt_bboxes'], scene['gt_labels']
    assert len(gts) > 100 and len(np.unique(labels)) == 15
    dets = crowded_dets(np.random.default_rng(3), gts, labels)
    n_dets = sum(len(d) for d in dets)
    assert 0.6 * len(gts) < n_dets and n_dets > 100
    anns = [dict(bboxes=gts, labels=labels,
                 bboxes_ignore=np.zeros((0, 5), np.float32),
                 labels_ignore=np.zeros(0, np.int64))]
    ref_map, ref = jax_eval.eval_rbbox_map([dets], anns, iou_thr=0.5,
                                           logger='silent')
    got_map, got = eval_map.eval_rbbox_map([dets], anns, iou_thr=0.5,
                                           logger='silent', device='cpu')
    assert 0 < ref_map < 1 and len(got) == len(ref) == 15
    assert abs(got_map - ref_map) <= 1e-6
    for g, r in zip(got, ref):
        assert (g['num_gts'], g['num_dets']) == (r['num_gts'], r['num_dets'])
        assert abs(g['ap'] - r['ap']) <= 1e-6
        assert abs(g['recall'] - r['recall']) <= 1e-6


# ---- the runner ------------------------------------------------------------
SPLITS = (('trainval', 6, 0), ('val', 2, 7))
BROKEN = "model = dict(type='NoSuchDetector')\n"


def small(tmp_path, path, label):
    return derived_config(tmp_path, path, SMALL.format(version='le90') +
                          CUTS[label] + '\n')


@pytest.fixture(scope='module')
def protocol(tmp_path_factory):
    """The runner over two small hard configs: one epoch of 6 trainval
    scenes with an evaluation of 2, float32 on the CPU."""
    tmp = tmp_path_factory.mktemp('protocol')
    configs = [small(tmp, RETINA, 'retinanet'), small(tmp, FASTER, 'orcnn')]
    root, work = str(tmp / 'data'), str(tmp / 'work')
    summary = hard_protocol.run_protocol(
        configs, work, root, epochs=1, device='cpu', dtype=torch.float32,
        splits=SPLITS, image_size=SIZE, log_interval=1)
    return dict(tmp=tmp, configs=configs, root=root, work=work,
                summary=summary)


def names(configs):
    return [osp.splitext(osp.basename(c))[0] for c in configs]


def test_runner_trains_logs_and_summarizes(protocol):
    summary, work = protocol['summary'], protocol['work']
    assert [hard_protocol.count_images(protocol['root'], s)
            for s, _, _ in SPLITS] == [6, 2]
    assert summary['trained'] == names(protocol['configs'])
    assert summary['failed'] == [] and summary['epochs'] == 1
    with open(osp.join(work, 'summary.json')) as f:
        assert json.load(f) == summary
    for row in summary['families']:
        assert row['status'] == 'trained' and row['wall_s'] > 0
        assert row['best_epoch'] == row['final_epoch'] == 1
        assert row['trajectory'] == {'1': row['best']} and \
            0 <= row['best'] <= 1
        assert row['reference_best'] is None    # no such reference family
        log = hard_protocol.read_log(osp.join(work, row['name'],
                                              'train_log.jsonl'))
        assert [r['step'] for r in log if 'loss' in r] == [1, 2, 3]
        assert log[-1] == dict(step=3, epoch=1, mode='val', mAP=row['best'])
        with open(osp.join(work, row['name'], 'run.log')) as f:
            text = f.read()
        assert f'==== {row["name"]} finished' in text and 'step 3/3' in text
    table = hard_protocol.format_table(summary['families'])
    assert all(n.replace('_hard_synth', '') in table
               for n in names(protocol['configs']))


def test_runner_skips_families_that_are_done(protocol, monkeypatch):
    from orientedobjectdetection_torch.apis import train as train_api

    def refuse(*args, **kwargs):
        raise AssertionError('a done family trained again')

    monkeypatch.setattr(train_api, 'train_detector', refuse)
    again = hard_protocol.run_protocol(
        protocol['configs'], protocol['work'], protocol['root'], epochs=1,
        device='cpu', dtype=torch.float32, splits=SPLITS, image_size=SIZE)
    assert again['trained'] == [] and again['failed'] == []
    assert [r['status'] for r in again['families']] == ['done', 'done']
    for got, ref in zip(again['families'], protocol['summary']['families']):
        assert dict(got, status='trained') == ref


def test_cli_names_a_failed_family_and_exits_non_zero(protocol, monkeypatch,
                                                      capsys):
    """A config that raises: its traceback in its run.log, the other
    family's results standing, exit code 1 naming it."""
    broken = str(protocol['tmp'] / 'broken_hard_synth.py')
    with open(broken, 'w') as f:
        f.write(f'_base_ = [{protocol["configs"][0]!r}]\n' + BROKEN)
    monkeypatch.setattr(hard_protocol, 'SPLITS', SPLITS)
    code = hard_protocol.main([broken, protocol['configs'][0], '--device',
                               'cpu', '--data-root', protocol['root'],
                               '--work-root', protocol['work'], '--epochs',
                               '1'])
    assert code == 1
    assert 'broken_hard_synth' in capsys.readouterr().err
    with open(osp.join(protocol['work'], 'broken_hard_synth',
                       'run.log')) as f:
        text = f.read()
    assert 'Traceback' in text and 'NoSuchDetector' in text
    with open(osp.join(protocol['work'], 'summary.json')) as f:
        rows = {r['name']: r for r in json.load(f)['families']}
    kept = protocol['summary']['families'][0]
    assert rows[kept['name']]['best'] == kept['best']
    assert rows[kept['name']]['status'] == 'done'
    assert rows['broken_hard_synth']['status'] == 'failed'


def test_runner_refuses_a_missing_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        hard_protocol.main(['--work-root', str(tmp_path)])


def test_reference_best_reads_the_reference_logs():
    assert hard_protocol.reference_best('rotated_retinanet_hard_synth') == \
        pytest.approx(0.13063028768325846, abs=0)
    assert hard_protocol.reference_best('rotated_faster_rcnn_hard_synth') \
        == pytest.approx(0.2645440171162287, abs=0)
    # died before its first evaluation; an empty log
    assert hard_protocol.reference_best('oriented_rcnn_hard_synth') is None
    assert hard_protocol.reference_best('cfa_hard_synth') is None
    assert len(hard_protocol.CONFIGS) == 19 and all(
        osp.exists(c) for c in hard_protocol.CONFIGS)
    assert sorted(names(hard_protocol.CONFIGS)) == sorted(
        n[:-3] for d in os.listdir(CONFIGS)
        for n in os.listdir(osp.join(CONFIGS, d))
        if n.endswith('_hard_synth.py'))


# ---- a repair this slice's run turned up ------------------------------------
def test_sampling_at_non_finite_points_matches_jax():
    """A point set gone NaN or infinite (a diverged step) samples zeros, as
    the JAX package's gather does, which clamps its indices: the port's
    sampler indexed the map at NaN's integer (a device-side assert on the
    card, an index error here), Oriented RepPoints' failure on the
    protocol's first card run."""
    from orientedobjectdetection_tpu.ops import feature_align as j_align
    from orientedobjectdetection_torch.ops import feature_align
    rng = np.random.default_rng(0)
    feat = rng.normal(0, 1, (2, 5, 7, 6)).astype(np.float32)    # NHWC
    offsets = rng.normal(0, 2, (2, 5, 7, 18)).astype(np.float32)
    offsets[0, 1, 2, 3] = np.nan
    offsets[1, 4, 0, 0] = np.inf
    offsets[1, 2, 6, 5:7] = [-np.inf, np.nan]
    ref = np.asarray(j_align.deform_conv_sample(jnp.asarray(feat),
                                                jnp.asarray(offsets)))
    got = feature_align.deform_conv_sample(
        torch.from_numpy(feat).permute(0, 3, 1, 2),
        torch.from_numpy(offsets).permute(0, 3, 1, 2))
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(got.permute(0, 3, 4, 2, 1).reshape(ref.shape)
                               .numpy(), ref, rtol=0, atol=1e-5)


def test_spatial_border_gradient_at_the_centre_is_zero():
    """A point exactly at its polygon's centre (a zero target polygon's
    origin, or inside a gt): the loss is the JAX package's, its gradient 0
    there where the JAX package's square root makes it NaN (0 x inf), and
    through the network the whole step's (Oriented RepPoints' NaN steps on
    the card); every other element equals the JAX gradient."""
    from orientedobjectdetection_tpu.models.losses.spatial_border_loss \
        import SpatialBorderLoss as JSpatialBorderLoss
    from orientedobjectdetection_torch.models.losses.spatial_border_loss \
        import SpatialBorderLoss
    rng = np.random.default_rng(4)
    polys = np.zeros((3, 8), np.float32)
    polys[0] = [0, 0, 40, 0, 40, 20, 0, 20]
    polys[1] = [10, 10, 30, 14, 26, 34, 6, 30]
    pts = rng.uniform(-10, 50, (3, 9, 2)).astype(np.float32)
    pts[0, 0] = [20, 10]                   # at the centre, inside
    pts[2, 3] = [0, 0]                     # at a zero polygon's origin
    pts = pts.reshape(3, 18)
    weight = np.array([1.0, 1.0, 0.0], np.float32)
    j_loss = JSpatialBorderLoss(loss_weight=0.1)
    ref, ref_grad = jax.value_and_grad(lambda p: j_loss(
        p, jnp.asarray(polys), weight=jnp.asarray(weight)))(
            jnp.asarray(pts))
    ref_grad = np.asarray(ref_grad)
    t = torch.from_numpy(pts).requires_grad_()
    got = SpatialBorderLoss(loss_weight=0.1)(
        t, torch.from_numpy(polys), weight=torch.from_numpy(weight))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-6)
    nan = np.isnan(ref_grad)
    centre = np.zeros((3, 9, 2), bool)
    centre[0, 0] = centre[2, 3] = True
    np.testing.assert_array_equal(nan, centre.reshape(3, 18))
    np.testing.assert_array_equal(t.grad.numpy()[nan], 0)
    np.testing.assert_allclose(t.grad.numpy()[~nan], ref_grad[~nan],
                               rtol=1e-5, atol=1e-7)
