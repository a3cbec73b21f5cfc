"""The port's rotated mAP (``core/eval_map.py``) against the JAX package's
on seeded detections and annotations with ignore gts, in both AP modes:
per-class AP and mAP within 1e-6.

The port's IoUs on the CPU are its plain IoU, the JAX package's formulation
in PyTorch, so the two agree to float rounding (about 1e-6), not bit for
bit. A det whose IoU with some gt lies within ``TIE_BAND`` of the
threshold, or whose two best gts are within ``TIE_BAND`` of each other, is
dropped from the seeded set before either package sees it: there rounding
alone could flip a match. The kernel on the card is held to its plain
version within 2e-5 (``tests/test_torch_gpu.py``), far inside that band.
"""

import numpy as np
import pytest
import torch

from orientedobjectdetection_tpu.core import eval_map as jax_eval
from orientedobjectdetection_torch.core import eval_map
from orientedobjectdetection_torch.ops.iou import box_iou_rotated

TIE_BAND = 1e-3


def random_boxes(rng, n, size=256):
    return np.stack([rng.uniform(20, size - 20, n), rng.uniform(20, size - 20, n),
                     rng.uniform(8, 60, n), rng.uniform(8, 60, n),
                     rng.uniform(-np.pi / 2, np.pi / 2, n)],
                    -1).astype(np.float32)


def seeded_set(seed, num_imgs=6, num_classes=3, iou_thr=0.5):
    rng = np.random.default_rng(seed)
    dets, anns = [], []
    for _ in range(num_imgs):
        n_gt, n_ig = int(rng.integers(0, 7)), int(rng.integers(0, 3))
        gts, igs = random_boxes(rng, n_gt), random_boxes(rng, n_ig)
        labels = rng.integers(0, num_classes, n_gt)
        labels_ig = rng.integers(0, num_classes, n_ig)
        anns.append(dict(bboxes=gts, labels=labels, bboxes_ignore=igs,
                         labels_ignore=labels_ig))
        per_class = []
        for c in range(num_classes):
            near = np.concatenate([gts[labels == c], igs[labels_ig == c]])
            hits = near[rng.random(len(near)) < 0.8]
            hits = hits + rng.normal(0, [3, 3, 4, 4, 0.15],
                                     hits.shape).astype(np.float32)
            hits = np.concatenate([hits, hits[:1]])     # a duplicate det
            boxes = np.concatenate([hits, random_boxes(
                rng, int(rng.integers(0, 4)))]).astype(np.float32)
            boxes[:, 2:4] = np.abs(boxes[:, 2:4]) + 1
            if len(boxes) and len(near):
                ious = box_iou_rotated(torch.from_numpy(boxes),
                                       torch.from_numpy(near)).numpy()
                top = np.sort(ious, 1)[:, ::-1]
                clear = (np.abs(ious - iou_thr) >= TIE_BAND).all(1)
                if near.shape[0] > 1:
                    clear &= (top[:, 0] - top[:, 1] >= TIE_BAND) | \
                        (top[:, 0] < iou_thr - TIE_BAND)
                boxes = boxes[clear]
            scores = rng.random(len(boxes)).astype(np.float32)
            per_class.append(np.concatenate([boxes, scores[:, None]], 1))
        dets.append(per_class)
    return dets, anns


@pytest.mark.parametrize('use_07_metric', [True, False])
@pytest.mark.parametrize('seed,iou_thr', [(0, 0.5), (1, 0.5), (2, 0.7)])
def test_eval_rbbox_map_matches_jax(seed, iou_thr, use_07_metric):
    dets, anns = seeded_set(seed, iou_thr=iou_thr)
    ref_map, ref = jax_eval.eval_rbbox_map(dets, anns, iou_thr=iou_thr,
                                           use_07_metric=use_07_metric,
                                           logger='silent')
    got_map, got = eval_map.eval_rbbox_map(dets, anns, iou_thr=iou_thr,
                                           use_07_metric=use_07_metric,
                                           logger='silent', device='cpu')
    assert sum(r['num_gts'] for r in ref) > 0
    assert 0 < ref_map < 1                     # hits, misses and false dets
    assert abs(got_map - ref_map) <= 1e-6
    for g, r in zip(got, ref):
        assert (g['num_gts'], g['num_dets']) == (r['num_gts'], r['num_dets'])
        assert abs(g['ap'] - r['ap']) <= 1e-6
        assert abs(g['recall'] - r['recall']) <= 1e-6


def test_eval_rbbox_map_defaults_to_the_card(monkeypatch):
    dets, anns = seeded_set(0)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        eval_map.eval_rbbox_map(dets, anns, logger='silent')


def test_tpfp_default_ignore_and_duplicates_match_jax():
    dets, anns = seeded_set(4, num_imgs=12)
    for res, ann in zip(dets, anns):
        for c, d in enumerate(res):
            g = ann['bboxes'][ann['labels'] == c]
            gi = ann['bboxes_ignore'][ann['labels_ignore'] == c]
            tp, fp = eval_map.tpfp_default(d, g, gi)
            ref_tp, ref_fp = jax_eval.tpfp_default(d, g, gi)
            np.testing.assert_array_equal(tp, ref_tp)
            np.testing.assert_array_equal(fp, ref_fp)


@pytest.mark.parametrize('mode', ['11points', 'area'])
def test_average_precision_matches_jax(mode):
    rng = np.random.default_rng(5)
    recalls = np.sort(rng.random(30))
    precisions = rng.random(30)
    assert eval_map.average_precision(recalls, precisions, mode) == \
        jax_eval.average_precision(recalls, precisions, mode)
