"""DOTA-style rotated mAP (counterpart of
``orientedobjectdetection_tpu/core/eval_map.py``; reference
``core/evaluation/eval_map.py:12-313``).

The IoUs of each class come from the port's :func:`rbbox_overlaps` in one
batched call over all images (dets x gts, zero-padded): a CUDA ``device``
takes the IoU-matrix kernel, the CPU its plain version. The greedy matching
and the AP are host numpy, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.iou import rbbox_overlaps


def _iou_device(device, caller: str) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device raises RuntimeError
    when no card is present (no fallback to the CPU)."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'{caller}: no CUDA device is available; pass '
                           f'device="cpu" to compute the IoUs on the CPU')
    return device


def batched_ious(dets: List[np.ndarray], gts: List[np.ndarray],
                 device='cuda', plain_iou: bool = False) -> List[np.ndarray]:
    """Per image, the ``(n_i, m_i)`` IoU matrix of its ``(n_i, 5+)`` dets
    against its ``(m_i, 5)`` gts, from one padded ``(B, N, 5) x (B, M, 5)``
    call on ``device``: the card by default, which raises without one
    unless ``'cpu'`` is asked for (``plain_iou``: the plain version there
    too)."""
    device = _iou_device(device, 'batched_ious')
    n = max((len(d) for d in dets), default=0)
    m = max((len(g) for g in gts), default=0)
    if n == 0 or m == 0:
        return [np.zeros((len(d), len(g)), np.float32)
                for d, g in zip(dets, gts)]
    b = len(dets)
    d_pad = np.zeros((b, n, 5), np.float32)
    g_pad = np.zeros((b, m, 5), np.float32)
    for i, (d, g) in enumerate(zip(dets, gts)):
        d_pad[i, :len(d)] = d[:, :5]
        g_pad[i, :len(g)] = g
    with torch.no_grad():
        ious = rbbox_overlaps(torch.from_numpy(d_pad).to(device),
                              torch.from_numpy(g_pad).to(device),
                              plain=plain_iou).cpu().numpy()
    return [ious[i, :len(d), :len(g)] for i, (d, g) in enumerate(zip(dets,
                                                                      gts))]


def tpfp_default(det_bboxes: np.ndarray, gt_bboxes: np.ndarray,
                 gt_bboxes_ignore: Optional[np.ndarray] = None,
                 iou_thr: float = 0.5, ious: Optional[np.ndarray] = None,
                 device='cuda'):
    """Greedy TP/FP marking of one image and class: each det, by descending
    score, takes the gt of its highest IoU; a det whose best gt is an
    ignore gt counts as neither. ``ious``: the dets against
    ``[gt_bboxes; gt_bboxes_ignore]``; when not given, :func:`batched_ious`
    computes them on ``device``: the card by default, which raises without
    one unless ``'cpu'`` is asked for. Returns ``(tp, fp)`` float32 arrays
    of shape ``(num_dets,)``."""
    device = _iou_device(device, 'tpfp_default')
    det_bboxes = np.asarray(det_bboxes, np.float32).reshape(-1, 6)
    gt_bboxes = np.asarray(gt_bboxes, np.float32).reshape(-1, 5)
    if gt_bboxes_ignore is None:
        gt_bboxes_ignore = np.zeros((0, 5), np.float32)
    gt_bboxes_ignore = np.asarray(gt_bboxes_ignore, np.float32).reshape(-1, 5)
    gt_ignore = np.concatenate([np.zeros(len(gt_bboxes), bool),
                                np.ones(len(gt_bboxes_ignore), bool)])
    all_gts = np.vstack([gt_bboxes, gt_bboxes_ignore])
    num_dets = det_bboxes.shape[0]
    tp = np.zeros(num_dets, np.float32)
    fp = np.zeros(num_dets, np.float32)
    if all_gts.shape[0] == 0:
        fp[:] = 1
        return tp, fp
    if num_dets == 0:
        return tp, fp
    if ious is None:
        ious = batched_ious([det_bboxes], [all_gts], device)[0]
    ious_max = ious.max(axis=1)
    ious_argmax = ious.argmax(axis=1)
    covered = np.zeros(all_gts.shape[0], bool)
    for i in np.argsort(-det_bboxes[:, -1]):
        if ious_max[i] >= iou_thr:
            matched = ious_argmax[i]
            if not gt_ignore[matched]:
                if not covered[matched]:
                    covered[matched] = True
                    tp[i] = 1
                else:
                    fp[i] = 1
        else:
            fp[i] = 1
    return tp, fp


def average_precision(recalls: np.ndarray, precisions: np.ndarray,
                      mode: str = '11points') -> float:
    """VOC AP: ``'11points'`` interpolation (the reference's
    ``use_07_metric=True``) or ``'area'`` under the precision envelope."""
    if mode == '11points':
        ap = 0.0
        for thr in np.arange(0, 1.01, 0.1):
            prec = precisions[recalls >= thr]
            ap += (prec.max() if prec.size else 0.0) / 11
        return float(ap)
    if mode != 'area':
        raise ValueError(f'mode must be 11points or area, got {mode!r}')
    mrec = np.concatenate([[0.0], recalls, [1.0]])
    mpre = np.concatenate([[0.0], precisions, [0.0]])
    for i in range(mpre.size - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def eval_rbbox_map(det_results: List[List[np.ndarray]],
                   annotations: List[Dict],
                   iou_thr: float = 0.5,
                   use_07_metric: bool = True,
                   dataset: Optional[Sequence[str]] = None,
                   logger=None,
                   nproc: int = 4,
                   device='cuda',
                   plain_iou: bool = False) -> Tuple[float, List[Dict]]:
    """DOTA VOC-style rotated mAP (reference ``eval_map.py:126-246``).

    ``det_results``: per image, per class ``(n, 6)`` arrays
    ``[cx, cy, w, h, a, score]``; ``annotations``: per image ``bboxes``
    ``(n, 5)`` and ``labels``, optionally ``bboxes_ignore`` and
    ``labels_ignore``. ``device`` and ``plain_iou`` say where the IoUs are
    computed (:func:`batched_ious`): the card by default, which raises
    without one unless ``'cpu'`` is asked for; ``nproc`` is accepted and
    unused. Returns ``(mean_ap, per-class dicts)``."""
    device = _iou_device(device, 'eval_rbbox_map')
    num_classes = len(det_results[0])
    mode = '11points' if use_07_metric else 'area'
    eval_results = []
    for cls in range(num_classes):
        cls_dets, cls_gts, cls_gts_ig = [], [], []
        for res, ann in zip(det_results, annotations):
            cls_dets.append(np.asarray(res[cls], np.float32).reshape(-1, 6))
            m = np.asarray(ann['labels']).reshape(-1) == cls
            cls_gts.append(np.asarray(ann['bboxes'],
                                      np.float32).reshape(-1, 5)[m])
            if ann.get('labels_ignore') is not None:
                mi = np.asarray(ann['labels_ignore']).reshape(-1) == cls
                cls_gts_ig.append(np.asarray(
                    ann['bboxes_ignore'], np.float32).reshape(-1, 5)[mi])
            else:
                cls_gts_ig.append(np.zeros((0, 5), np.float32))
        all_gts = [np.vstack([g, gi]) for g, gi in zip(cls_gts, cls_gts_ig)]
        ious = batched_ious(cls_dets, all_gts, device, plain_iou)
        tpfp = [tpfp_default(d, g, gi, iou_thr, iou, device)
                for d, g, gi, iou in zip(cls_dets, cls_gts, cls_gts_ig, ious)]
        tp = np.concatenate([t for t, _ in tpfp])
        fp = np.concatenate([f for _, f in tpfp])
        all_scores = np.concatenate([d[:, -1] for d in cls_dets])
        num_gts = sum(g.shape[0] for g in cls_gts)
        order = np.argsort(-all_scores)
        tp_cum = np.cumsum(tp[order])
        fp_cum = np.cumsum(fp[order])
        eps = np.finfo(np.float32).eps
        recalls = tp_cum / max(num_gts, eps)
        precisions = tp_cum / np.maximum(tp_cum + fp_cum, eps)
        ap = average_precision(recalls, precisions, mode) if num_gts > 0 \
            else 0.0
        eval_results.append(dict(
            num_gts=num_gts, num_dets=int(tp.shape[0]),
            recall=float(recalls[-1]) if recalls.size else 0.0,
            precision=float(precisions[-1]) if precisions.size else 0.0,
            ap=ap))
    aps = [r['ap'] for r in eval_results if r['num_gts'] > 0]
    mean_ap = float(np.mean(aps)) if aps else 0.0
    print_map_summary(mean_ap, eval_results, dataset, logger=logger)
    return mean_ap, eval_results


def print_map_summary(mean_ap, results, dataset=None, logger=None):
    """ASCII per-class table (reference ``eval_map.py:249-313``);
    ``logger='silent'`` prints nothing."""
    if logger == 'silent':
        return
    names = dataset if dataset is not None else [
        f'class_{i}' for i in range(len(results))]
    header = f'{"class":>20} {"gts":>7} {"dets":>8} {"recall":>7} {"ap":>7}'
    lines = [header, '-' * len(header)]
    for name, r in zip(names, results):
        lines.append(f'{name:>20} {r["num_gts"]:>7d} {r["num_dets"]:>8d} '
                     f'{r["recall"]:>7.3f} {r["ap"]:>7.3f}')
    lines.append('-' * len(header))
    lines.append(f'{"mAP":>20} {"":>7} {"":>8} {"":>7} {mean_ap:>7.3f}')
    msg = '\n'.join(lines)
    if logger is None:
        print(msg)
    else:
        logger.info(msg)
