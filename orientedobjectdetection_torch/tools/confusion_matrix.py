"""Rotated-IoU confusion matrix of pickled results (counterpart of
``tools/analysis_tools/confusion_matrix.py``; reference
``tools/analysis_tools/confusion_matrix.py:11-262``).

    python -m orientedobjectdetection_torch.tools.confusion_matrix \\
        <config> <results.pkl> <out_dir> [--score-thr 0.3] \\
        [--tp-iou-thr 0.5]

The IoUs come from ``ops/iou_kernels.py:box_iou_rotated_matrix`` on the
card (the IoU-matrix kernel; ``--device cpu`` for its plain version).
Writes ``confusion_matrix.npy`` (rows: gt classes and background; columns:
detected classes and missed) and prints it.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import pickle

import numpy as np
import torch


def calculate_confusion_matrix(dataset, results, score_thr: float = 0.3,
                               tp_iou_thr: float = 0.5,
                               device='cuda') -> np.ndarray:
    """``(C + 1, C + 1)`` counts: each detection above ``score_thr``, by
    descending score, goes to its best-IoU gt's row when that IoU reaches
    ``tp_iou_thr`` (that gt is then hit) and to the background row
    otherwise; each gt never hit counts in the last column."""
    from ..ops import iou_kernels
    from ..ops.nms import host_device
    device = host_device(device, 'calculate_confusion_matrix')
    n = len(dataset.CLASSES)
    cm = np.zeros((n + 1, n + 1))
    for idx, per_cls in enumerate(results):
        ann = dataset.get_ann_info(idx)
        gts, gt_labels = ann['bboxes'], ann['labels']
        det_list, det_labels = [], []
        for c, d in enumerate(per_cls):
            d = np.asarray(d).reshape(-1, 6)
            d = d[d[:, 5] >= score_thr]
            det_list.append(d)
            det_labels.extend([c] * len(d))
        dets = np.concatenate(det_list) if det_list else \
            np.zeros((0, 6), np.float32)
        det_labels = np.asarray(det_labels, np.int64)
        gt_hit = np.zeros(len(gts), bool)
        if len(dets) and len(gts):
            ious = iou_kernels.box_iou_rotated_matrix(
                torch.from_numpy(np.ascontiguousarray(dets[:, :5],
                                                      np.float32)).to(device),
                torch.from_numpy(np.ascontiguousarray(gts, np.float32)
                                 ).to(device)).cpu().numpy()
            for i in np.argsort(-dets[:, 5]):
                j = ious[i].argmax()
                if ious[i, j] >= tp_iou_thr:
                    cm[gt_labels[j], det_labels[i]] += 1
                    gt_hit[j] = True
                else:
                    cm[n, det_labels[i]] += 1    # background -> det (FP)
        elif len(dets):
            for lb in det_labels:
                cm[n, lb] += 1
        for j in np.nonzero(~gt_hit)[0]:
            cm[gt_labels[j], n] += 1             # missed gt
    return cm


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Rotated confusion matrix')
    p.add_argument('config')
    p.add_argument('prediction_path')
    p.add_argument('save_dir')
    p.add_argument('--score-thr', type=float, default=0.3)
    p.add_argument('--tp-iou-thr', type=float, default=0.5)
    p.add_argument('--device', default='cuda',
                   help='cuda (the default) or cpu')
    p.add_argument('--cfg-options', nargs='+', default=[])
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..datasets import build_dataset
    from .train import load_config
    cfg = load_config(args.config, args.cfg_options)
    dataset = build_dataset(dict(cfg.data['val'], test_mode=True,
                                 filter_empty_gt=False))
    with open(args.prediction_path, 'rb') as f:
        results = pickle.load(f)
    cm = calculate_confusion_matrix(dataset, results, args.score_thr,
                                    args.tp_iou_thr, args.device)
    os.makedirs(args.save_dir, exist_ok=True)
    np.save(osp.join(args.save_dir, 'confusion_matrix.npy'), cm)
    names = list(dataset.CLASSES) + ['background']
    print('rows = gt, cols = det')
    print('\t' + '\t'.join(n[:8] for n in names))
    for i, row in enumerate(cm):
        print(names[i][:8] + '\t' + '\t'.join(str(int(v)) for v in row))
    return cm


if __name__ == '__main__':
    main()
