"""DOTA-layout datasets (counterpart of
``orientedobjectdetection_tpu/datasets/dota.py``; reference
``datasets/dota.py:24-382`` and ``sar.py``).

``{split}/annfiles/*.txt`` lines ``x1 y1 ... x4 y4 class difficulty`` ->
rotated boxes through :func:`poly2obb_np`; ``{split}/images/*.png``;
``evaluate`` -> rotated VOC mAP. Patch merging and the DOTA submission
files (``merge_det``, ``format_results``) are ROADMAP A.5.
"""

from __future__ import annotations

import collections
import glob
import os.path as osp
import threading
from typing import Dict, List, Optional

import numpy as np

from ..core.eval_map import eval_rbbox_map
from ..ops.boxes import poly2obb_np
from ..utils.registry import DATASETS
from .pipelines import Compose


@DATASETS.register_module()
class DOTADataset:
    """DOTA-v1.0 (15 classes). Each fetch of a sample draws its random
    augmentation from its own generator (:meth:`sample_rng`), a function of
    ``seed``, the index and how often it was fetched before, so a loader's
    threads give the same samples in any order."""

    CLASSES = ('plane', 'baseball-diamond', 'bridge', 'ground-track-field',
               'small-vehicle', 'large-vehicle', 'ship', 'tennis-court',
               'basketball-court', 'storage-tank', 'soccer-ball-field',
               'roundabout', 'harbor', 'swimming-pool', 'helicopter')

    PALETTE = [(165, 42, 42), (189, 183, 107), (0, 255, 0), (255, 0, 0),
               (138, 43, 226), (255, 128, 0), (255, 0, 255), (0, 255, 255),
               (255, 193, 193), (0, 51, 153), (255, 250, 205), (0, 139, 139),
               (255, 255, 0), (147, 116, 116), (0, 0, 255)]

    def __init__(self, ann_file: str, pipeline, img_prefix: str = '',
                 version: str = 'oc', difficulty: int = 100,
                 filter_empty_gt: bool = True, test_mode: bool = False,
                 classes=None, seed: Optional[int] = None, **kwargs):
        self.ann_file = ann_file
        self.img_prefix = img_prefix
        self.version = version
        self.difficulty = difficulty
        self.filter_empty_gt = filter_empty_gt
        self.test_mode = test_mode
        if classes is not None:
            self.CLASSES = tuple(classes)
        self.cls_map = {c: i for i, c in enumerate(self.CLASSES)}
        self.data_infos = self.load_annotations(ann_file)
        self.pipeline = Compose(pipeline)
        self._entropy = np.random.SeedSequence(seed).entropy
        self._fetches = collections.Counter()
        self._lock = threading.Lock()

    def __len__(self):
        return len(self.data_infos)

    def load_annotations(self, ann_folder: str) -> List[Dict]:
        """Scan ``annfiles/*.txt``; a folder of images alone is a test split
        (reference ``dota.py:58-113``)."""
        ann_files = sorted(glob.glob(osp.join(ann_folder, '*.txt')))
        data_infos = []
        if not ann_files:
            img_files = sorted(glob.glob(osp.join(ann_folder, '*.png'))) + \
                sorted(glob.glob(osp.join(ann_folder, '*.jpg')))
            for img in img_files:
                data_infos.append(dict(
                    filename=osp.basename(img),
                    ann=dict(bboxes=np.zeros((0, 5), np.float32),
                             labels=np.zeros((0,), np.int64))))
            return data_infos

        for ann_file in ann_files:
            gt_bboxes, gt_labels = [], []
            gt_bboxes_ig, gt_labels_ig = [], []
            with open(ann_file) as f:
                for line in f:
                    items = line.split()
                    if len(items) < 9:
                        continue
                    poly = np.asarray(items[:8], np.float32)
                    obb = poly2obb_np(poly, self.version)
                    if obb is None:
                        continue
                    name = items[8]
                    if name not in self.cls_map:
                        continue
                    diff = int(items[9]) if len(items) > 9 else 0
                    if diff > self.difficulty:
                        gt_bboxes_ig.append(obb)
                        gt_labels_ig.append(self.cls_map[name])
                    else:
                        gt_bboxes.append(obb)
                        gt_labels.append(self.cls_map[name])
            base = osp.splitext(osp.basename(ann_file))[0]
            ann = dict(
                bboxes=np.asarray(gt_bboxes, np.float32).reshape(-1, 5),
                labels=np.asarray(gt_labels, np.int64).reshape(-1),
                bboxes_ignore=np.asarray(gt_bboxes_ig,
                                         np.float32).reshape(-1, 5),
                labels_ignore=np.asarray(gt_labels_ig, np.int64).reshape(-1))
            data_infos.append(dict(filename=base + '.png', ann=ann))
        if self.filter_empty_gt and not self.test_mode:
            data_infos = [d for d in data_infos if len(d['ann']['labels'])]
        return data_infos

    def get_ann_info(self, idx: int) -> Dict:
        return self.data_infos[idx]['ann']

    def sample_rng(self, idx: int) -> np.random.Generator:
        """The generator of the ``k``-th fetch of sample ``idx``:
        ``default_rng([entropy, idx, k])``."""
        with self._lock:
            k = self._fetches[idx]
            self._fetches[idx] += 1
        return np.random.default_rng([self._entropy, idx, k])

    def __getitem__(self, idx: int):
        info = self.data_infos[idx]
        rng = self.sample_rng(idx)
        results = dict(img_info=dict(filename=info['filename']),
                       ann_info=info['ann'], img_prefix=self.img_prefix,
                       rng=rng)
        out = self.pipeline(results)
        if out is None:            # augmentation dropped every gt: resample
            return self[int(rng.integers(len(self)))]
        return out

    def evaluate(self, results, metric: str = 'mAP', iou_thr: float = 0.5,
                 logger=None, use_07_metric: bool = True, nproc: int = 4,
                 device='cuda', plain_iou: bool = False):
        """Rotated VOC mAP of ``results`` (per image, per class ``(n, 6)``
        arrays) against this dataset's annotations; the IoUs on
        ``device``, the card unless ``'cpu'`` is asked for
        (:func:`..core.eval_map.eval_rbbox_map`)."""
        if metric != 'mAP':
            raise ValueError(f'metric must be mAP, got {metric!r}')
        annotations = [self.get_ann_info(i) for i in range(len(self))]
        mean_ap, _ = eval_rbbox_map(results, annotations, iou_thr=iou_thr,
                                    use_07_metric=use_07_metric,
                                    dataset=self.CLASSES, logger=logger,
                                    device=device, plain_iou=plain_iou)
        return {'mAP': mean_ap}

    def merge_det(self, results, nproc: int = 4):
        raise NotImplementedError('merge_det (patch merging) is ROADMAP A.5')

    def format_results(self, results, submission_dir=None, nproc: int = 4,
                       **kwargs):
        raise NotImplementedError('format_results (DOTA submission files) '
                                  'needs merge_det, ROADMAP A.5')


@DATASETS.register_module()
class SARDataset(DOTADataset):
    """SSDD / HRSID ship detection (reference ``datasets/sar.py:7-12``)."""
    CLASSES = ('ship',)
    PALETTE = [(0, 255, 0)]


@DATASETS.register_module()
class DOTAv15Dataset(DOTADataset):
    CLASSES = DOTADataset.CLASSES + ('container-crane',)


@DATASETS.register_module()
class DOTAv2Dataset(DOTADataset):
    CLASSES = DOTADataset.CLASSES + ('container-crane', 'airport',
                                     'helipad')
