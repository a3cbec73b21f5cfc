"""DOTA-layout datasets (counterpart of
``orientedobjectdetection_tpu/datasets/dota.py``; reference
``datasets/dota.py:24-382`` and ``sar.py``).

``{split}/annfiles/*.txt`` lines ``x1 y1 ... x4 y4 class difficulty`` ->
rotated boxes through :func:`poly2obb_np`; ``{split}/images/*.png``
(a split without annotation files is a test split of ``*.png`` and
``*.jpg`` images; an annotated one reads ``<stem>.png``, as the JAX
package does);
``evaluate`` -> rotated VOC mAP; ``merge_det`` puts the detections of
tiles (``<id>__<size>__<x>___<y>``) back into their image's frame and
``format_results`` writes the DOTA Task1 submission files and their zip.
"""

from __future__ import annotations

import collections
import glob
import os
import os.path as osp
import re
import tempfile
import threading
import zipfile
from typing import Dict, List, Optional

import numpy as np

from ..core.eval_map import eval_rbbox_map
from ..ops.boxes import obb2poly_np, poly2obb_np
from ..ops.nms import nms_rotated_np
from ..utils.registry import DATASETS
from .pipelines import Compose


class FetchRng:
    """A generator for each fetch of a sample: the ``k``-th fetch of index
    ``idx`` draws from ``default_rng([entropy, idx, k])``, so a loader's
    threads give the same samples in any order."""

    def __init__(self, seed: Optional[int] = None):
        self._entropy = np.random.SeedSequence(seed).entropy
        self._fetches = collections.Counter()
        self._lock = threading.Lock()

    def __call__(self, idx: int) -> np.random.Generator:
        with self._lock:
            k = self._fetches[idx]
            self._fetches[idx] += 1
        return np.random.default_rng([self._entropy, idx, k])


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
        self._rng = FetchRng(seed)

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
        return self._rng(idx)

    def __getitem__(self, idx: int):
        return self.fetch(idx, self.sample_rng(idx))

    def fetch(self, idx: int, rng: np.random.Generator):
        """Sample ``idx`` through the pipeline, its random transforms
        drawing from ``rng``; a sample the pipeline drops is replaced by a
        random other one."""
        info = self.data_infos[idx]
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

    def merge_det(self, results, nproc: int = 4, device='cuda',
                  plain_pair_mask: bool = False):
        """Tile detections -> original images (reference
        ``dota.py:216-276``): each tile's ``__<x>___<y>`` offsets are added
        to its centres, its image id is the name before the first ``__``
        (tiles are ``<id>__<size>__<x>___<y>``), and each image's
        detections of a class go through one rotated NMS at 0.1 on
        ``device`` (the card unless ``'cpu'`` is asked for). ``nproc`` is
        accepted and unused. Returns (image ids in the order they first
        appear, per image per class ``(n, 6)`` arrays)."""
        pattern = re.compile(r'__(\d+)___(\d+)')
        collector = collections.defaultdict(list)
        for info, dets_per_cls in zip(self.data_infos, results):
            fname = osp.splitext(info['filename'])[0]
            match = pattern.search(fname)
            if match:
                x_off, y_off = float(match.group(1)), float(match.group(2))
                orig = fname.split('__', 1)[0]
            else:
                x_off = y_off = 0.0
                orig = fname
            for cls, dets in enumerate(dets_per_cls):
                dets = np.asarray(dets, np.float32).reshape(-1, 6)
                if len(dets) == 0:
                    continue
                d = dets.copy()
                d[:, 0] += x_off
                d[:, 1] += y_off
                lab = np.full((len(d), 1), cls, np.float32)
                collector[orig].append(np.concatenate([d, lab], -1))

        merged_ids, merged = [], []
        for img_id, parts in collector.items():
            dets = np.concatenate(parts, 0)
            out_per_cls = []
            for cls in range(len(self.CLASSES)):
                cd = dets[dets[:, 6] == cls][:, :6]
                if len(cd) == 0:
                    out_per_cls.append(np.zeros((0, 6), np.float32))
                    continue
                keep = nms_rotated_np(cd[:, :5], cd[:, 5], 0.1, device,
                                      plain_pair_mask)
                out_per_cls.append(cd[keep])
            merged_ids.append(img_id)
            merged.append(out_per_cls)
        return merged_ids, merged

    def format_results(self, results, submission_dir: Optional[str] = None,
                       nproc: int = 4, device='cuda', **kwargs) -> str:
        """Write the DOTA Task1 submission (reference ``dota.py:278-355``):
        :meth:`merge_det`, then one ``Task1_<class>.txt`` a class with a
        line ``<image id> <score %.4f> <x1 y1 ... x4 y4 %.2f>`` a
        detection, and ``submission.zip`` holding the files. Returns the
        zip's path."""
        submission_dir = submission_dir or tempfile.mkdtemp()
        os.makedirs(submission_dir, exist_ok=True)
        ids, merged = self.merge_det(results, nproc, device=device)
        paths = [osp.join(submission_dir, f'Task1_{name}.txt')
                 for name in self.CLASSES]
        for cls_idx, path in enumerate(paths):
            with open(path, 'w') as f:
                for img_id, dets_per_cls in zip(ids, merged):
                    dets = dets_per_cls[cls_idx]
                    if len(dets) == 0:
                        continue
                    for p in obb2poly_np(dets, self.version):
                        coords = ' '.join(f'{v:.2f}' for v in p[:8])
                        f.write(f'{img_id} {p[8]:.4f} {coords}\n')
        zip_path = osp.join(submission_dir, 'submission.zip')
        with zipfile.ZipFile(zip_path, 'w', zipfile.ZIP_DEFLATED) as zf:
            for path in paths:
                zf.write(path, osp.basename(path))
        return zip_path


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
