"""HRSC2016 ships (counterpart of
``orientedobjectdetection_tpu/datasets/hrsc.py``; reference
``datasets/hrsc.py:17-266``).

VOC-style XML annotations carry ``(cx, cy, w, h, angle)`` per
``HRSC_Object``; the boxes are put in the long-edge form of ``version``.
``classwise`` exposes the 31 ship classes by their ``Class_ID``, else every
object is one ``ship``. Images are ``{img_prefix}/{img_subdir}/{id}.bmp``;
``evaluate`` gives AP50, AP75 and ``mAP`` (= AP50).
"""

from __future__ import annotations

import glob
import os.path as osp
import xml.etree.ElementTree as ET
from typing import List

import numpy as np

from ..core.eval_map import eval_rbbox_map
from ..ops.boxes import norm_angle
from ..utils.registry import DATASETS
from .dota import DOTADataset


@DATASETS.register_module()
class HRSCDataset(DOTADataset):
    """HRSC2016; a fetch draws its augmentation from
    :meth:`DOTADataset.sample_rng` like the DOTA datasets."""

    CLASSES = ('ship',)
    HRSC_CLASS = '100000001'
    PALETTE = [(0, 255, 0)]
    # classwise mode: the 31 ship types, keyed by the Class_ID suffix
    # (reference ``datasets/hrsc.py:31-47``)
    HRSC_CLASSES = ('ship', 'aircraft carrier', 'warcraft', 'merchant ship',
                    'Nimitz', 'Enterprise', 'Arleigh Burke', 'WhidbeyIsland',
                    'Perry', 'Sanantonio', 'Ticonderoga', 'Kitty Hawk',
                    'Kuznetsov', 'Abukuma', 'Austen', 'Tarawa', 'Blue Ridge',
                    'Container', 'OXo|--)', 'Car carrier([]==[])',
                    'Hovercraft', 'yacht', 'CntShip(_|.--.--|_]=', 'Cruise',
                    'submarine', 'lute', 'Medical', 'Car carrier(======|',
                    'Ford-class', 'Midway-class', 'Invincible-class')
    HRSC_CLASSES_ID = ('01', '02', '03', '04', '05', '06', '07', '08', '09',
                       '10', '11', '12', '13', '14', '15', '16', '17', '18',
                       '19', '20', '22', '24', '25', '26', '27', '28', '29',
                       '30', '31', '32', '33')

    def __init__(self, ann_file, pipeline, img_prefix='',
                 img_subdir='AllImages', ann_subdir='Annotations',
                 classwise=False, version='oc', **kwargs):
        self.img_subdir = img_subdir
        self.ann_subdir = ann_subdir
        self.classwise = classwise
        if classwise:
            self.catid2label = {'1000000' + cls_id: i for i, cls_id in
                                enumerate(self.HRSC_CLASSES_ID)}
            kwargs.setdefault('classes', self.HRSC_CLASSES)
        super().__init__(ann_file, pipeline, img_prefix=img_prefix,
                         version=version, **kwargs)

    def load_annotations(self, ann_file) -> List[dict]:
        """Image ids from an image-set file (one id a line) or from the
        ``*.xml`` of an annotation folder; the XML of each id from that
        folder, or from ``{img_prefix}/{ann_subdir}`` for an image-set
        file. An id without an XML has no objects."""
        if osp.isfile(ann_file):
            with open(ann_file) as f:
                ids = [line.strip() for line in f if line.strip()]
        else:
            ids = [osp.splitext(osp.basename(p))[0] for p in
                   sorted(glob.glob(osp.join(ann_file, '*.xml')))]
        ann_root = ann_file if osp.isdir(ann_file) else \
            osp.join(self.img_prefix, self.ann_subdir)
        data_infos = []
        for img_id in ids:
            xml_path = osp.join(ann_root, f'{img_id}.xml')
            bboxes, labels = [], []
            if osp.isfile(xml_path):
                for obj in ET.parse(xml_path).getroot().findall(
                        './/HRSC_Object'):
                    if self.classwise:
                        label = self.catid2label.get(
                            obj.findtext('Class_ID', ''))
                        if label is None:
                            continue
                    else:
                        label = 0
                    cx, cy, w, h, ang = (float(obj.findtext(k, '0')) for k in
                                         ('mbox_cx', 'mbox_cy', 'mbox_w',
                                          'mbox_h', 'mbox_ang'))
                    if self.version != 'le90':
                        ang = float(norm_angle(np.asarray(ang),
                                               self.version))
                    if w < h:                 # the canonical long edge
                        w, h = h, w
                        ang = float(norm_angle(np.asarray(ang + np.pi / 2),
                                               self.version))
                    bboxes.append([cx, cy, w, h, ang])
                    labels.append(label)
            ann = dict(
                bboxes=np.asarray(bboxes, np.float32).reshape(-1, 5),
                labels=np.asarray(labels, np.int64).reshape(-1),
                bboxes_ignore=np.zeros((0, 5), np.float32),
                labels_ignore=np.zeros((0,), np.int64))
            data_infos.append(dict(
                filename=osp.join(self.img_subdir, f'{img_id}.bmp'),
                ann=ann))
        if self.filter_empty_gt and not self.test_mode:
            data_infos = [d for d in data_infos if len(d['ann']['labels'])]
        return data_infos

    def evaluate(self, results, metric='mAP', iou_thr=0.5, logger=None,
                 use_07_metric=True, device='cuda', plain_iou: bool = False,
                 **kwargs):
        """AP at IoU 0.5 and 0.75 (``AP50``, ``AP75``) and ``mAP`` = AP50,
        the IoUs on ``device`` (the card unless ``'cpu'`` is asked for)."""
        annotations = [self.get_ann_info(i) for i in range(len(self))]
        out = {}
        for thr in (0.5, 0.75):
            ap, _ = eval_rbbox_map(results, annotations, iou_thr=thr,
                                   use_07_metric=use_07_metric,
                                   dataset=self.CLASSES, logger='silent',
                                   device=device, plain_iou=plain_iou)
            out[f'AP{int(thr * 100)}'] = ap
        out['mAP'] = out['AP50']
        return out
