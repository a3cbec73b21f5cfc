"""Batched evaluation (counterpart of
``orientedobjectdetection_tpu/apis/eval.py``; the reference's
``single_gpu_test`` loop, ``tools/test.py:14`` and mmdet's apis).

One process, a fixed batch size: images are read on a pool of threads
while the card runs the previous batch. Gathering results across processes
(``collect_dir``) is ROADMAP A.13.
"""

from __future__ import annotations

import os.path as osp
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch

from .inference import DetectorBundle, _prep_image, results_to_per_class


def _default_norm(cfg):
    """The ``Normalize`` of the config's test (or val) pipeline, also
    inside a ``MultiScaleFlipAug``; ImageNet's when there is none."""
    norm = None
    pipeline = (cfg.data.get('test') or cfg.data.get('val') or {}) \
        .get('pipeline') if hasattr(cfg, 'data') else None
    if pipeline:
        for tr in pipeline:
            if tr.get('type') in ('Normalize',):
                norm = tr
            for sub in tr.get('transforms', []):
                if sub.get('type') == 'Normalize':
                    norm = sub
    return norm or dict(mean=[123.675, 116.28, 103.53],
                        std=[58.395, 57.12, 57.375], to_rgb=True)


def batched_eval(bundle: DetectorBundle, dataset,
                 batch_size: int = 8,
                 max_images: Optional[int] = None,
                 num_workers: int = 8,
                 progress: bool = True,
                 collect_dir: Optional[str] = None) -> List[List[np.ndarray]]:
    """Detections of the first ``max_images`` images of ``dataset``
    (default all), in batches of ``batch_size`` padded to the config's
    ``pad_size`` (the last batch padded with blank images). Returns the
    reference's format: per image, per class ``(n, 6)`` numpy arrays."""
    if collect_dir is not None:
        raise NotImplementedError('collect_dir (gathering results across '
                                  'processes) is ROADMAP A.13')
    cfg = bundle.cfg
    pad = cfg.get('pad_size') or (1024, 1024)
    # a device-normalizing bundle takes raw uint8 canvases
    norm = None if bundle.device_norm is not None else _default_norm(cfg)
    n = len(dataset) if max_images is None else min(max_images, len(dataset))

    def load(i):
        info = dataset.data_infos[i]
        img = _prep_image(osp.join(dataset.img_prefix, info['filename']),
                          norm)
        canvas = np.zeros((pad[0], pad[1], 3),
                          np.uint8 if norm is None else np.float32)
        h, w = min(img.shape[0], pad[0]), min(img.shape[1], pad[1])
        canvas[:h, :w] = img[:h, :w]
        return canvas

    results: List[List[np.ndarray]] = []
    batches = [list(range(i, min(i + batch_size, n)))
               for i in range(0, n, batch_size)]
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        pending = pool.map(load, batches[0]) if batches else None
        for b, chunk in enumerate(batches):
            imgs = np.stack(list(pending))
            if b + 1 < len(batches):            # read the next batch now
                pending = pool.map(load, batches[b + 1])
            if imgs.shape[0] < batch_size:
                fill = np.zeros((batch_size - imgs.shape[0],
                                 *imgs.shape[1:]), imgs.dtype)
                imgs = np.concatenate([imgs, fill], 0)
            dets, labels, valid = bundle(torch.from_numpy(imgs))
            dets, labels, valid = dets.cpu(), labels.cpu(), valid.cpu()
            for j in range(len(chunk)):
                results.append(results_to_per_class(
                    dets[j], labels[j], valid[j], bundle.num_classes))
            if progress and (b + 1) % 10 == 0:
                print(f'eval {min((b + 1) * batch_size, n)}/{n}')
    return results


def eval_from_state(bundle: DetectorBundle, state_dict, dataset,
                    batch_size: int = 8,
                    max_images: Optional[int] = None):
    """In-training evaluation (the reference's per-epoch ``EvalHook``,
    ``apis/train.py:104-132``): load ``state_dict`` (the trained model's,
    mmrotate names) into the persistent ``bundle``'s detector, run
    :func:`batched_eval` and the dataset's ``evaluate`` with its IoUs on the
    bundle's device. Returns ``{'mAP': ...}``."""
    bundle.detector.load_state_dict(state_dict)
    results = batched_eval(bundle, dataset, batch_size=batch_size,
                           max_images=max_images, progress=False)
    if max_images is not None and len(results) < len(dataset):
        old = dataset.data_infos
        try:
            dataset.data_infos = old[:len(results)]
            return dataset.evaluate(results, device=bundle.device)
        finally:
            dataset.data_infos = old
    return dataset.evaluate(results, device=bundle.device)
