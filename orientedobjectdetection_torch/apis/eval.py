"""Batched evaluation (counterpart of
``orientedobjectdetection_tpu/apis/eval.py``; the reference's
``single_gpu_test`` loop, ``tools/test.py:14`` and mmdet's apis).

A fixed batch size: images are read on a pool of threads while the card
runs the previous batch. In a process group of several ranks
(``parallel/mesh.py``) each rank evaluates every ``world_size``-th image
and the ranks exchange their parts through files in ``collect_dir`` (the
reference's ``multi_gpu_test`` with ``collect_results_cpu``).
"""

from __future__ import annotations

import os
import os.path as osp
import pickle
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch

from ..parallel import mesh
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
    reference's format: per image, per class ``(n, 6)`` numpy arrays.

    In a process group, rank r evaluates the images ``i % world_size ==
    r`` and every rank returns the whole list, gathered through
    ``collect_dir`` (:func:`collect_results`), a directory that every rank
    sees; it must be given then, as in the JAX package. One process reads
    no ``collect_dir``."""
    cfg = bundle.cfg
    pad = cfg.get('pad_size') or (1024, 1024)
    # a device-normalizing bundle takes raw uint8 canvases
    norm = None if bundle.device_norm is not None else _default_norm(cfg)
    n = len(dataset) if max_images is None else min(max_images, len(dataset))
    if mesh.is_distributed():
        if collect_dir is None:
            raise ValueError('evaluating over several processes needs '
                             'collect_dir, a directory every rank sees '
                             '(the temporary directory may be per host); '
                             'pass collect_dir= or tools.test '
                             '--collect-dir')
        mine = list(range(mesh.rank(), n, mesh.world_size()))
        part = _eval_indices(bundle, dataset, mine, batch_size, num_workers,
                             pad, norm, progress)
        return collect_results(part, mine, n, collect_dir)
    return _eval_indices(bundle, dataset, list(range(n)), batch_size,
                         num_workers, pad, norm, progress)


def _eval_indices(bundle, dataset, idx, batch_size, num_workers, pad, norm,
                  progress):
    """Detections of the images ``idx`` of ``dataset``, in order."""
    n = len(idx)

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
    batches = [idx[i:i + batch_size] for i in range(0, n, batch_size)]
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


# The number of gathers this process has made: a part of each gather's
# directory name, so that a rank that runs ahead into the next gather never
# writes where a slower one still reads.
_GATHER_ROUND = [0]


def collect_results(part, indices, total: int, collect_dir: str) -> list:
    """The file-based gather of the ranks' parts (mmdet's
    ``collect_results_cpu``, JAX ``apis/eval.py:_collect_results``): each
    rank pickles ``(indices, part)`` to
    ``collect_dir/round_<k>/part_<rank>.pkl`` atomically (a temporary file,
    then a rename); after a barrier every rank reads all parts and puts
    each result at its index; after a second barrier rank 0 removes the
    round's directory."""
    round_dir = osp.join(collect_dir, f'round_{_GATHER_ROUND[0]}')
    _GATHER_ROUND[0] += 1
    os.makedirs(round_dir, exist_ok=True)
    rank = mesh.rank()
    path = osp.join(round_dir, f'part_{rank}.pkl')
    with open(path + '.tmp', 'wb') as f:
        pickle.dump((list(indices), part), f)
    os.replace(path + '.tmp', path)
    mesh.barrier()                       # every part written
    merged: list = [None] * total
    for r in range(mesh.world_size()):
        with open(osp.join(round_dir, f'part_{r}.pkl'), 'rb') as f:
            idx, res = pickle.load(f)
        for i, item in zip(idx, res):
            merged[i] = item
    mesh.barrier()                       # every part read
    if rank == 0:
        shutil.rmtree(round_dir, ignore_errors=True)
    return merged


def eval_from_state(bundle: DetectorBundle, state_dict, dataset,
                    batch_size: int = 8,
                    max_images: Optional[int] = None,
                    collect_dir: Optional[str] = None):
    """In-training evaluation (the reference's per-epoch ``EvalHook``,
    ``apis/train.py:104-132``): load ``state_dict`` (the trained model's,
    mmrotate names) into the persistent ``bundle``'s detector, run
    :func:`batched_eval` (over the ranks through ``collect_dir`` in a
    process group) and the dataset's ``evaluate`` with its IoUs on the
    bundle's device. Returns ``{'mAP': ...}``, the same on every rank."""
    bundle.load_state_dict(state_dict)
    results = batched_eval(bundle, dataset, batch_size=batch_size,
                           max_images=max_images, progress=False,
                           collect_dir=collect_dir)
    if max_images is not None and len(results) < len(dataset):
        old = dataset.data_infos
        try:
            dataset.data_infos = old[:len(results)]
            return dataset.evaluate(results, device=bundle.device)
        finally:
            dataset.data_infos = old
    return dataset.evaluate(results, device=bundle.device)
