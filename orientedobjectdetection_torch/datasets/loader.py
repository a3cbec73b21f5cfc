"""Batching and padding data loader (counterpart of
``orientedobjectdetection_tpu/datasets/loader.py``).

Every batch has fixed shapes: images padded to a static size, gts padded to
``max_gt`` with a mask, in the layout ``make_train_step`` takes. Samples
are decoded on a pool of threads (the PNG decode is zlib and numpy, which
release the interpreter lock for their large calls) while a producer thread
keeps ``prefetch`` batches ready; each batch's arrays become pinned host
tensors when a card is present, so their copies to it are asynchronous.
"""

from __future__ import annotations

import queue
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np
import torch


def strip_host_normalize(dataset_cfg):
    """Remove the top-level ``Normalize`` from a dataset config's pipeline.

    Returns ``(new_cfg, norm_dict_or_None)``: with a ``Normalize`` found,
    the pipeline keeps raw uint8 images and the returned ``img_norm_cfg``
    is applied on the device in the train step
    (``parallel/train_state.py:normalize_images``), which also sends a
    quarter of the bytes. A config without one is returned unchanged with
    ``None``."""
    cfg = dict(dataset_cfg)
    pipeline = cfg.get('pipeline')
    if not pipeline:
        return cfg, None
    norm, kept = None, []
    for tr in pipeline:
        if (norm is None and isinstance(tr, dict)
                and tr.get('type') == 'Normalize'):
            norm = {k: v for k, v in tr.items() if k != 'type'}
        else:
            kept.append(tr)
    if norm is None:
        return cfg, None
    cfg['pipeline'] = kept
    return cfg, norm


def pad_collate(samples, max_gt: int = 512, pad_size=None) -> Dict:
    """Pipeline outputs -> one fixed-shape batch of numpy arrays.

    A sample with more than ``max_gt`` gts keeps the ``max_gt`` of largest
    area; the next ``max_gt`` of the rest go to ``gt_ignore`` /
    ``gt_ignore_mask``, so the assigner masks their anchors instead of
    training them as background (JAX ``loader.py:pad_collate``). Images
    keep the samples' dtype when it is uint8 (device normalization) and are
    float32 otherwise."""
    imgs = [s['img'] for s in samples]
    if pad_size is None:
        h = max(i.shape[0] for i in imgs)
        w = max(i.shape[1] for i in imgs)
    else:
        h, w = pad_size
    b = len(samples)
    img_dtype = imgs[0].dtype if imgs[0].dtype == np.uint8 else np.float32
    images = np.zeros((b, h, w, 3), img_dtype)
    gt_bboxes = np.zeros((b, max_gt, 5), np.float32)
    gt_labels = np.zeros((b, max_gt), np.int32)
    gt_mask = np.zeros((b, max_gt), bool)
    gt_ignore = np.zeros((b, max_gt, 5), np.float32)
    gt_ignore_mask = np.zeros((b, max_gt), bool)
    metas = []
    for i, s in enumerate(samples):
        im = s['img']
        images[i, :im.shape[0], :im.shape[1]] = im
        boxes = s.get('gt_bboxes')
        if boxes is not None and len(boxes):
            boxes = np.asarray(boxes)
            labels = np.asarray(s['gt_labels'])
            if len(boxes) > max_gt:
                warnings.warn(
                    f'pad_collate: {len(boxes)} gts > max_gt={max_gt}; '
                    'keeping the largest-area boxes, masking the rest as '
                    'ignore regions. Raise max_gt in the data config to '
                    'keep all.')
                order = np.argsort(-(boxes[:, 2] * boxes[:, 3]))
                keep, drop = order[:max_gt], order[max_gt:max_gt * 2]
                gt_ignore[i, :len(drop)] = boxes[drop]
                gt_ignore_mask[i, :len(drop)] = True
                boxes, labels = boxes[keep], labels[keep]
            n = len(boxes)
            gt_bboxes[i, :n] = boxes
            gt_labels[i, :n] = labels
            gt_mask[i, :n] = True
        metas.append(s.get('img_metas', {}))
    return dict(images=images, gt_bboxes=gt_bboxes, gt_labels=gt_labels,
                gt_mask=gt_mask, gt_ignore=gt_ignore,
                gt_ignore_mask=gt_ignore_mask, img_metas=metas)


def to_tensors(batch: Dict) -> Dict:
    """A :func:`pad_collate` batch -> host tensors (``img_metas`` stays a
    list), pinned when a card is present."""
    pin = torch.cuda.is_available()
    out = {}
    for k, v in batch.items():
        if k == 'img_metas':
            out[k] = v
            continue
        t = torch.from_numpy(v)
        out[k] = t.pin_memory() if pin else t
    return out


class DataLoader:
    """Shuffling, prefetching loader over a map-style dataset: epoch ``e``
    shuffles with ``np.random.default_rng(seed + e)``; ``drop_last`` drops
    the last partial batch. Yields :func:`to_tensors` batches."""

    def __init__(self, dataset, batch_size: int, max_gt: int = 512,
                 pad_size=None, shuffle: bool = True, seed: int = 0,
                 num_workers: int = 8, prefetch: int = 4,
                 drop_last: bool = True, worker_type: str = 'thread'):
        if worker_type == 'process':
            raise NotImplementedError('worker_type="process" (a process '
                                      'pool of decoders) is ROADMAP A.13')
        if worker_type != 'thread':
            raise ValueError(f'worker_type must be thread or process, '
                             f'got {worker_type!r}')
        self.dataset = dataset
        self.batch_size = batch_size
        self.max_gt = max_gt
        self.pad_size = pad_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def indices(self) -> np.ndarray:
        """This epoch's sample order."""
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[Dict]:
        idx = self.indices()
        nb = len(self)
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        q: 'queue.Queue' = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        failure = []

        def produce():
            try:
                for b in range(nb):
                    if stop.is_set():
                        return
                    chunk = idx[b * self.batch_size:(b + 1) * self.batch_size]
                    samples = list(pool.map(self.dataset.__getitem__, chunk))
                    q.put(to_tensors(pad_collate(samples, self.max_gt,
                                                 self.pad_size)))
            except BaseException as e:        # re-raised in the consumer
                failure.append(e)
            finally:
                q.put(None)

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    break
                yield batch
            if failure:
                raise failure[0]
        finally:
            stop.set()
            while producer.is_alive():      # unblock a producer at q.put
                try:
                    q.get_nowait()
                except queue.Empty:
                    producer.join(timeout=0.01)
            pool.shutdown(wait=True)
        self.epoch += 1
