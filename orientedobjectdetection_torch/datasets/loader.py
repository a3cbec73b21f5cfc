"""Batching and padding data loader (counterpart of
``orientedobjectdetection_tpu/datasets/loader.py``).

Every batch has fixed shapes: images padded to a static size, gts padded to
``max_gt`` with a mask, in the layout ``make_train_step`` takes. Samples
are decoded on a pool of threads (the PNG decode is zlib and numpy, which
release the interpreter lock for their large calls; the JPEG decode is host
C++ called through ctypes, which releases it), or on a persistent
pool of processes, while a producer thread keeps ``prefetch`` batches
ready; each batch's arrays become pinned host tensors when a card is
present, so their copies to it are asynchronous. ``shard_id`` /
``num_shards`` give each rank of a data-parallel run its share of every
epoch.
"""

from __future__ import annotations

import multiprocessing
import queue
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np
import torch

# The dataset of a worker process of the process pool: each worker gets it
# once, at the pool's start, and no task pickles it again.
_WORKER_DATASET = None


def _pool_init(dataset):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset
    torch.set_num_threads(1)


def _pool_get(i):
    return _WORKER_DATASET[i]


def _pool_fetch(task):
    idx, rng = task
    return _WORKER_DATASET.fetch(idx, rng)


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
    the last partial batch. Yields :func:`to_tensors` batches.

    ``shard_id`` / ``num_shards``: this rank's share of each epoch, the
    samples ``shard_id::num_shards`` of the shuffled order (every rank
    shuffles alike), ``len(dataset) // num_shards`` of them (the JAX
    package's host sharding, mmcv's ``DistributedSampler``).

    ``worker_type``: ``'thread'`` decodes on a thread pool; ``'process'``
    on a persistent pool of ``num_workers`` processes (mmcv's
    ``workers_per_gpu`` with ``persistent_workers``), started at the first
    epoch and reused, each forked holding the dataset. A sample's
    augmentation draws from its index and how often it was fetched
    (:meth:`..dota.DOTADataset.sample_rng`): the parent draws each fetch's
    generator and sends it with the index, so both give the same batches.
    A wrapper dataset (``ConcatDataset``, ...) is fetched whole in the
    worker, whose copies count their own fetches: its first epoch is the
    threads', later ones may differ. :meth:`close` ends the processes."""

    def __init__(self, dataset, batch_size: int, max_gt: int = 512,
                 pad_size=None, shuffle: bool = True, seed: int = 0,
                 num_workers: int = 8, prefetch: int = 4,
                 drop_last: bool = True, worker_type: str = 'thread',
                 shard_id: int = 0, num_shards: int = 1):
        if worker_type not in ('thread', 'process'):
            raise ValueError(f'worker_type must be thread or process, '
                             f'got {worker_type!r}')
        if not 0 <= shard_id < num_shards:
            raise ValueError(f'shard_id {shard_id} is not in [0, '
                             f'{num_shards})')
        self.dataset = dataset
        self.batch_size = batch_size
        self.max_gt = max_gt
        self.pad_size = pad_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.worker_type = worker_type
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.epoch = 0
        self._proc_pool = None

    def __len__(self):
        n = len(self.dataset) // self.num_shards
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def indices(self) -> np.ndarray:
        """This epoch's sample order, this shard's share of it."""
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        per = len(idx) // self.num_shards
        return idx[self.shard_id::self.num_shards][:per]

    def _process_pool(self):
        if self._proc_pool is None:
            ctx = multiprocessing.get_context('fork')
            self._proc_pool = ctx.Pool(self.num_workers,
                                       initializer=_pool_init,
                                       initargs=(self.dataset,))
        return self._proc_pool

    def close(self):
        """End the worker processes (a thread loader has none)."""
        if self._proc_pool is not None:
            self._proc_pool.terminate()
            self._proc_pool.join()
            self._proc_pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __iter__(self) -> Iterator[Dict]:
        idx = self.indices()
        nb = len(self)
        if self.worker_type == 'process':
            procs, pool = self._process_pool(), None
            ds = self.dataset

            def fetch(chunk):
                chunk = [int(i) for i in chunk]
                if hasattr(ds, 'sample_rng') and hasattr(ds, 'fetch'):
                    # the parent counts the fetches, as the threads do
                    return procs.map(_pool_fetch,
                                     [(i, ds.sample_rng(i)) for i in chunk])
                return procs.map(_pool_get, chunk)
        else:
            pool = ThreadPoolExecutor(max_workers=self.num_workers)

            def fetch(chunk):
                return list(pool.map(self.dataset.__getitem__, chunk))
        q: 'queue.Queue' = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        failure = []

        def produce():
            try:
                for b in range(nb):
                    if stop.is_set():
                        return
                    chunk = idx[b * self.batch_size:(b + 1) * self.batch_size]
                    samples = fetch(chunk)
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
            if pool is not None:
                pool.shutdown(wait=True)
        self.epoch += 1
