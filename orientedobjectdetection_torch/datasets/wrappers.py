"""Dataset wrappers (counterpart of
``orientedobjectdetection_tpu/datasets/wrappers.py``; the reference's
``datasets/builder.py:49`` delegates to mmdet's ``ConcatDataset``,
``ClassBalancedDataset`` and ``MultiImageMixDataset``). Each builds the
datasets it wraps from their configs, handing on ``seed``."""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from ..utils.registry import DATASETS
from .dota import FetchRng
from .pipelines import Compose


def _build(cfg, seed):
    if not isinstance(cfg, dict):
        return cfg
    from . import build_dataset
    return build_dataset(cfg, seed=seed)


@DATASETS.register_module()
class ConcatDataset:
    """Several datasets one after the other; ``CLASSES`` of the first."""

    def __init__(self, datasets, seed: Optional[int] = None):
        self.datasets = [_build(d, seed) for d in datasets]
        self.CLASSES = self.datasets[0].CLASSES
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def _locate(self, idx):
        k = int(np.searchsorted(self._offsets, idx, side='right') - 1)
        return self.datasets[k], idx - int(self._offsets[k])

    def __getitem__(self, idx):
        ds, i = self._locate(idx)
        return ds[i]

    def get_ann_info(self, idx):
        ds, i = self._locate(idx)
        return ds.get_ann_info(i)


@DATASETS.register_module()
class ClassBalancedDataset:
    """Repeat-factor sampling (mmdet's ``ClassBalancedDataset``, the LVIS
    recipe): an image whose rarest class is in a share ``f`` of the images
    appears ``ceil(max(1, sqrt(oversample_thr / f)))`` times."""

    def __init__(self, dataset, oversample_thr: float = 1e-3,
                 seed: Optional[int] = None):
        self.dataset = _build(dataset, seed)
        self.CLASSES = self.dataset.CLASSES
        n = len(self.dataset)
        counts = np.zeros(len(self.CLASSES), np.int64)
        img_cats = []
        for i in range(n):
            labels = np.unique(self.dataset.get_ann_info(i)['labels'])
            img_cats.append(labels)
            counts[labels] += 1
        freq = np.maximum(counts / max(n, 1), 1e-12)
        cat_repeat = np.maximum(1.0, np.sqrt(oversample_thr / freq))
        indices = []
        for i, cats in enumerate(img_cats):
            r = cat_repeat[cats].max() if len(cats) else 1.0
            indices.extend([i] * int(math.ceil(r)))
        self._indices = np.asarray(indices)

    def __len__(self):
        return len(self._indices)

    def __getitem__(self, idx):
        return self.dataset[int(self._indices[idx])]

    def get_ann_info(self, idx):
        return self.dataset.get_ann_info(int(self._indices[idx]))


@DATASETS.register_module()
class MultiImageMixDataset:
    """A dataset whose samples go through one more ``pipeline`` of mix
    transforms: before an :class:`RMosaic` three more samples, drawn with
    replacement, join ``results['mix_results']``. The draws and the mix
    transforms' own come from this wrapper's generator of the fetch
    (``results['rng']``; JAX draws from numpy's global generator); a mix
    sample is fetched with a generator drawn from it (through the wrapped
    dataset's ``fetch`` where it has one), so the wrapped dataset's own
    fetch counts do not depend on the loader's thread order. A transform
    that drops the sample makes the fetch return None, as in the JAX
    package."""

    MIX_TRANSFORMS = ('RMosaic',)

    def __init__(self, dataset, pipeline=None, seed: Optional[int] = None):
        self.dataset = _build(dataset, seed)
        self.CLASSES = self.dataset.CLASSES
        self.pipeline = Compose(pipeline) if pipeline else None
        self._rng = FetchRng(None if seed is None else [seed, 1])

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        results = self.dataset[idx]
        if self.pipeline is None:
            return results
        return self.mix(results, self._rng(idx))

    def mix(self, results, rng: np.random.Generator):
        """The wrapper's pipeline over ``results`` with draws from
        ``rng``."""
        results['rng'] = rng
        for t in self.pipeline.transforms:
            if type(t).__name__ in self.MIX_TRANSFORMS:
                idxs = rng.integers(0, len(self.dataset), 3)
                results['mix_results'] = [self.mix_sample(int(i), rng)
                                          for i in idxs]
            results = t(results)
            if results is None:
                return None
            results.pop('mix_results', None)
        results.pop('rng', None)
        return results

    def mix_sample(self, idx: int, rng: np.random.Generator):
        fetch = getattr(self.dataset, 'fetch', None)
        if fetch is None:
            return self.dataset[idx]
        return fetch(idx, np.random.default_rng(rng.integers(1 << 63)))

    def get_ann_info(self, idx):
        return self.dataset.get_ann_info(idx)
