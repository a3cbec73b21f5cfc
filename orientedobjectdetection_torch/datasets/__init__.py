"""Datasets (DOTA layout, HRSC2016), their pipeline, the dataset wrappers
and the batching loader (counterpart of
``orientedobjectdetection_tpu/datasets``)."""

from ..utils.registry import DATASETS, PIPELINES
from . import pipelines  # noqa: F401  (registers the transforms)
from .dota import DOTADataset, DOTAv2Dataset, DOTAv15Dataset, SARDataset
from .hrsc import HRSCDataset
from .loader import DataLoader, pad_collate, strip_host_normalize
from .wrappers import (ClassBalancedDataset, ConcatDataset,
                       MultiImageMixDataset)


def build_dataset(cfg, **default_args):
    """A dataset from its config dict (``type`` names the class);
    ``default_args`` fill keys the config leaves out (``seed``)."""
    return DATASETS.build(dict(cfg), **default_args)


__all__ = [
    'DOTADataset', 'DOTAv15Dataset', 'DOTAv2Dataset', 'SARDataset',
    'HRSCDataset', 'ConcatDataset', 'ClassBalancedDataset',
    'MultiImageMixDataset', 'DataLoader', 'pad_collate',
    'strip_host_normalize', 'build_dataset', 'DATASETS', 'PIPELINES',
]
