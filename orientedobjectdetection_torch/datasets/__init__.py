"""DOTA-layout datasets, their pipeline and the batching loader
(counterpart of ``orientedobjectdetection_tpu/datasets``; HRSC and the
dataset wrappers are ROADMAP A.4b)."""

from ..utils.registry import DATASETS, PIPELINES
from . import pipelines  # noqa: F401  (registers the transforms)
from .dota import DOTADataset, DOTAv2Dataset, DOTAv15Dataset, SARDataset
from .loader import DataLoader, pad_collate, strip_host_normalize


def build_dataset(cfg, **default_args):
    """A dataset from its config dict (``type`` names the class);
    ``default_args`` fill keys the config leaves out (``seed``)."""
    return DATASETS.build(dict(cfg), **default_args)


__all__ = [
    'DOTADataset', 'DOTAv15Dataset', 'DOTAv2Dataset', 'SARDataset',
    'DataLoader', 'pad_collate', 'strip_host_normalize', 'build_dataset',
    'DATASETS', 'PIPELINES',
]
