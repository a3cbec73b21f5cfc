"""Port parity, the dataset wrappers (``datasets/wrappers.py``) against the
JAX package's on the same synth-hard tiles: ``ConcatDataset`` (lengths,
index mapping, annotations), ``ClassBalancedDataset`` (the repeat
factors: the same index list) and ``MultiImageMixDataset`` with ``RMosaic``
(the same mix indices and centre: exact float32 canvas, boxes and labels),
all built from configs by ``build_dataset``; the loader carries the mosaic's
float32 canvas exactly (``pad_collate``, ``DataLoader``).

Both packages read the same annotations: the JAX datasets' ``data_infos``
are set to the port's (OpenCV's float32 ``minAreaRect`` may keep another
least rectangle of a rounded polygon, ``tests/test_torch_datasets.py``)."""

import numpy as np
import pytest
import torch

from orientedobjectdetection_tpu.datasets import \
    build_dataset as jax_build_dataset
from orientedobjectdetection_tpu.datasets.loader import \
    pad_collate as jax_pad_collate
from orientedobjectdetection_torch.datasets import (DataLoader, build_dataset,
                                                    pad_collate,
                                                    strip_host_normalize)
from orientedobjectdetection_torch.tools.generate_synth import \
    generate_synth_hard

SIZE = 96


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('wrap'))
    generate_synth_hard(root, num_images=4, size=SIZE, seed=2,
                        n_range=(3, 12))
    generate_synth_hard(root, num_images=3, size=SIZE, seed=3, split='val',
                        n_range=(3, 12))
    return root


def dota(root, split='trainval', pipeline=None):
    return dict(type='DOTADataset', version='le90',
                ann_file=f'{root}/{split}/annfiles/',
                img_prefix=f'{root}/{split}/images/',
                pipeline=pipeline if pipeline is not None else [
                    dict(type='LoadImageFromFile'),
                    dict(type='LoadAnnotations', with_bbox=True)])


def share_infos(port, jax_ds):
    """Give every JAX dataset inside the port's annotations."""
    for p, j in zip(inner(port), inner(jax_ds)):
        j.data_infos = p.data_infos


def inner(ds):
    if hasattr(ds, 'datasets'):
        return [d for sub in ds.datasets for d in inner(sub)]
    if hasattr(ds, 'dataset'):
        return inner(ds.dataset)
    return [ds]


def test_concat_dataset_matches_jax(root):
    cfg = dict(type='ConcatDataset', datasets=[dota(root), dota(root, 'val')])
    port, ref = build_dataset(cfg, seed=0), jax_build_dataset(cfg)
    share_infos(port, ref)
    assert len(port) == len(ref) == 7
    assert port.CLASSES == ref.CLASSES
    for i in range(len(port)):
        g, r = port.get_ann_info(i), ref.get_ann_info(i)
        np.testing.assert_array_equal(g['labels'], r['labels'])
        got, want = port[i], ref[i]
        np.testing.assert_array_equal(got['img'], want['img'])
        np.testing.assert_array_equal(got['gt_bboxes'], want['gt_bboxes'])
    assert port[4]['filename'].endswith('val/images/D0000.png')


@pytest.mark.parametrize('thr', [1e-3, 0.3, 0.9])
def test_class_balanced_dataset_matches_jax(root, thr):
    cfg = dict(type='ClassBalancedDataset', oversample_thr=thr,
               dataset=dict(type='ConcatDataset',
                            datasets=[dota(root), dota(root, 'val')]))
    port, ref = build_dataset(cfg, seed=0), jax_build_dataset(cfg)
    np.testing.assert_array_equal(port._indices, ref._indices)   # labels
    share_infos(port, ref)
    assert len(port) == len(ref) >= 7
    if thr == 0.9:
        assert len(port) > 7           # rare classes repeat their images
    for i in range(len(port)):
        np.testing.assert_array_equal(port.get_ann_info(i)['bboxes'],
                                      ref.get_ann_info(i)['bboxes'])


class FixedDraws:
    """A generator stand-in: ``integers(lo, hi, 3)`` gives the mix
    indices, ``integers(n)`` a seed for a mix sample's own generator,
    ``uniform`` the mosaic centre's ratios."""

    def __init__(self, idxs, ratios):
        self.idxs, self.ratios = np.asarray(idxs), list(ratios)

    def integers(self, lo, hi=None, size=None):
        return self.idxs if size == 3 else 0

    def uniform(self, lo, hi):
        return self.ratios.pop(0)


@pytest.mark.parametrize('idxs,ratios', [([1, 2, 3], [1.0, 1.0]),
                                         ([0, 0, 3], [0.6, 1.37]),
                                         ([3, 1, 1], [1.49, 0.51])])
def test_multi_image_mix_matches_jax(root, monkeypatch, idxs, ratios):
    mosaic = [dict(type='RMosaic', img_scale=(SIZE, SIZE))]
    cfg = dict(type='MultiImageMixDataset', dataset=dota(root),
               pipeline=mosaic)
    port, ref = build_dataset(cfg, seed=0), jax_build_dataset(cfg)
    share_infos(port, ref)
    got = port.mix(port.dataset[0], FixedDraws(idxs, ratios))
    monkeypatch.setattr(np.random, 'randint',
                        lambda lo, hi, size=None: np.asarray(idxs))
    jax_ratios = list(ratios)
    monkeypatch.setattr(np.random, 'uniform',
                        lambda lo, hi: jax_ratios.pop(0))
    want = ref[0]
    assert got['img'].dtype == want['img'].dtype == np.float32
    assert got['img'].shape == (2 * SIZE, 2 * SIZE, 3)
    for key in ('img', 'gt_bboxes', 'gt_labels'):
        np.testing.assert_array_equal(got[key], want[key])
    assert 'rng' not in got and 'mix_results' not in got
    # the float32 canvas goes through the loader's collate exactly
    batch, jax_batch = pad_collate([got], 64), jax_pad_collate([want], 64)
    for key in ('images', 'gt_bboxes', 'gt_labels', 'gt_mask'):
        np.testing.assert_array_equal(batch[key], jax_batch[key])
    assert batch['images'].dtype == np.float32


def test_multi_image_mix_through_the_loader(root):
    """Config -> strip the host Normalize -> loader: float32 batches whose
    canvases hold exact integers and the pad value; the same batches in
    any thread order."""
    cfg = dict(type='MultiImageMixDataset', dataset=dota(root),
               pipeline=[dict(type='RMosaic', img_scale=(SIZE, SIZE)),
                         dict(type='Normalize', mean=[0, 0, 0],
                              std=[1, 1, 1], to_rgb=True)])
    cfg, norm = strip_host_normalize(cfg)
    assert norm is not None and len(cfg['pipeline']) == 1
    runs = []
    for workers in (1, 3):
        loader = DataLoader(build_dataset(cfg, seed=5), 2, max_gt=64,
                            pad_size=(2 * SIZE, 2 * SIZE), seed=1,
                            num_workers=workers)
        runs.append([b for b in loader])
    for a, b in zip(*runs):
        assert a['images'].dtype == torch.float32
        assert torch.equal(a['images'], b['images'])
        assert torch.equal(a['gt_bboxes'], b['gt_bboxes'])
        img = a['images']
        assert torch.equal(img, img.round()) and (img == 114).any()
