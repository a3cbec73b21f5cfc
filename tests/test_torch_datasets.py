"""The port's data path (``datasets/``: ``DOTADataset``, its pipeline,
``pad_collate`` and ``DataLoader``) against the JAX package's on the same
on-disk set: synth-hard images of 256 px with 10-30 instances from the
port's generator, batches of 2, ``max_gt`` 8 so that most images overflow
into ``gt_ignore``.

The annotations go through ``poly2obb_np``: OpenCV's float32 rectangle
and the port's float64 one agree within 1e-4 px and 1e-5 rad (modulo pi),
except where OpenCV keeps another least rectangle of a polygon, whose area
equals the port's to float32 rounding (``tests/test_torch_boxes_np.py``).
The synthetic polygons are rectangles rounded to 0.1 px, where such
near-ties occur, so the loaders are compared on the same annotations (the
JAX dataset's ``data_infos`` set to the port's): then flips are forced
(``flip_ratio`` 1.0 or 0.0) so that both packages flip alike, both shuffle
with ``default_rng(seed + epoch)``, images are exact (raw uint8, or
normalized on the host in float32 by the same numpy operations), labels,
masks and ignore masks exact, and boxes within 1e-5.
"""

import numpy as np
import pytest

from orientedobjectdetection_tpu.datasets import \
    build_dataset as jax_build_dataset
from orientedobjectdetection_tpu.datasets.loader import \
    DataLoader as JaxLoader
from orientedobjectdetection_tpu.datasets.loader import \
    strip_host_normalize as jax_strip
from orientedobjectdetection_torch.datasets import (DataLoader, build_dataset,
                                                    pad_collate,
                                                    strip_host_normalize)
from orientedobjectdetection_torch.tools.generate_synth import \
    generate_synth_hard

SIZE = 256
NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
            to_rgb=True)


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('hard'))
    generate_synth_hard(root, num_images=5, size=SIZE, seed=1,
                        n_range=(10, 30))
    return root


def dataset_cfg(root, version, flip_ratio):
    return dict(
        type='DOTADataset', version=version,
        ann_file=f'{root}/trainval/annfiles/',
        img_prefix=f'{root}/trainval/images/',
        pipeline=[dict(type='LoadImageFromFile'),
                  dict(type='LoadAnnotations', with_bbox=True),
                  dict(type='RResize', img_scale=(SIZE, SIZE)),
                  dict(type='RRandomFlip', flip_ratio=flip_ratio,
                       version=version),
                  dict(type='Normalize', **NORM),
                  dict(type='Pad', size_divisor=32),
                  dict(type='Collect', keys=['img', 'gt_bboxes',
                                             'gt_labels'])])


def angle_gap(got, ref):
    return np.abs((got - ref + np.pi / 2) % np.pi - np.pi / 2)


@pytest.mark.parametrize('version', ['le90', 'oc'])
def test_annotations_match_jax(root, version):
    cfg = dataset_cfg(root, version, 0.0)
    got, ref = build_dataset(cfg), jax_build_dataset(cfg)
    assert len(got) == len(ref) == 5
    ties = total = 0
    for g, r in zip(got.data_infos, ref.data_infos):
        assert g['filename'] == r['filename']
        np.testing.assert_array_equal(g['ann']['labels'], r['ann']['labels'])
        assert g['ann']['bboxes_ignore'].shape == (0, 5)
        gb, rb = g['ann']['bboxes'], r['ann']['bboxes']
        close = (np.abs(gb[:, :4] - rb[:, :4]).max(1) <= 1e-4) & \
            (angle_gap(gb[:, 4], rb[:, 4]) <= 1e-5)
        # a near-tie: another least rectangle of the same polygon
        area, ref_area = gb[:, 2] * gb[:, 3], rb[:, 2] * rb[:, 3]
        assert (np.abs(area - ref_area) <= 1e-4 * area)[~close].all()
        ties += int((~close).sum())
        total += len(gb)
    assert ties <= 0.1 * total


@pytest.mark.parametrize('version,flip_ratio,host_norm', [
    ('le90', 1.0, False), ('le90', 0.0, True), ('oc', 1.0, True)])
def test_loader_batches_match_jax(root, version, flip_ratio, host_norm):
    cfg = dataset_cfg(root, version, flip_ratio)
    if host_norm:
        ours, theirs = cfg, cfg
    else:
        ours, norm = strip_host_normalize(cfg)
        theirs, jax_norm = jax_strip(cfg)
        assert norm == jax_norm
    kwargs = dict(batch_size=2, max_gt=8, pad_size=(SIZE, SIZE), seed=3,
                  num_workers=2, drop_last=False)
    got_data, ref_data = build_dataset(ours), jax_build_dataset(theirs)
    ref_data.data_infos = got_data.data_infos
    got_loader = DataLoader(got_data, **kwargs)
    ref_loader = JaxLoader(ref_data, **kwargs)
    overflowed = 0
    for epoch in range(2):
        np.testing.assert_array_equal(got_loader.indices(),
                                      ref_loader._indices())
        got_batches, ref_batches = list(got_loader), list(ref_loader)
        assert len(got_batches) == len(ref_batches) == 3
        for got, ref in zip(got_batches, ref_batches):
            images = got['images'].numpy()
            assert images.dtype == ref['images'].dtype == (
                np.float32 if host_norm else np.uint8)
            np.testing.assert_array_equal(images, ref['images'])
            for key in ('gt_labels', 'gt_mask', 'gt_ignore_mask'):
                np.testing.assert_array_equal(got[key].numpy(), ref[key])
            for key in ('gt_bboxes', 'gt_ignore'):
                np.testing.assert_allclose(got[key].numpy(), ref[key],
                                           rtol=0, atol=1e-5)
            assert [m['flip'] for m in got['img_metas']] == \
                [bool(flip_ratio)] * len(got['img_metas'])
            overflowed += int(ref['gt_ignore_mask'].any(1).sum())
    assert got_loader.epoch == ref_loader.epoch == 2
    assert overflowed >= 4                 # the max_gt overflow ran


def test_pad_collate_keeps_the_largest_and_ignores_the_next():
    rng = np.random.default_rng(0)
    boxes = np.stack([rng.uniform(0, 64, 20), rng.uniform(0, 64, 20),
                      rng.uniform(1, 30, 20), rng.uniform(1, 30, 20),
                      rng.uniform(-1, 1, 20)], -1).astype(np.float32)
    sample = dict(img=np.zeros((64, 64, 3), np.uint8), gt_bboxes=boxes,
                  gt_labels=np.arange(20))
    with pytest.warns(UserWarning, match='max_gt'):
        batch = pad_collate([sample], max_gt=6)
    order = np.argsort(-(boxes[:, 2] * boxes[:, 3]))
    np.testing.assert_array_equal(batch['gt_bboxes'][0], boxes[order[:6]])
    np.testing.assert_array_equal(batch['gt_labels'][0], order[:6])
    np.testing.assert_array_equal(batch['gt_ignore'][0], boxes[order[6:12]])
    assert batch['gt_mask'].all() and batch['gt_ignore_mask'].all()


def test_loader_refuses_the_process_pool(root):
    """An unknown worker type is refused; ``worker_type='process'`` (the
    persistent pool of JAX ``loader.py:177-191``) yields the thread
    loader's batches, random flips included, over two epochs of one pool,
    which ``close`` ends."""
    with pytest.raises(ValueError, match='worker_type'):
        DataLoader(build_dataset(dataset_cfg(root, 'le90', 0.0)), 2,
                   worker_type='fiber')
    cfg = dataset_cfg(root, 'le90', 0.5)
    kw = dict(batch_size=2, max_gt=8, pad_size=(SIZE, SIZE), seed=3,
              num_workers=2, drop_last=False)
    threads = DataLoader(build_dataset(cfg, seed=7), worker_type='thread',
                         **kw)
    procs = DataLoader(build_dataset(cfg, seed=7), worker_type='process',
                       **kw)
    try:
        for _ in range(2):
            for a, b in zip(threads, procs, strict=True):
                assert [m['flip'] for m in a['img_metas']] == \
                    [m['flip'] for m in b['img_metas']]
                for k in ('images', 'gt_bboxes', 'gt_labels', 'gt_mask'):
                    assert np.array_equal(a[k].numpy(), b[k].numpy()), k
        assert procs._proc_pool is not None
    finally:
        procs.close()
    assert procs._proc_pool is None


def test_random_flips_follow_the_seed_not_the_threads(root):
    """Each fetch draws from its own generator (seed, index, fetch count):
    one thread or four, the same flips in every epoch."""
    cfg = dataset_cfg(root, 'le90', 0.5)
    runs = []
    for workers in (1, 4, 4):
        loader = DataLoader(build_dataset(cfg, seed=7), 2, max_gt=8,
                            pad_size=(SIZE, SIZE), seed=3,
                            num_workers=workers, drop_last=False)
        runs.append([[m['flip'] for m in batch['img_metas']]
                     for _ in range(3) for batch in loader])
    assert runs[0] == runs[1] == runs[2]
    flips = sum(runs[0], [])
    assert any(flips) and not all(flips)


def test_random_flip_draws_only_from_the_fetch_generator():
    """``RRandomFlip`` has no generator of its own: results without the
    dataset's ``rng`` are refused, and two equal generators flip alike."""
    from orientedobjectdetection_torch.datasets.pipelines import RRandomFlip
    flip = RRandomFlip(flip_ratio=0.5, version='le90')
    img = np.zeros((4, 4, 3), np.uint8)
    with pytest.raises(KeyError, match='rng'):
        flip(dict(img=img, img_shape=img.shape))
    drawn = [[flip(dict(img=img, img_shape=img.shape,
                        rng=np.random.default_rng([5, k])))['flip']
              for k in range(16)] for _ in range(2)]
    assert drawn[0] == drawn[1] and any(drawn[0]) and not all(drawn[0])
