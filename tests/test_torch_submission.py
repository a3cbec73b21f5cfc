"""Port parity, the DOTA submission path: ``DOTADataset.merge_det`` and
``format_results`` against the JAX package's on the tiles of two 512 px
synthetic scenes (split by the port's ``tools.img_split``), and the
``tools.test`` flags ``--format-only`` and ``--tta`` on the CPU.

Merged detections are exact (translation, selection and a rotated NMS of
the same boxes: the same keep lists), so the Task1 files are byte-equal.
The command line is held to the port's own entry points, which
``tests/test_torch_patch.py`` holds to JAX."""

import os
import zipfile

import numpy as np
import pytest
import torch

from orientedobjectdetection_tpu.datasets import \
    build_dataset as jax_build_dataset
from orientedobjectdetection_torch.apis import (inference_detector_tta,
                                                init_detector)
from orientedobjectdetection_torch.apis.eval import batched_eval
from orientedobjectdetection_torch.datasets import build_dataset
from orientedobjectdetection_torch.tools import img_split
from orientedobjectdetection_torch.tools.generate_synth import generate_synth

torch.set_num_threads(2)

CONFIG = os.path.join(os.path.dirname(__file__), '..', 'configs',
                      'rotated_retinanet', 'rotated_retinanet_tiny_synth.py')


@pytest.fixture(scope='module')
def split(tmp_path_factory):
    """Two 512 px scenes with up to 12 objects, tiled at 256 px with a
    64 px gap; the tiles' DOTA datasets of both packages."""
    root = tmp_path_factory.mktemp('sub')
    generate_synth(str(root / 'big'), num_images=2, size=512, seed=7,
                   split='test', max_objs=12)
    img_split.main(['--img-dirs', str(root / 'big/test/images'),
                    '--ann-dirs', str(root / 'big/test/annfiles'),
                    '--save-dir', str(root / 'split'), '--sizes', '256',
                    '--gaps', '64', '--nproc', '2'])
    spec = dict(type='DOTADataset', version='le90', test_mode=True,
                filter_empty_gt=False,
                ann_file=str(root / 'split/annfiles') + '/',
                img_prefix=str(root / 'split/images') + '/', pipeline=[])
    return root, build_dataset(spec), jax_build_dataset(spec)


def tile_results(dataset, seed, per_class=6):
    """Per tile, per class (n, 6) detections in the tile's frame, some of
    them overlapping across tiles."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in dataset.data_infos:
        per = []
        for _c in dataset.CLASSES:
            n = int(rng.integers(0, per_class + 1))
            per.append(np.stack([
                rng.uniform(0, 256, n), rng.uniform(0, 256, n),
                rng.uniform(10, 60, n), rng.uniform(5, 30, n),
                rng.uniform(-np.pi / 2, np.pi / 2, n),
                rng.uniform(0.05, 1, n)], -1).astype(np.float32))
        out.append(per)
    return out


def test_merge_det_matches_jax(split):
    _, port, jax_ds = split
    assert [d['filename'] for d in port.data_infos] == \
        [d['filename'] for d in jax_ds.data_infos]
    results = tile_results(port, 0)
    ids, merged = port.merge_det(results, device='cpu')
    ref_ids, ref = jax_ds.merge_det(results)
    assert ids == ref_ids == ['P0000', 'P0001']
    n_in = sum(len(c) for r in results for c in r)
    n_out = 0
    for got_img, ref_img in zip(merged, ref):
        assert len(got_img) == len(port.CLASSES)
        for g, r in zip(got_img, ref_img):
            np.testing.assert_array_equal(g, r)
            n_out += len(g)
    assert 0 < n_out < n_in                   # the merge suppressed some


def test_merge_det_offsets_and_names(tmp_path):
    """``<id>__<size>__<x>___<y>``: the offsets move the centres, the id is
    the name before the first ``__``; a name without offsets is its own
    image."""
    from orientedobjectdetection_torch.datasets import DOTADataset
    ds = DOTADataset.__new__(DOTADataset)
    ds.CLASSES = ('a', 'b')
    ds.data_infos = [dict(filename='x1__256__192___64.png'),
                     dict(filename='plain.png')]
    box = np.array([[10, 20, 8, 4, 0.1, 0.9]], np.float32)
    ids, merged = ds.merge_det([[box, np.zeros((0, 6))],
                                [np.zeros((0, 6)), box]], device='cpu')
    assert ids == ['x1', 'plain']
    np.testing.assert_array_equal(merged[0][0][0, :2], [202, 84])
    assert merged[0][1].shape == (0, 6)
    np.testing.assert_array_equal(merged[1][1], box)


def test_format_results_task1_files_match_jax(split, tmp_path):
    _, port, jax_ds = split
    results = tile_results(port, 1)
    zip_path = port.format_results(results, str(tmp_path / 'port'),
                                   device='cpu')
    ref_zip = jax_ds.format_results(results, str(tmp_path / 'jax'))
    names = sorted(f'Task1_{c}.txt' for c in port.CLASSES)
    with zipfile.ZipFile(zip_path) as zf, zipfile.ZipFile(ref_zip) as rz:
        assert sorted(zf.namelist()) == sorted(rz.namelist()) == names
        for name in names:
            assert zf.read(name) == rz.read(name)
            assert zf.read(name) == (tmp_path / 'port' / name).read_bytes()
    lines = (tmp_path / 'port' / 'Task1_plane.txt').read_text().splitlines()
    assert lines and all(len(line.split()) == 10 for line in lines)
    image, score, *coords = lines[0].split()
    assert image in ('P0000', 'P0001') and len(score.split('.')[1]) == 4
    assert all(len(c.split('.')[1]) == 2 for c in coords)


TINY_CONFIG = '''
data_root = '{root}/'
test_pipeline = [dict(type='LoadImageFromFile')]
data = dict(samples_per_gpu=2, pad_size=(256, 256),
            test=dict(ann_file='{root}/split/images/',
                      img_prefix='{root}/split/images/', classes=None),
            val=dict(ann_file='{root}/split/annfiles/',
                     img_prefix='{root}/split/images/', classes=None))
model = dict(bbox_head=dict(num_classes=15),
             test_cfg=dict(nms_pre=64, max_candidates=64, max_per_img=30))
'''


def test_command_line_format_only_and_tta(split, tmp_path):
    """``--format-only`` detects the test split's tiles and writes what
    ``format_results`` writes for ``batched_eval``'s detections; ``--tta``
    gives ``inference_detector_tta``'s detections."""
    from orientedobjectdetection_torch.tools import test as test_cli
    root = split[0]
    config = tmp_path / 'tiny.py'
    config.write_text(f'_base_ = [{os.path.abspath(CONFIG)!r}]\n' +
                      TINY_CONFIG.format(root=root))
    cfg = test_cli.load_config(str(config), [])
    bundle = init_detector(cfg, device='cpu', device_norm=dict(
        mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
        to_rgb=True))
    with torch.no_grad():
        bundle.detector.bbox_head.retina_cls.bias.zero_()
    ckpt = str(tmp_path / 'zero_bias.pth')
    torch.save(bundle.detector.state_dict(), ckpt)
    bundle = init_detector(cfg, ckpt, device='cpu', device_norm=dict(
        mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
        to_rgb=True))

    out = tmp_path / 'sub'
    test_cli.main([str(config), ckpt, '--format-only', '--submission-dir',
                   str(out), '--device', 'cpu', '--max-images', '6',
                   '--batch-size', '2'])
    test_ds = build_dataset(dict(cfg.data['test'], test_mode=True,
                                 filter_empty_gt=False))
    assert len(test_ds) > 6
    results = batched_eval(bundle, test_ds, batch_size=2, max_images=6)
    assert sum(len(c) for r in results for c in r) > 0
    test_ds.data_infos = test_ds.data_infos[:6]
    test_ds.format_results(results, str(tmp_path / 'api'), device='cpu')
    files = sorted(os.listdir(out))
    assert files == sorted(os.listdir(tmp_path / 'api'))
    assert len(files) == 16 and 'submission.zip' in files
    for name in files:
        if name.endswith('.txt'):
            assert (out / name).read_bytes() == \
                (tmp_path / 'api' / name).read_bytes()

    pkl = str(tmp_path / 'tta.pkl')
    metrics = test_cli.main([str(config), ckpt, '--tta', '--eval', 'mAP',
                             '--device', 'cpu', '--max-images', '2',
                             '--out', pkl])
    assert 0 <= metrics['mAP'] <= 1
    import pickle
    with open(pkl, 'rb') as f:
        got = pickle.load(f)
    val = build_dataset(dict(cfg.data['val'], test_mode=True,
                             filter_empty_gt=False))
    for i, per_class in enumerate(got):
        ref = inference_detector_tta(bundle, os.path.join(
            val.img_prefix, val.data_infos[i]['filename']))
        for g, r in zip(per_class, ref):
            np.testing.assert_array_equal(g, r)


def test_tiled_eval_demo_runs_the_flow(tmp_path):
    """``tools.tiled_eval_demo``: scenes, split, detections, submission and
    the original-frame mAP, here on two 512 px scenes with seeded
    weights."""
    from orientedobjectdetection_torch.tools import tiled_eval_demo
    from orientedobjectdetection_torch.tools.train import load_config
    cfg = load_config(CONFIG, [])
    bundle = init_detector(cfg, device='cpu')
    ckpt = str(tmp_path / 'seeded.pth')
    torch.save(bundle.detector.state_dict(), ckpt)
    root = tmp_path / 'tiled'
    mean_ap = tiled_eval_demo.main([CONFIG, ckpt, '--root', str(root),
                                    '--num-images', '2', '--size', '512',
                                    '--device', 'cpu', '--cfg-options',
                                    'model.test_cfg.max_candidates=64'])
    assert 0 <= mean_ap <= 1
    assert sorted(os.listdir(root / 'submission')) == [
        'Task1_plane.txt', 'Task1_ship.txt', 'submission.zip']
    names = os.listdir(root / 'split' / 'images')
    assert names and all('__256__' in n for n in names)
