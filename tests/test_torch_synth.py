"""The port's synthetic-data generator (``tools/generate_synth.py``)
against the original (``tools/data/synth/generate_synth.py``, OpenCV) for
the same seed: 4 tiny-protocol images of 256 px, and 2 synth-hard images of
256 px with 10-30 instances.

- The annotation files are byte-identical: both draw the same random
  numbers in the same order and round the same float32 polygons.
- The images are equal except along drawn edges. The port's thick line (the
  plane's strut) approximates OpenCV's fixed-point one, and its polygons
  differ where they leave the image: at most 1% of the pixels differ
  (0.16-0.36% measured), each within 3 px of an annotated object, by at
  most 64 grey levels measured.
"""

import filecmp
import importlib.util
import os

import cv2
import numpy as np
import pytest

from orientedobjectdetection_torch.tools import generate_synth as port
from orientedobjectdetection_torch.utils.image_io import imread

ROOT = os.path.join(os.path.dirname(__file__), '..')


def original():
    spec = importlib.util.spec_from_file_location(
        'generate_synth_original',
        os.path.join(ROOT, 'tools', 'data', 'synth', 'generate_synth.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def near_objects(ann_path, shape, grow=3):
    mask = np.zeros(shape[:2], np.uint8)
    with open(ann_path) as f:
        for line in f:
            pts = np.array(line.split()[:8], np.float32).reshape(4, 2)
            cv2.fillPoly(mask, [pts.astype(np.int32)], 1)
    return cv2.dilate(mask, np.ones((2 * grow + 1, 2 * grow + 1),
                                    np.uint8)).astype(bool)


@pytest.mark.parametrize('kind', ['tiny', 'hard'])
def test_generator_matches_the_original(tmp_path, kind):
    ref_root, got_root = str(tmp_path / 'ref'), str(tmp_path / 'got')
    if kind == 'tiny':
        original().generate_synth(ref_root, 4, 256, seed=0)
        port.generate_synth(got_root, 4, 256, seed=0)
    else:
        original().generate_synth_hard(ref_root, 2, 256, seed=0,
                                       n_range=(10, 30))
        port.generate_synth_hard(got_root, 2, 256, seed=0, n_range=(10, 30))
    names = sorted(os.listdir(os.path.join(ref_root, 'trainval',
                                           'annfiles')))
    assert names == sorted(os.listdir(os.path.join(got_root, 'trainval',
                                                   'annfiles')))
    differing, total = 0, 0
    for name in names:
        ref_ann = os.path.join(ref_root, 'trainval', 'annfiles', name)
        got_ann = os.path.join(got_root, 'trainval', 'annfiles', name)
        assert filecmp.cmp(ref_ann, got_ann, shallow=False), name
        stem = name[:-4] + '.png'
        ref = cv2.imread(os.path.join(ref_root, 'trainval', 'images', stem))
        got = imread(os.path.join(got_root, 'trainval', 'images', stem))
        assert got.shape == ref.shape == (256, 256, 3)
        diff = np.abs(got.astype(int) - ref).max(-1)
        assert diff.max() <= 64
        assert not (diff > 0)[~near_objects(got_ann, got.shape)].any()
        differing += int((diff > 0).sum())
        total += diff.size
    assert differing / total < 0.01


def test_command_line(tmp_path):
    port.main(['--root', str(tmp_path), '--num-images', '2', '--size', '96',
               '--hard', '--n-min', '3', '--n-max', '5'])
    assert sorted(os.listdir(tmp_path / 'trainval' / 'images')) == [
        'D0000.png', 'D0001.png']
    port.main(['--root', str(tmp_path / 'hrsc'), '--num-images', '2',
               '--size', '96', '--hrsc', '--split', 'val'])
    assert sorted(os.listdir(tmp_path / 'hrsc' / 'FullDataSet' /
                             'AllImages')) == ['H0000.bmp', 'H0001.bmp']
    assert (tmp_path / 'hrsc' / 'ImageSets' / 'val.txt').read_text() == \
        'H0000\nH0001\n'
