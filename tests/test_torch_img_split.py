"""The port's tiler (``tools/img_split.py``, a port-only copy that reads
and writes with ``utils/image_io.py``) against
``tools/data/dota/split/img_split.py`` (OpenCV) on the same synthetic
scenes: single-scale and with ``--rates``, with and without annotations,
and an image whose windows run over its edge (the padding value). The same
tile names, tiles pixel-equal, annotation files byte-equal."""

import os
import shutil
import subprocess
import sys

import cv2
import numpy as np
import pytest

from orientedobjectdetection_torch.tools import img_split
from orientedobjectdetection_torch.tools.generate_synth import generate_synth
from orientedobjectdetection_torch.utils.image_io import imread, imwrite

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..')
JAX_SPLIT = os.path.join(ROOT, 'tools', 'data', 'dota', 'split',
                         'img_split.py')


@pytest.fixture(scope='module')
def scenes(tmp_path_factory):
    """Two 384 px scenes and a 300 x 100 crop of the first, narrower than a
    window, which keeps the first's annotations (objects cut by the crop,
    or outside it)."""
    root = tmp_path_factory.mktemp('scenes')
    generate_synth(str(root), num_images=2, size=384, seed=3, split='s',
                   max_objs=12)
    img = imread(str(root / 's/images/P0000.png'))
    imwrite(str(root / 's/images/Q0000.png'),
            np.ascontiguousarray(img[:300, :100]))
    shutil.copy(root / 's/annfiles/P0000.txt', root / 's/annfiles/Q0000.txt')
    return root


def run_both(scenes, tmp_path, extra, annotated=True):
    args = ['--img-dirs', str(scenes / 's/images'), '--sizes', '128',
            '--gaps', '32', '--nproc', '2'] + extra
    if annotated:
        args += ['--ann-dirs', str(scenes / 's/annfiles')]
    port_dir, jax_dir = tmp_path / 'port', tmp_path / 'jax'
    n = img_split.main(args + ['--save-dir', str(port_dir)])
    subprocess.run([sys.executable, JAX_SPLIT] + args +
                   ['--save-dir', str(jax_dir)], check=True, cwd=ROOT,
                   env=dict(os.environ, JAX_PLATFORMS='cpu'),
                   capture_output=True)
    return n, port_dir, jax_dir


def same_tiles(port_dir, jax_dir):
    names = sorted(os.listdir(port_dir / 'images'))
    assert names == sorted(os.listdir(jax_dir / 'images'))
    for name in names:
        got = imread(str(port_dir / 'images' / name))
        ref = cv2.imread(str(jax_dir / 'images' / name), cv2.IMREAD_COLOR)
        np.testing.assert_array_equal(got, ref)
    anns = sorted(os.listdir(port_dir / 'annfiles'))
    assert anns == sorted(os.listdir(jax_dir / 'annfiles'))
    for name in anns:
        assert (port_dir / 'annfiles' / name).read_bytes() == \
            (jax_dir / 'annfiles' / name).read_bytes()
    return names, anns


@pytest.mark.parametrize('rates', [None, ['0.5', '1.0', '2.0']])
def test_split_matches_jax(scenes, tmp_path, rates):
    extra = ['--rates'] + rates if rates else []
    n, port_dir, jax_dir = run_both(scenes, tmp_path, extra)
    names, anns = same_tiles(port_dir, jax_dir)
    assert n == len(names) == len(anns) > 0
    sizes = {name.split('__')[1] for name in names}
    assert sizes == ({'64', '128', '256'} if rates else {'128'})
    # a window over the edge of the 100 px wide crop carries the padding
    edge = [name for name in names if name.startswith('Q0000__128__')]
    assert edge
    for name in edge:
        tile = imread(str(port_dir / 'images' / name))
        assert (tile[:, 100:] == (104, 116, 124)).all()
    # objects cut by a window are kept as difficulty 2
    diffs = [line.split()[9] for name in anns
             for line in (port_dir / 'annfiles' / name).read_text()
             .splitlines()]
    assert '2' in diffs and '0' in diffs


def test_split_without_annotations_matches_jax(scenes, tmp_path):
    n, port_dir, jax_dir = run_both(scenes, tmp_path, [], annotated=False)
    names, anns = same_tiles(port_dir, jax_dir)
    # every window is written: 4 x 4 of a 384 px scene, 1 x 3 of the crop
    assert n == len(names) == 35 and anns == []


def test_clip_ratios():
    square = np.array([[0, 0, 10, 0, 10, 10, 0, 10]], np.float32)
    np.testing.assert_allclose(
        img_split.clip_polys_to_window(square, 0, 0, 20, 20), [1.0])
    np.testing.assert_allclose(
        img_split.clip_polys_to_window(square, 5, 0, 20, 20), [0.5],
        rtol=1e-6)
    assert img_split.clip_polys_to_window(square, 11, 11, 20, 20)[0] == 0
