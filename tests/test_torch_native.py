"""The port's native host geometry (``orientedobjectdetection_torch/native.py``
over its own copy of ``csrc/rnms.cpp``) against the JAX package's
``native`` module (built with g++ here too): the rotated IoU and IoF
matrices, the rotated and the axis-aligned greedy NMS on seeded sets,
exactly; ``nms_rotated_np(device='cpu')`` takes the native path; and the
library (the geometry and ``csrc/jpeg.cpp`` in one) builds under
``_build/`` by the hash of both sources, and raises without a compiler
instead of falling back."""

import numpy as np
import pytest

from orientedobjectdetection_tpu import native as j_native
from orientedobjectdetection_tpu.ops import nms as j_nms
from orientedobjectdetection_torch import native
from orientedobjectdetection_torch.ops import nms


def seeded_boxes(n, seed, dense=False):
    """``n`` rotated boxes, many overlapping (``dense``: in a 100 px
    square), and their scores with ties."""
    rng = np.random.default_rng(seed)
    extent = 100 if dense else 600
    boxes = np.stack([rng.uniform(0, extent, n), rng.uniform(0, extent, n),
                      rng.uniform(4, 80, n), rng.uniform(4, 80, n),
                      rng.uniform(-np.pi / 2, np.pi / 2, n)],
                     -1).astype(np.float32)
    boxes[7::7] = boxes[6:-1:7][:len(boxes[7::7])]   # duplicates
    scores = rng.integers(0, 50, n).astype(np.float32) / 50  # ties
    return boxes, scores


def test_the_copy_is_the_jax_package_s_source():
    """The same geometry code: only the header comment differs."""
    from pathlib import Path
    ours = native.SOURCE.read_text()
    theirs = (Path(j_native.__file__).parent / 'rnms.cpp').read_text()
    body = ours[ours.index('#include <algorithm>'):]
    assert body == theirs[theirs.index('#include <algorithm>'):]


@pytest.mark.parametrize('mode', ['iou', 'iof'])
@pytest.mark.parametrize('seed', range(3))
def test_rbox_iou_equals_jax_native(mode, seed):
    b1, _ = seeded_boxes(60, seed, dense=True)
    b2, _ = seeded_boxes(45, seed + 10, dense=True)
    got = native.rbox_iou(b1, b2, mode)
    assert got.shape == (60, 45) and got.dtype == np.float32
    np.testing.assert_array_equal(got, j_native.rbox_iou(b1, b2, mode))
    assert (got > 0).mean() > 0.1


@pytest.mark.parametrize('thr', [0.05, 0.1, 0.5])
@pytest.mark.parametrize('seed', range(3))
def test_nms_rotated_equals_jax_native(thr, seed):
    boxes, scores = seeded_boxes(400, seed, dense=seed == 0)
    keep = native.nms_rotated(boxes, scores, thr)
    np.testing.assert_array_equal(keep, j_native.nms_rotated(boxes, scores,
                                                             thr))
    assert keep.dtype == np.int64 and 0 < len(keep) < 400


@pytest.mark.parametrize('seed', range(3))
def test_nms_hbb_equals_jax_native(seed):
    boxes, scores = seeded_boxes(300, seed, dense=True)
    xyxy = np.concatenate([boxes[:, :2] - boxes[:, 2:4] / 2,
                           boxes[:, :2] + boxes[:, 2:4] / 2], -1)
    keep = native.nms_hbb(xyxy, scores, 0.3)
    np.testing.assert_array_equal(keep, j_native.nms_hbb(xyxy, scores, 0.3))
    assert 0 < len(keep) < 300


def test_host_nms_on_the_cpu_is_native(monkeypatch):
    """``nms_rotated_np(device='cpu')`` calls the native NMS and gives the
    JAX package's keep list; ``plain_pair_mask`` keeps the PyTorch path,
    which agrees here."""
    boxes, scores = seeded_boxes(500, 4, dense=True)
    calls = []
    inner = native.nms_rotated

    def spy(*args):
        calls.append(len(args[0]))
        return inner(*args)

    monkeypatch.setattr(native, 'nms_rotated', spy)
    keep = nms.nms_rotated_np(boxes, scores, 0.1, device='cpu')
    assert calls == [500]
    np.testing.assert_array_equal(keep, j_nms.nms_rotated_np(boxes, scores,
                                                             0.1))
    plain = nms.nms_rotated_np(boxes, scores, 0.1, device='cpu',
                               plain_pair_mask=True)
    assert calls == [500]
    np.testing.assert_array_equal(plain, keep)
    assert len(nms.nms_rotated_np(boxes[:0], scores[:0], 0.1,
                                  device='cpu')) == 0


def test_builds_by_hash_and_raises_without_a_compiler(tmp_path,
                                                      monkeypatch):
    path = native.library_path()
    assert path.parent == native.BUILD_DIR
    assert path.name.startswith('native-') and path.suffix == '.so'
    assert native.sources() == (native.SOURCE, native.JPEG_SOURCE,
                                native.TIFF_SOURCE, native.RASTER_SOURCE,
                                native.GIF_SOURCE, native.WEBP_SOURCE)
    native.load()
    assert path.exists()
    for name in ('JPEG_SOURCE', 'TIFF_SOURCE',      # every source counts
                 'RASTER_SOURCE', 'GIF_SOURCE', 'WEBP_SOURCE'):
        monkeypatch.setattr(native, name, tmp_path / 'codec.cpp')
        (tmp_path / 'codec.cpp').write_text('// another codec\n')
        assert native.library_path() != path
        monkeypatch.undo()
    monkeypatch.setattr(native, 'BUILD_DIR', tmp_path / '_build')
    monkeypatch.setattr(native, '_LIB', None)
    monkeypatch.setenv('CXX', 'no-such-compiler-here')
    with pytest.raises(RuntimeError, match='compiler'):
        native.nms_rotated(*seeded_boxes(10, 0), 0.1)
    monkeypatch.setattr(native, 'SOURCE', tmp_path / 'broken.cpp')
    (tmp_path / 'broken.cpp').write_text('this is not C++\n')
    monkeypatch.setenv('CXX', 'g++')
    with pytest.raises(RuntimeError, match='failed on broken.cpp jpeg.cpp'):
        native.load()
