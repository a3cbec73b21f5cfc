"""Port parity, the host NMS helpers (``ops/nms.py``): ``nms_rotated_np``,
``aug_multiclass_nms_rotated`` and ``batched_nms_hbb`` against the JAX
package's on the same numpy inputs, on the CPU.

JAX's ``nms_rotated_np`` runs its native C++ greedy NMS where a compiler is
present and its bucketed device NMS otherwise (``tests/test_ops/
test_native.py`` holds the two to one keep list). The keep lists must be
equal, in the same order: descending score, the lowest index first on a
tie."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from orientedobjectdetection_tpu.ops import nms as jnms
from orientedobjectdetection_torch.ops import nms as pnms

torch.set_num_threads(1)


def candidates(n, seed, extent=200.0, ties=False):
    """Rotated boxes crowded enough that NMS at 0.1 suppresses many;
    ``ties``: scores from few values, so that order falls to the index."""
    rng = np.random.default_rng(seed)
    boxes = np.stack([rng.uniform(0, extent, n), rng.uniform(0, extent, n),
                      rng.uniform(8, 40, n), rng.uniform(4, 20, n),
                      rng.uniform(-np.pi / 2, np.pi / 2, n)],
                     -1).astype(np.float32)
    scores = (rng.integers(0, 5, n) / 5.0 if ties else rng.uniform(0, 1, n))
    return boxes, scores.astype(np.float32)


@pytest.mark.parametrize('n,seed,ties', [(1, 0, False), (7, 1, False),
                                         (60, 2, True), (300, 3, False),
                                         (600, 4, True)])
def test_nms_rotated_np_matches_jax(n, seed, ties):
    boxes, scores = candidates(n, seed, ties=ties)
    got = pnms.nms_rotated_np(boxes, scores, 0.1, device='cpu')
    ref = jnms.nms_rotated_np(boxes, scores, 0.1)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, ref)
    assert 0 < len(got) <= n
    assert (np.diff(scores[got]) <= 0).all()


def test_nms_rotated_np_empty_and_no_card():
    assert pnms.nms_rotated_np(np.zeros((0, 5)), np.zeros(0), 0.1,
                               device='cpu').shape == (0,)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            pnms.nms_rotated_np(*candidates(5, 0), 0.1)


@pytest.mark.parametrize('num_classes,max_per_img', [(3, 2000), (4, 25)])
def test_aug_multiclass_nms_rotated_matches_jax(num_classes, max_per_img):
    boxes, scores = candidates(240, 5)
    labels = np.random.default_rng(6).integers(0, num_classes, 240)
    merged = np.concatenate([boxes, scores[:, None]], -1)
    got_d, got_l = pnms.aug_multiclass_nms_rotated(
        merged, labels, num_classes, 0.1, max_per_img, device='cpu')
    ref_d, ref_l = jnms.aug_multiclass_nms_rotated(
        merged, labels, num_classes, 0.1, max_per_img)
    np.testing.assert_array_equal(got_l, ref_l)
    np.testing.assert_array_equal(got_d, ref_d)
    assert len(got_d) <= max_per_img
    empty = pnms.aug_multiclass_nms_rotated(np.zeros((0, 6)), np.zeros(0),
                                            2, device='cpu')
    assert empty[0].shape == (0, 6) and empty[1].shape == (0,)


def test_batched_nms_hbb_matches_jax():
    rng = np.random.default_rng(7)
    xy = rng.uniform(0, 100, (2, 300, 2))
    wh = rng.uniform(5, 40, (2, 300, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = rng.uniform(0, 1, (2, 300)).astype(np.float32)
    labels = rng.integers(0, 3, (2, 300))
    valid = rng.uniform(0, 1, (2, 300)) > 0.2
    keep, order = pnms.batched_nms_hbb(
        torch.from_numpy(boxes), torch.from_numpy(scores),
        torch.from_numpy(labels), 0.5, torch.from_numpy(valid))
    for i in range(2):
        rk, ro = jnms.batched_nms_hbb(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
            jnp.asarray(labels[i]), 0.5, jnp.asarray(valid[i]))
        np.testing.assert_array_equal(keep[i].numpy(), np.asarray(rk))
        np.testing.assert_array_equal(order[i].numpy(), np.asarray(ro))
    # the offsets keep labels apart: two identical boxes of two labels stay
    same = torch.tensor([[[0., 0., 10., 10.], [0., 0., 10., 10.]]])
    keep, _ = pnms.batched_nms_hbb(same, torch.tensor([[0.9, 0.8]]),
                                   torch.tensor([[0, 1]]), 0.5)
    assert keep.tolist() == [[True, True]]
