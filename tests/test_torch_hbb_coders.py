"""Port parity, the geometry and coders of the horizontal-proposal
detectors: ``poly2obb`` (the edge-based construction, on quadrilaterals
that are not rectangles too), ``DeltaXYWHBBoxCoder`` (with its
``max_shape`` clip), ``DeltaXYWHAHBBoxCoder``, ``GVFixCoder`` (axis-aligned
gts, whose two vertices on an edge tie) and ``GVRatioCoder``, and the
RoIAlign kernel's plain version at one sample a bin side, each against the
JAX package on the same numpy inputs.

Tolerances: element-wise float32 math 1e-5 (angles 1e-5 rad, away from
the wrap of the convention); RoIAlign 1e-5 (the same gather formulation).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from orientedobjectdetection_tpu.core import coders as j_coders
from orientedobjectdetection_tpu.ops import boxes as j_boxes
from orientedobjectdetection_tpu.ops.roi_align_rotated import \
    roi_align_rotated as j_roi_align
from orientedobjectdetection_torch.core import (DeltaXYWHAHBBoxCoder,
                                                DeltaXYWHBBoxCoder,
                                                GVFixCoder, GVRatioCoder)
from orientedobjectdetection_torch.ops import (poly2obb,
                                               roi_align_rotated_pyramid)
from orientedobjectdetection_torch.ops.boxes import obb2poly

torch.set_num_threads(1)


def random_obbs(n, seed, extent=200.0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(20, extent, n), rng.uniform(20, extent, n),
                     rng.uniform(4, 80, n), rng.uniform(4, 80, n),
                     rng.uniform(-1.5, 1.5, n)], -1).astype(np.float32)


def random_xyxy(shape, seed, extent=100.0):
    rng = np.random.default_rng(seed)
    x1 = rng.uniform(0, extent, shape)
    y1 = rng.uniform(0, extent, shape)
    return np.stack([x1, y1, x1 + rng.uniform(2, 40, shape),
                     y1 + rng.uniform(2, 40, shape)], -1).astype(np.float32)


def gliding_quads(n, seed):
    """Gliding Vertex polygons: a vertex on each edge of a box, at random
    offsets, so most are not rectangles (and some are)."""
    rng = np.random.default_rng(seed)
    box = random_xyxy((n,), seed)
    fix = rng.uniform(0.05, 0.95, (n, 4)).astype(np.float32)
    fix[:10] = [0.3, 0.3, 0.3, 0.3]                   # rectangles
    x1, y1, x2, y2 = box.T
    w, h = x2 - x1, y2 - y1
    return np.stack([x1 + w * fix[:, 0], y1, x2, y1 + h * fix[:, 1],
                     x2 - w * fix[:, 2], y2, x1, y2 - h * fix[:, 3]], -1)


@pytest.mark.parametrize('version', ['oc', 'le90', 'le135'])
def test_poly2obb_matches_jax(version):
    polys = np.concatenate([
        gliding_quads(300, 1),
        np.asarray(obb2poly(torch.from_numpy(random_obbs(200, 2)), version))])
    got = poly2obb(torch.from_numpy(polys), version).numpy()
    ref = np.asarray(j_boxes.poly2obb(jnp.asarray(polys), version))
    np.testing.assert_allclose(got[:, :4], ref[:, :4], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got[:, 4], ref[:, 4], atol=1e-5)
    # a polygon that is not a rectangle gives the edge construction's box,
    # not its least enclosing rectangle: w and h are two edge lengths
    quad = polys[10:300].reshape(-1, 4, 2)
    e01 = np.linalg.norm(quad[:, 0] - quad[:, 1], axis=-1)
    e12 = np.linalg.norm(quad[:, 1] - quad[:, 2], axis=-1)
    np.testing.assert_allclose(np.sort(got[10:300, 2:4], 1),
                               np.sort(np.stack([e01, e12], 1), 1),
                               rtol=1e-5)


@pytest.mark.parametrize('stds', [(1., 1., 1., 1.), (0.1, 0.1, 0.2, 0.2)])
def test_delta_xywh_coder_matches_jax(stds):
    rng = np.random.default_rng(3)
    boxes = random_xyxy((2, 150), 4)
    gts = random_xyxy((2, 150), 5)
    kw = dict(target_means=(0.01, -0.02, 0.0, 0.03), target_stds=stds)
    coder, ref = DeltaXYWHBBoxCoder(**kw), j_coders.DeltaXYWHBBoxCoder(**kw)
    np.testing.assert_allclose(
        coder.encode(torch.from_numpy(boxes), torch.from_numpy(gts)).numpy(),
        np.asarray(ref.encode(jnp.asarray(boxes), jnp.asarray(gts))),
        rtol=1e-5, atol=1e-5)
    deltas = rng.normal(0, 2, (2, 150, 4)).astype(np.float32)
    deltas[0, :5, 2:] = 9.0                      # past the wh ratio clip
    for shape in (None, (90, 110)):
        got = coder.decode(torch.from_numpy(boxes), torch.from_numpy(deltas),
                           max_shape=shape).numpy()
        want = np.asarray(ref.decode(jnp.asarray(boxes), jnp.asarray(deltas),
                                     max_shape=shape))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    assert got[..., [0, 2]].max() <= 110 and got[..., [1, 3]].max() <= 90


@pytest.mark.parametrize('version', ['oc', 'le90', 'le135'])
def test_delta_xywha_hbbox_coder_matches_jax(version):
    """Theta-0 rois, the RoI Transformer stage-0 and Faster R-CNN
    settings (``norm_factor`` 2, ``edge_swap``)."""
    rois = random_obbs(300, 6)
    rois[:, 4] = 0.0
    gts = random_obbs(300, 7)
    kw = dict(angle_range=version, norm_factor=2, edge_swap=True,
              target_stds=(0.1, 0.1, 0.2, 0.2, 0.1))
    coder = DeltaXYWHAHBBoxCoder(**kw)
    ref = j_coders.DeltaXYWHAHBBoxCoder(**kw)
    enc = coder.encode(torch.from_numpy(rois), torch.from_numpy(gts))
    np.testing.assert_allclose(
        enc.numpy(), np.asarray(ref.encode(jnp.asarray(rois),
                                           jnp.asarray(gts))),
        rtol=1e-5, atol=1e-5)
    dec = coder.decode(torch.from_numpy(rois), enc).numpy()
    want = np.asarray(ref.decode(jnp.asarray(rois), jnp.asarray(enc.numpy())))
    np.testing.assert_allclose(dec, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize('version', ['oc', 'le90', 'le135'])
def test_gv_fix_and_ratio_coders_match_jax(version):
    """Rotated gts, and axis-aligned ones (theta 0 and, in le90, -pi/2 as
    ``obb2hbb`` gives), whose top and bottom edges each hold two vertices:
    the first of them is the edge's vertex in both packages."""
    gts = random_obbs(400, 8)
    gts[:100, 4] = 0.0
    if version == 'le90':
        gts[100:130, 4] = -np.pi / 2
    fix, j_fix = GVFixCoder(version), j_coders.GVFixCoder(version)
    got = fix.encode(torch.from_numpy(gts)).numpy()
    ref = np.asarray(j_fix.encode(jnp.asarray(gts)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    # an axis-aligned gt takes the first corner of each tied edge: its
    # offsets are 0 or 1, none in between
    assert np.isin(np.round(got[:100], 5), [0.0, 1.0]).all()
    hbbs = random_xyxy((400,), 9)
    np.testing.assert_allclose(
        fix.decode(torch.from_numpy(hbbs), torch.from_numpy(got)).numpy(),
        np.asarray(j_fix.decode(jnp.asarray(hbbs), jnp.asarray(got))),
        rtol=1e-5, atol=1e-4)
    ratio = GVRatioCoder(version).encode(torch.from_numpy(gts)).numpy()
    np.testing.assert_allclose(
        ratio, np.asarray(j_coders.GVRatioCoder(version).encode(
            jnp.asarray(gts))), rtol=1e-5, atol=1e-6)
    assert ratio.shape == (400, 1)
    np.testing.assert_allclose(ratio[:100], 1.0, atol=1e-5)


def test_roi_align_plain_version_at_one_sample_matches_jax():
    """The Rotated Faster R-CNN config's ``sampling_ratio`` 0 is read as 1
    by both packages; the kernel's plain version pools theta-0 and rotated
    RoIs at one sample a bin side as the JAX gather op does."""
    rng = np.random.default_rng(10)
    feats = [rng.normal(0, 1, (2, 64 // s, 64 // s, 8)).astype(np.float32)
             for s in (4, 8, 16, 32)]
    rois = np.stack([rng.uniform(0, 64, (2, 30)), rng.uniform(0, 64, (2, 30)),
                     np.exp(rng.uniform(np.log(4), np.log(90), (2, 30))),
                     np.exp(rng.uniform(np.log(4), np.log(90), (2, 30))),
                     rng.uniform(-1.5, 1.5, (2, 30))], -1).astype(np.float32)
    rois[:, :15, 4] = 0.0
    rois[1, -3:] = 0.0                                 # padding
    scales = [1 / 4, 1 / 8, 1 / 16, 1 / 32]
    got = roi_align_rotated_pyramid([torch.from_numpy(f) for f in feats],
                                    torch.from_numpy(rois), (7, 7), scales,
                                    1, 56.0)
    ref = j_roi_align([jnp.asarray(f) for f in feats], jnp.asarray(rois),
                      (7, 7), scales, 1, 56.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)
    assert (got[1, -3:] == 0).all()
    with pytest.raises(ValueError, match='sampling_ratio'):
        roi_align_rotated_pyramid([torch.from_numpy(f) for f in feats],
                                  torch.from_numpy(rois), (7, 7), scales, 3)
