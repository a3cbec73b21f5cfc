"""The port's numpy box geometry (``ops/boxes.py``: ``poly2obb_np`` through
its own ``min_area_rect``, ``obb2poly_np``, ``get_best_begin_point``,
``rbbox_flip``) against the JAX package's twins, which call OpenCV.

Tolerances of ``poly2obb_np``: centre and sides within 1e-4 of the value's
magnitude (at least 1e-4), the angle within 1e-5 modulo the version's
period (pi/2 for ``oc``, pi for ``le90`` and ``le135``). OpenCV works in
float32, whose step at 1024 px is 6e-5, so each bound is at least the
``quantum`` of four float32 steps of the polygon's largest coordinate (for
the angle, that quantum over the shorter side). Three cases are kept out of
the exact comparison and checked by what still holds:

- a side within 1e-3 px of the 2-px reject: OpenCV computes the side in
  float32 and the port in float64, so the two may fall on either side;
- two least rectangles: OpenCV compares its candidates' areas in float32
  and may keep another one whose area agrees to that rounding. Then both
  must enclose the polygon and their areas agree within 1e-4 plus the
  quantum times their sides;
- an ``le90`` box whose sides agree within the tolerance has no long side,
  and OpenCV's choice between the two follows its own hull order: its
  angle is compared modulo pi/2.
"""

import math

import cv2
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from orientedobjectdetection_tpu.ops import boxes as jax_boxes
from orientedobjectdetection_torch.ops import boxes

VERSIONS = ('oc', 'le90', 'le135')
PERIOD = {'oc': math.pi / 2, 'le90': math.pi, 'le135': math.pi}
REJECT_BAND = 1e-3


def rect_poly(cx, cy, w, h, a):
    return jax_boxes.obb2poly_np(
        np.array([[cx, cy, w, h, a, 0.0]], np.float32), 'le90')[0, :8]


def angle_gap(a, b, period):
    return abs((a - b + period / 2) % period - period / 2)


def encloses(rect, pts, tol=1e-3):
    """Every point lies inside the ``cv2.minAreaRect``-form rectangle."""
    (cx, cy), (w, h), a = rect
    u = np.array([math.cos(math.radians(a)), math.sin(math.radians(a))])
    rel = pts.astype(np.float64) - np.array([cx, cy])
    return (np.abs(rel @ u) <= w / 2 + tol).all() and \
        (np.abs(rel @ np.array([-u[1], u[0]])) <= h / 2 + tol).all()


def check_poly2obb(poly, version):
    poly = np.asarray(poly, np.float32)
    ref = jax_boxes.poly2obb_np(poly, version)
    got = boxes.poly2obb_np(poly, version)
    # a few float32 steps of the largest coordinate: how far OpenCV's own
    # float32 arithmetic can move a side, and so an angle by it / the side
    quantum = 4 * float(np.spacing(np.abs(poly).max()))
    if version != 'le135':
        pts = poly.reshape(4, 2)
        mine, theirs = boxes.min_area_rect(pts), cv2.minAreaRect(pts)
        if min(abs(s - 2) for s in mine[1] + theirs[1]) < REJECT_BAND:
            return
    assert (got is None) == (ref is None), (poly, got, ref)
    if ref is None:
        return
    got, ref = np.array(got, np.float64), np.array(ref, np.float64)
    tol = np.maximum(1e-4 * np.maximum(1.0, np.abs(ref[:4])), quantum)
    period = PERIOD[version]
    if version == 'le90' and abs(ref[2] - ref[3]) <= tol[2] + tol[3]:
        period = math.pi / 2
        got[2:4], ref[2:4] = np.sort(got[2:4]), np.sort(ref[2:4])
    agree = (np.abs(got[:4] - ref[:4]) <= tol).all() and \
        angle_gap(got[4], ref[4], period) <= 1e-5 + quantum / min(ref[2:4])
    if not agree and version != 'le135':
        # OpenCV compares its candidates' areas in float32 and may keep
        # another least rectangle: both must enclose the polygon, with
        # areas equal up to that rounding
        area, their_area = np.prod(mine[1]), np.prod(theirs[1])
        slack = quantum * (sum(mine[1]) + sum(theirs[1]))
        assert abs(area - their_area) <= 1e-4 * area + slack, (
            poly, mine, theirs)
        assert encloses(mine, pts, quantum + 1e-6)
        assert encloses(theirs, pts, quantum + 1e-3)
        return
    assert agree, (poly, got, ref)


coords = st.floats(0, 1024, allow_nan=False)
sides = st.floats(0.25, 400, allow_nan=False)
angles = st.floats(-math.pi, math.pi, allow_nan=False)


@pytest.mark.parametrize('version', VERSIONS)
@settings(max_examples=150, deadline=None, derandomize=True)
@given(cx=coords, cy=coords, w=sides, h=sides, a=angles)
def test_poly2obb_rectangles_match_jax(version, cx, cy, w, h, a):
    check_poly2obb(rect_poly(cx, cy, w, h, a), version)


@pytest.mark.parametrize('version', VERSIONS)
@settings(max_examples=150, deadline=None, derandomize=True)
@given(cx=coords, cy=coords, w=st.floats(0.5, 4.0),
       h=sides, a=angles,
       jitter=st.lists(st.floats(-0.25, 0.25), min_size=8,
                       max_size=8))
def test_poly2obb_near_degenerate_quads_match_jax(version, cx, cy, w, h, a,
                                                  jitter):
    """Thin rectangles about the 2-px reject with every corner moved by up
    to 0.3 px: a convex quad whose least rectangle has one best side."""
    check_poly2obb(rect_poly(cx, cy, w, h, a) + np.float32(jitter), version)


@pytest.mark.parametrize('version', VERSIONS)
def test_poly2obb_axis_aligned_and_squares(version):
    cases = [[0, 0, 4, 0, 4, 2, 0, 2], [0, 0, 2, 0, 2, 4, 0, 4],
             [0, 0, 4, 0, 4, 4, 0, 4], [1, 0, 2, 1, 1, 2, 0, 1],
             [10, 10, 11, 10, 11, 30, 10, 30], [5, 5, 25, 5, 25, 5.5, 5, 5.5]]
    for poly in cases:
        check_poly2obb(np.array(poly, np.float32), version)


@settings(max_examples=100, deadline=None, derandomize=True)
@given(obbs=st.lists(st.tuples(coords, coords, sides, sides, angles,
                               st.floats(0, 1)),
                     min_size=0, max_size=6))
def test_obb2poly_np_and_best_begin_point_exact(obbs):
    obbs = np.array(obbs, np.float32).reshape(-1, 6)
    for version in VERSIONS:
        got = boxes.obb2poly_np(obbs, version)
        ref = jax_boxes.obb2poly_np(obbs, version)
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref)
    polys = np.concatenate([obbs[:, :4].repeat(2, 1), obbs[:, 5:]], 1)
    np.testing.assert_array_equal(boxes.get_best_begin_point(polys),
                                  jax_boxes.get_best_begin_point(polys))


@pytest.mark.parametrize('version', VERSIONS)
@pytest.mark.parametrize('direction', ['horizontal', 'vertical', 'diagonal'])
def test_rbbox_flip_exact(version, direction):
    rng = np.random.default_rng(3)
    obbs = np.stack([rng.uniform(0, 512, 40), rng.uniform(0, 384, 40),
                     rng.uniform(2, 90, 40), rng.uniform(2, 90, 40),
                     rng.uniform(-math.pi / 2, math.pi / 2, 40)],
                    -1).astype(np.float32)
    obbs[:5, 4] = np.float32(math.pi / 2)         # oc leaves these unturned
    got = boxes.rbbox_flip(obbs, (384, 512, 3), direction, version)
    ref = np.asarray(jax_boxes.rbbox_flip(obbs, (384, 512, 3), direction,
                                          version))
    np.testing.assert_array_equal(got, ref)
