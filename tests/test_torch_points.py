"""Port parity, the point-set geometry of the RepPoints family: every
function of ``ops/points.py``, ``core/gmm.py:gmm_fit`` and the Gaussian
helpers of ``ops/boxes.py`` against the JAX package (jitted once each, on
the CPU) on numpy-seeded inputs.

Tolerances: inclusion tests exactly, on coordinates that are multiples of
1/16 (every cross product is exact, points on an edge included); hull
rings exactly, on point sets whose hull is decided (no three points within
1e-3 of collinear); areas, IoUs and GIoUs at atol 1e-5 (relative to the
areas); GIoU gradients at rtol 1e-4 with a floor of 1e-6; rectangles,
Gaussians and decoded corners at atol 1e-3 px or 1e-5 relative. A chunked
``convex_iou`` and ``chamfer_distance`` equal the unchunked ones bit for
bit."""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orientedobjectdetection_tpu.core import gmm as j_gmm
from orientedobjectdetection_tpu.ops import boxes as j_boxes
from orientedobjectdetection_tpu.ops import points as j_points
from orientedobjectdetection_torch.core.gmm import gmm_fit
from orientedobjectdetection_torch.ops import boxes, points

torch.set_num_threads(1)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def decided(sets, margin=1e-3):
    """Rows of ``sets`` (K, n, 2) with no three points within ``margin``
    (relative sine) of collinear, and no two points closer than 0.5."""
    keep = []
    for s in sets:
        ok = True
        for i, j, k in itertools.combinations(range(len(s)), 3):
            d1, d2 = s[j] - s[i], s[k] - s[i]
            n1, n2 = np.linalg.norm(d1), np.linalg.norm(d2)
            if min(n1, n2) < 0.5 or \
                    abs(d1[0] * d2[1] - d1[1] * d2[0]) < margin * n1 * n2:
                ok = False
                break
        keep.append(ok)
    return sets[np.array(keep)]


def point_sets(rng, k, n=9, spread=20.0):
    """(k', n * 2) float32 point sets around random centres, hull
    decided."""
    ctr = rng.uniform(20, 100, (k, 1, 2))
    scale = rng.uniform(0.3, 1.0, (k, 1, 2)) * spread
    sets = decided(ctr + rng.normal(0, 1, (k, n, 2)) * scale)
    return sets.reshape(len(sets), -1).astype(np.float32)


def quads(rng, k, center=60.0):
    """(k, 8) float32 rotated rectangles."""
    obb = np.stack([rng.uniform(center - 40, center + 40, k),
                    rng.uniform(center - 40, center + 40, k),
                    rng.uniform(8, 70, k), rng.uniform(8, 70, k),
                    rng.uniform(-1.5, 1.5, k)], -1).astype(np.float32)
    return np.asarray(j_boxes.obb2poly(jnp.asarray(obb)))


@pytest.fixture(scope='module')
def data():
    rng = np.random.default_rng(0)
    sets = point_sets(rng, 96)
    polys = quads(rng, 12)
    # aligned pairs: each set near its own quad, so GIoU and IoU vary
    aligned_q = quads(rng, len(sets))
    centre = aligned_q.reshape(-1, 4, 2).mean(1)
    near_sets = (sets.reshape(len(sets), 9, 2) -
                 sets.reshape(len(sets), 9, 2).mean(1, keepdims=True) +
                 centre[:, None] + rng.normal(0, 6, (len(sets), 1, 2)))
    near_sets = decided(near_sets).astype(np.float32)
    n = len(near_sets)
    return dict(sets=sets, polys=polys,
                near=near_sets.reshape(n, -1), near_q=aligned_q[:n])


def test_points_in_polygons_matches_jax():
    """Dyadic coordinates, a quarter of the points on a polygon's edge or
    corner: the same booleans, and the row-wise form equals the
    diagonal."""
    rng = np.random.default_rng(1)
    polys = rng.integers(0, 1600, (20, 8)).astype(np.float32) / 16
    polys = np.asarray(j_boxes.obb2poly(jnp.asarray(np.stack(
        [rng.integers(400, 1200, 20) / 16, rng.integers(400, 1200, 20) / 16,
         rng.integers(80, 600, 20) / 16, rng.integers(80, 600, 20) / 16,
         np.zeros(20)], -1).astype(np.float32))))
    pts = rng.integers(0, 1600, (60, 2)).astype(np.float32) / 16
    pts[::4] = polys[:15].reshape(15, 4, 2)[np.arange(15), np.arange(15) % 4]
    pts[1::8] = (polys[:8, 0:2] + polys[:8, 2:4]) / 2
    got = points.points_in_polygons(t(pts), t(polys))
    ref = np.asarray(jax.jit(j_points.points_in_polygons)(pts, polys))
    assert got.dtype == torch.bool and got.shape == (60, 20)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < ref.sum() < ref.size
    own = points.points_in_own_polygon(t(pts[:20]), t(polys))
    np.testing.assert_array_equal(own.numpy(), np.diagonal(ref[:20]))


def test_points_in_polygons_batched():
    """Leading batch axes: each image's points against its own polygons."""
    rng = np.random.default_rng(2)
    polys = quads(rng, 10).reshape(2, 5, 8)
    pts = rng.uniform(0, 120, (2, 30, 2)).astype(np.float32)
    got = points.points_in_polygons(t(pts), t(polys))
    for b in range(2):
        np.testing.assert_array_equal(
            got[b].numpy(), np.asarray(j_points.points_in_polygons(
                pts[b], polys[b])))


def test_chamfer_distance_matches_jax(monkeypatch):
    """Both directions at rtol 1e-5; chunks of 7 rows give the same bits."""
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 50, (2, 25, 40, 2)).astype(np.float32)
    b = rng.uniform(0, 50, (2, 25, 40, 2)).astype(np.float32)
    got = points.chamfer_distance(t(a), t(b))
    ref = jax.jit(j_points.chamfer_distance)(a, b)
    for g, r in zip(got, ref):
        assert g.shape == (2, 25)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5)
    monkeypatch.setattr(points, 'CHAMFER_PAIRS', 7 * 40 * 40)
    for g, c in zip(got, points.chamfer_distance(t(a), t(b))):
        assert torch.equal(g, c)


def test_convex_hull_matches_jax(data):
    """Decided hulls: the same ring, point for point, padding included;
    the indices gather the ring."""
    sets = data['sets'].reshape(-1, 9, 2)
    got = points.convex_hull(t(sets))
    ref = np.asarray(jax.jit(jax.vmap(j_points.convex_hull))(sets))
    np.testing.assert_array_equal(got.numpy(), ref)
    idx = points.convex_hull_indices(t(sets))
    np.testing.assert_array_equal(
        np.take_along_axis(sets, idx.numpy()[..., None], 1), ref)
    # the padding repeats the closing vertex; rings have 3..9 vertices
    distinct = [len({tuple(p) for p in ring}) for ring in ref]
    assert min(distinct) >= 3 and max(distinct) > 5


def test_convex_hull_start_and_duplicates():
    """The march starts at the lowest y, then the lowest x, then the lowest
    index; coincident and collinear points fold into the ring as JAX's."""
    sets = np.array([
        [[0, 0], [4, 0], [4, 4], [0, 4], [2, 2], [0, 0], [4, 0], [2, 0],
         [0, 2]],
        [[1, 3], [3, 1], [5, 3], [3, 5], [3, 1], [3, 3], [3, 3], [3, 3],
         [3, 3]],
        [[2, 2]] * 9], np.float32)
    got = points.convex_hull(t(sets)).numpy()
    ref = np.asarray(jax.jit(jax.vmap(j_points.convex_hull))(sets))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        points.convex_hull_indices(t(sets))[:, 0].numpy(), [0, 1, 0])


def test_areas_and_clip_match_jax(data):
    """Shoelace areas of hull rings and quads, and the intersection of each
    hull with its own quad, at atol 1e-5 of the areas."""
    hulls = np.asarray(jax.vmap(j_points.convex_hull)(
        data['near'].reshape(-1, 9, 2)))
    q = data['near_q'].reshape(-1, 4, 2)
    for ring in (hulls, q):
        got = points._poly_area_ccw(t(ring)).numpy()
        ref = np.asarray(jax.jit(j_points._poly_area_ccw)(ring))
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
    got = points._convex_clip_area(t(hulls), t(q)).numpy()
    ref = np.asarray(jax.jit(jax.vmap(j_points._convex_clip_area))(hulls, q))
    assert (ref > 0).mean() > 0.5
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * ref.max())


def test_convex_iou_matches_jax(data):
    """The (N, M) IoU matrix at atol 1e-5; a batch axis gives each image's
    own matrix."""
    got = points.convex_iou(t(data['sets']), t(data['polys']))
    ref = np.asarray(jax.jit(j_points.convex_iou)(data['sets'],
                                                  data['polys']))
    assert got.shape == ref.shape == (len(data['sets']), 12)
    assert (ref > 0).sum() > 50
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    half = len(data['sets']) // 2
    batched = points.convex_iou(
        t(data['sets'][:2 * half].reshape(2, half, 18)),
        t(data['polys'].reshape(2, 6, 8)))
    for b in range(2):
        np.testing.assert_array_equal(
            batched[b].numpy(), points.convex_iou(
                t(data['sets'][b * half:(b + 1) * half]),
                t(data['polys'][b * 6:(b + 1) * 6])).numpy())


@pytest.mark.parametrize('pairs', [1, 12 * 5, 12 * 17, 1 << 30])
def test_convex_iou_chunks_are_exact(data, pairs):
    """Chunks of 1, 5, 17 rows or one chunk: the same bits."""
    whole = points.convex_iou(t(data['sets']), t(data['polys']))
    got = points.convex_iou(t(data['sets']), t(data['polys']), pairs=pairs)
    assert torch.equal(got, whole)


def test_convex_giou_and_gradient_match_jax(data):
    """Aligned GIoU at atol 1e-5; the gradient of sum(1 - GIoU) in the
    points at rtol 1e-4 with a floor of 1e-6 of its largest entry."""
    sets, q = data['near'], data['near_q']
    pts = t(sets).requires_grad_()
    got = points.convex_giou(pts, t(q))
    ref = np.asarray(jax.jit(j_points.convex_giou)(sets, q))
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0, atol=1e-5)
    assert ref.min() < 0 < ref.max()
    (1 - got).sum().backward()
    j_grad = np.asarray(jax.jit(jax.grad(
        lambda p: (1 - j_points.convex_giou(p, q)).sum()))(sets))
    np.testing.assert_allclose(pts.grad.numpy(), j_grad, rtol=1e-4,
                               atol=1e-6 * np.abs(j_grad).max())
    assert (np.abs(j_grad).reshape(-1, 9, 2).sum(-1) == 0).any()


def rect_decided(sets, margin=1e-4):
    """Rows of ``sets`` (K, 18) whose least rectangle is decided: in float64
    the least area over the hull's edges leads the next by more than
    ``margin`` relative. It often is not: where every point projects
    inside two adjacent edges A-B and B-C, both rectangles have twice the
    area of the triangle A-B-C, and rounding picks one of two different
    rectangles (ROADMAP C)."""
    pts = t(sets).double().reshape(-1, 9, 2)
    hull = points.convex_hull(pts)
    e = torch.roll(hull, -1, 1) - hull
    elen = e.norm(dim=-1)
    u = e / elen.clamp(min=1e-9)[..., None]
    v = torch.stack([-u[..., 1], u[..., 0]], -1)
    px, py = pts @ u.transpose(1, 2), pts @ v.transpose(1, 2)
    area = (px.amax(1) - px.amin(1)) * (py.amax(1) - py.amin(1))
    area = torch.where(elen > 1e-9, area, torch.inf).sort(-1)[0]
    return sets[((area[:, 1] - area[:, 0]) > margin * area[:, 0]).numpy()]


def test_min_area_polygons_matches_jax(data):
    """Rectangles at atol 1e-3 px, on sets whose rectangle is decided
    (:func:`rect_decided`); a set of one repeated point gives the zero
    box."""
    sets = rect_decided(data['sets'])
    assert len(sets) > 0.8 * len(data['sets'])
    sets = np.concatenate([sets, np.full((1, 18), 7.5, np.float32)])
    got = points.min_area_polygons(t(sets)).numpy()
    ref = np.asarray(jax.jit(j_points.min_area_polygons)(sets))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got[-1], np.zeros(8, np.float32))


@pytest.mark.parametrize('k, n_iter', [(1, 2), (2, 2)])
def test_gmm_fit_matches_jax(k, n_iter):
    """Weights, means and covariances at rtol 1e-5 (atol 1e-5 of each
    tensor's largest), batched over (2, 30) sets of 9 points; with one
    component (the package's use) a degenerate set, one repeated point,
    too. Two components are held for two steps: over ten, EM lets a
    component collapse on rounding (the JAX package's jitted and eager
    fits then part by 1e-3)."""
    rng = np.random.default_rng(10 + k)
    pts = rng.normal(0, 1, (2, 30, 9, 2)) * rng.uniform(0.5, 20, (2, 30, 1,
                                                                 2))
    pts = (pts + rng.uniform(0, 100, (2, 30, 1, 2))).astype(np.float32)
    if k == 1:
        pts[0, 0] = 3.0
    got = gmm_fit(t(pts), n_components=k, n_iter=n_iter)
    ref = jax.jit(lambda p: j_gmm.gmm_fit(p, n_components=k,
                                          n_iter=n_iter))(pts)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5,
                                   atol=1e-5 * np.abs(r).max())


def test_gaussians_match_jax():
    """``gt2gaussian``, ``gt2gaussian_poly`` and ``gaussian2bbox`` at rtol
    1e-5 (corners at atol 1e-3 px)."""
    rng = np.random.default_rng(20)
    obb = np.stack([rng.uniform(0, 100, 50), rng.uniform(0, 100, 50),
                    rng.uniform(1, 80, 50), rng.uniform(1, 80, 50),
                    rng.uniform(-1.5, 1.5, 50)], -1).astype(np.float32)
    for got, ref in zip(boxes.gt2gaussian(t(obb)),
                        jax.jit(j_boxes.gt2gaussian)(obb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())
    poly = np.asarray(j_boxes.obb2poly(jnp.asarray(obb)))
    mu, sigma = boxes.gt2gaussian_poly(t(poly))
    j_mu, j_sigma = jax.jit(j_boxes.gt2gaussian_poly)(poly)
    np.testing.assert_allclose(mu.numpy(), np.asarray(j_mu), rtol=1e-5)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(j_sigma), rtol=1e-5,
                               atol=1e-5 * np.abs(j_sigma).max())
    # (4, 2) polygons too
    np.testing.assert_array_equal(
        boxes.gt2gaussian_poly(t(poly.reshape(-1, 4, 2)))[1].numpy(),
        sigma.numpy())
    got = boxes.gaussian2bbox(mu, sigma).numpy()
    ref = np.asarray(jax.jit(j_boxes.gaussian2bbox)(np.asarray(j_mu),
                                                    np.asarray(j_sigma)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)


def test_gaussian_round_trip():
    """``gaussian2bbox(gt2gaussian_poly(p))`` gives back the rectangle p:
    the same corners up to their order (atol 1e-3 px), and the same
    Gaussian (rtol 1e-4)."""
    rng = np.random.default_rng(21)
    obb = np.stack([rng.uniform(0, 100, 40), rng.uniform(0, 100, 40),
                    rng.uniform(2, 80, 40), rng.uniform(2, 80, 40),
                    rng.uniform(-1.5, 1.5, 40)], -1).astype(np.float32)
    poly = boxes.obb2poly(t(obb))
    mu, sigma = boxes.gt2gaussian_poly(poly)
    back = boxes.gaussian2bbox(mu, sigma)
    corners, want = back.reshape(-1, 4, 2), poly.reshape(-1, 4, 2)
    dist = (corners[:, :, None] - want[:, None]).norm(dim=-1).amin(2)
    assert float(dist.max()) < 1e-3
    mu2, sigma2 = boxes.gt2gaussian_poly(back)
    np.testing.assert_allclose(mu2.numpy(), mu.numpy(), atol=1e-4)
    np.testing.assert_allclose(sigma2.numpy(), sigma.numpy(), rtol=1e-4,
                               atol=1e-4 * float(sigma.abs().max()))
