"""Point-set geometry for the RepPoints family (counterpart of
``orientedobjectdetection_tpu/ops/points.py``): ``points_in_polygons``,
``chamfer_distance``, ``convex_hull``, ``convex_iou``, ``convex_giou`` and
``min_area_polygons``, plain PyTorch, batched over any leading axes.

The arithmetic is the JAX package's, in float32:

- a convex hull is a Jarvis march of a fixed number of steps, emitted as a
  counter-clockwise ring padded by repeating its closing vertex (a padded
  vertex adds a zero-length edge, which adds nothing to an area or a clip);
  a point is a successor when every point lies left of the edge within the
  scale-relative tolerance ``1e-5 |d_j| |d_k| + 1e-6``, the farthest such
  point wins, the lowest index on a tie; the march starts at the lowest y,
  then the lowest x, then the lowest index;
- the hull is a discrete choice: its vertex indices are found without
  autograd and the points gathered with it, so an area's gradient reaches
  the chosen points only, as ``argmax`` gives none in JAX;
- two convex rings intersect by the Green's-theorem clip of
  :mod:`.iou` (the ``1e-9`` guards, the second ring shrunk by ``1 - 1e-6``
  toward its centroid);
- the minimum-area rectangle comes from rotating calipers over the hull's
  edges.

Sums over a ring's few vertices are written out in a fixed order
(:func:`_sum`), so a result does not depend on the device or on how many
rows a call holds. :func:`convex_iou` evaluates its (N, M) pairs in chunks
of rows whose size follows from the shapes (``CONVEX_IOU_PAIRS`` pairs a
chunk): the work per pair does not depend on the chunk, so a chunked
matrix equals the whole one bit for bit, and the memory stays bounded (the
loader's 512 padded gts against 8 x 21,824 point sets are 89 M pairs).
:func:`chamfer_distance` chunks its rows in the same way.
"""

from __future__ import annotations

import numpy as np
import torch

# pairs of (point set, polygon) a convex_iou chunk evaluates at once (~2 KB
# a pair at its peak)
CONVEX_IOU_PAIRS = 1 << 20
# (point, point) distances a chamfer_distance chunk holds at once
CHAMFER_PAIRS = 1 << 24


def _cross2(a, b):
    """z-component of the 2-D cross product, (..., 2) x (..., 2) -> (...)."""
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def _sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum over a short axis, one element after another in index order."""
    parts = x.unbind(dim)
    acc = parts[0]
    for part in parts[1:]:
        acc = acc + part
    return acc


def _norm2(d: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis of size 2."""
    return torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])


def _inside(px, py, poly) -> torch.Tensor:
    """Whether (px, py) lies inside the quadrilateral ``poly`` (..., 8), on
    the same side of all four edges (either winding), broadcast."""
    pos = neg = None
    for e in range(4):
        x0, y0 = poly[..., 2 * e], poly[..., 2 * e + 1]
        x1, y1 = poly[..., (2 * e + 2) % 8], poly[..., (2 * e + 3) % 8]
        cr = (x1 - x0) * (py - y0) - (y1 - y0) * (px - x0)
        pos = cr >= 0 if pos is None else pos & (cr >= 0)
        neg = cr <= 0 if neg is None else neg & (cr <= 0)
    return pos | neg


def points_in_polygons(points: torch.Tensor,
                       polygons: torch.Tensor) -> torch.Tensor:
    """points (..., N, 2); polygons (..., M, 8) -> (..., N, M) bool, the
    cross-product sign test of convex quadrilaterals in either winding."""
    return _inside(points[..., :, None, 0], points[..., :, None, 1],
                   polygons[..., None, :, :])


def points_in_own_polygon(points: torch.Tensor,
                          polys: torch.Tensor) -> torch.Tensor:
    """Row-wise :func:`points_in_polygons`: points (..., 2) each against its
    own polygon (..., 8) -> (...) bool (the diagonal of the (N, N) matrix,
    without making it)."""
    return _inside(points[..., 0], points[..., 1], polys)


def _chunk_rows(total_rows: int, per_row: int, budget: int) -> int:
    return max(1, min(total_rows, budget // max(per_row, 1)))


def chamfer_distance(set1: torch.Tensor, set2: torch.Tensor):
    """(..., N, 2) x (..., M, 2) -> the mean nearest-neighbour distance from
    each point of ``set1`` to ``set2`` and back, (...) each. The (N, M)
    distances are made for a chunk of rows at a time."""
    lead = torch.broadcast_shapes(set1.shape[:-2], set2.shape[:-2])
    n, m = set1.shape[-2], set2.shape[-2]
    a = set1.expand(lead + (n, 2)).reshape(-1, n, 2)
    b = set2.expand(lead + (m, 2)).reshape(-1, m, 2)
    rows = _chunk_rows(a.shape[0], n * m, CHAMFER_PAIRS)
    d1, d2 = [], []
    for s in range(0, a.shape[0], rows):
        d = _norm2(a[s:s + rows, :, None, :] - b[s:s + rows, None, :, :])
        d1.append(d.amin(-1).mean(-1))
        d2.append(d.amin(-2).mean(-1))
    return torch.cat(d1).reshape(lead), torch.cat(d2).reshape(lead)


@torch.no_grad()
def convex_hull_indices(points: torch.Tensor) -> torch.Tensor:
    """(..., n, 2) -> (..., n) int64: each set's counter-clockwise hull
    ring as point indices, padded by repeating the closing vertex (Jarvis
    march, n - 1 steps)."""
    lead, n = points.shape[:-2], points.shape[-2]
    p = points.reshape(-1, n, 2)
    x, y = p[..., 0], p[..., 1]
    low = y == y.amin(-1, keepdim=True)
    left = torch.where(low, x, float('inf'))
    first = low & (x == left.amin(-1, keepdim=True))
    start = first.to(torch.uint8).argmax(-1)                # (P,)
    out = [start]
    cur, done = start, torch.zeros_like(start, dtype=torch.bool)
    for _ in range(n - 1):
        base = p.gather(1, cur[:, None, None].expand(-1, 1, 2))
        d = p - base                                        # (P, n, 2)
        cr = d[:, :, None, 0] * d[:, None, :, 1] - \
            d[:, :, None, 1] * d[:, None, :, 0]             # (P, n, n)
        nrm = _norm2(d)                                     # (P, n)
        tol = 1e-5 * (nrm[:, :, None] * nrm[:, None, :]) + 1e-6
        ok = (cr >= -tol).all(-1)
        score = torch.where(ok, nrm, -1.0)
        nxt = score.argmax(-1)
        nxt = torch.where(done, cur, nxt)
        done = done | (nxt == start) | (nxt == cur)
        out.append(nxt)
        cur = nxt
    return torch.stack(out, -1).reshape(lead + (n,))


def convex_hull(points: torch.Tensor) -> torch.Tensor:
    """(..., n, 2) -> (..., n, 2) counter-clockwise hull rings padded by
    repeating the closing vertex; the gradient reaches the hull's
    points."""
    idx = convex_hull_indices(points)
    return points.gather(-2, idx[..., None].expand(points.shape))


def _poly_area_ccw(ring: torch.Tensor) -> torch.Tensor:
    """Shoelace over a padded counter-clockwise ring (..., K, 2)."""
    return 0.5 * _sum(_cross2(ring, torch.roll(ring, -1, dims=-2)))


def _clip_contributions(a_ring, b_ring):
    """Sum of cross(start, end) over the sub-segments of ring A's edges
    that lie inside ring B, (..., Ka, 2) x (..., Kb, 2) -> (...)."""
    d = torch.roll(a_ring, -1, dims=-2) - a_ring
    eb = torch.roll(b_ring, -1, dims=-2) - b_ring
    a_e, d_e = a_ring[..., :, None, :], d[..., :, None, :]
    vb_e, eb_e = b_ring[..., None, :, :], eb[..., None, :, :]
    num = _cross2(eb_e, a_e - vb_e)                         # (..., Ka, Kb)
    den = _cross2(eb_e, d_e)
    t_at = -num / torch.where(den.abs() > 1e-9, den, 1e-9)
    big = 1e9
    lower = torch.where(den > 1e-9, t_at, -big)
    upper = torch.where(den < -1e-9, t_at, big)
    parallel_out = (den.abs() <= 1e-9) & (num < 0)
    lower = torch.where(parallel_out, big, lower)
    # torch.maximum / minimum (not clamp) and amax / amin: at a tie the
    # gradient splits as jnp.maximum's and jnp.max's do
    t0 = torch.maximum(lower.amax(-1), lower.new_zeros(()))
    t1 = torch.minimum(upper.amin(-1), upper.new_ones(()))
    p0 = a_ring + t0[..., None] * d
    p1 = a_ring + t1[..., None] * d
    return _sum(torch.where(t1 > t0, _cross2(p0, p1), 0.0))


def _convex_clip_area(ring_a, ring_b):
    """Intersection area of two padded counter-clockwise rings, broadcast
    over the leading axes. Ring B is shrunk by ``1 - 1e-6`` toward its
    centroid, which breaks the double count of coincident boundaries."""
    cb = _sum(ring_b, -2)[..., None, :] / ring_b.shape[-2]
    ring_b = cb + (ring_b - cb) * (1 - 1e-6)
    area2 = _clip_contributions(ring_a, ring_b) + \
        _clip_contributions(ring_b, ring_a)
    return torch.maximum(0.5 * area2, area2.new_zeros(()))


def convex_iou(pointsets: torch.Tensor, polygons: torch.Tensor,
               pairs: int = CONVEX_IOU_PAIRS) -> torch.Tensor:
    """pointsets (..., N, 2 P); polygons (..., M, 8) -> (..., N, M): the IoU
    of each point set's convex hull with each quadrilateral, evaluated
    ``pairs`` pairs at a time (rows of N; the last chunk may be shorter).
    An intersection is bounded by the smaller area, since near-point hulls
    have vanishing half-plane constraints."""
    lead = torch.broadcast_shapes(pointsets.shape[:-2], polygons.shape[:-2])
    n, m = pointsets.shape[-2], polygons.shape[-2]
    pts = pointsets.reshape(pointsets.shape[:-1] + (-1, 2))
    hulls = convex_hull(pts)                                # (..., N, P, 2)
    quads = polygons.reshape(polygons.shape[:-1] + (4, 2))
    area_h = _poly_area_ccw(hulls).abs()                    # (..., N)
    area_q = _poly_area_ccw(quads).abs()                    # (..., M)
    batch = int(np.prod(lead)) if lead else 1
    rows = _chunk_rows(n, batch * m, pairs)
    inter = torch.cat([
        _convex_clip_area(hulls[..., s:s + rows, None, :, :],
                          quads[..., None, :, :, :])
        for s in range(0, n, rows)], -2) if n else \
        hulls.new_zeros(lead + (0, m))
    inter = torch.minimum(inter, torch.minimum(area_h[..., :, None],
                                               area_q[..., None, :]))
    union = area_h[..., :, None] + area_q[..., None, :] - inter
    return inter / torch.maximum(union, union.new_full((), 1e-6))


def convex_giou(pointsets: torch.Tensor,
                polygons: torch.Tensor) -> torch.Tensor:
    """Aligned convex GIoU, pointsets (..., 2 P) against polygons (..., 8)
    -> (...): IoU - (C - union) / C with C the area of the hull of both
    sets, held at least the union. Differentiable in the points."""
    pts = pointsets.reshape(pointsets.shape[:-1] + (-1, 2))
    quads = polygons.reshape(polygons.shape[:-1] + (4, 2))
    hulls = convex_hull(pts)
    area_h = _poly_area_ccw(hulls).abs()
    area_q = _poly_area_ccw(quads).abs()
    inter = _convex_clip_area(hulls, quads)
    inter = torch.minimum(inter, torch.minimum(area_h, area_q))
    union = area_h + area_q - inter
    iou = inter / torch.maximum(union, union.new_full((), 1e-6))
    enclose = convex_hull(torch.cat([pts, quads], -2))
    area_c = torch.maximum(_poly_area_ccw(enclose).abs(), union)
    return iou - (area_c - union) / torch.maximum(
        area_c, area_c.new_full((), 1e-6))


def min_area_polygons(pointsets: torch.Tensor) -> torch.Tensor:
    """(N, 2 P) point sets -> (N, 8) corners of each set's minimum-area
    enclosing rectangle (rotating calipers over the hull's edges; an edge
    under 1e-9 long is no candidate, and a set with none gives edge 0's
    frame)."""
    p = pointsets.reshape(pointsets.shape[0], -1, 2)
    hull = convex_hull(p)
    edges = torch.roll(hull, -1, dims=-2) - hull            # (N, P, 2)
    elen = _norm2(edges)
    u = edges / torch.maximum(elen, elen.new_full((), 1e-9))[..., None]
    v = torch.stack([-u[..., 1], u[..., 0]], -1)
    # (N, points, edges) projections, each a product of two
    px = p[:, :, None, 0] * u[:, None, :, 0] + \
        p[:, :, None, 1] * u[:, None, :, 1]
    py = p[:, :, None, 0] * v[:, None, :, 0] + \
        p[:, :, None, 1] * v[:, None, :, 1]
    w = px.amax(1) - px.amin(1)
    h = py.amax(1) - py.amin(1)
    area = torch.where(elen > 1e-9, w * h, float('inf'))
    k = area.argmin(-1)                                     # (N,)

    def pick(t):                                            # (N, E[, 2])
        idx = k.view(-1, *([1] * (t.dim() - 1)))
        return t.gather(1, idx.expand(-1, 1, *t.shape[2:]))[:, 0]

    uk, vk = pick(u), pick(v)
    pxk = px.gather(2, k[:, None, None].expand(-1, px.shape[1], 1))[..., 0]
    pyk = py.gather(2, k[:, None, None].expand(-1, py.shape[1], 1))[..., 0]
    x0, x1 = pxk.amin(1, keepdim=True), pxk.amax(1, keepdim=True)
    y0, y1 = pyk.amin(1, keepdim=True), pyk.amax(1, keepdim=True)
    corners = torch.stack([uk * x0 + vk * y0, uk * x1 + vk * y0,
                           uk * x1 + vk * y1, uk * x0 + vk * y1], 1)
    return corners.reshape(-1, 8)
