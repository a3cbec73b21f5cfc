"""Rotated-box geometry: the part of the angle-convention system the
inference and training paths need (counterpart of
``orientedobjectdetection_tpu/ops/boxes.py``).

Box layout everywhere: ``(..., 5) = (cx, cy, w, h, theta)``, theta in
radians. Conventions (reference ``mmrotate/core/bbox/transforms.py:850-867``):

- ``oc``:    theta in (0, pi/2]; passed through unchanged.
- ``le90``:  theta in [-pi/2, pi/2).
- ``le135``: theta in [-pi/4, 3*pi/4).

The ``*_np`` functions and :func:`min_area_rect` are the numpy twins the
host data path uses (DOTA polygons to training targets, detections to
submission polygons); they need no OpenCV.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PI = math.pi

_VALID_VERSIONS = ('oc', 'le90', 'le135')


def norm_angle(angle, angle_range: str):
    """Normalize angles into the range of the given convention."""
    if angle_range == 'oc':
        return angle
    if angle_range == 'le135':
        return (angle + PI / 4) % PI - PI / 4
    if angle_range == 'le90':
        return (angle + PI / 2) % PI - PI / 2
    raise NotImplementedError(f'unknown angle_range {angle_range!r}')


def obb2poly(obbs: torch.Tensor, version: str = 'oc') -> torch.Tensor:
    """(..., 5) obbs -> (..., 8) corner polygons (TL, TR, BR, BL in the box
    frame, counter-clockwise in image coordinates with y down)."""
    if version not in _VALID_VERSIONS:
        raise NotImplementedError(version)
    x, y, w, h, a = obbs.unbind(-1)
    cosa, sina = torch.cos(a), torch.sin(a)
    wx, wy = w / 2 * cosa, w / 2 * sina
    hx, hy = -h / 2 * sina, h / 2 * cosa
    return torch.stack([x - wx - hx, y - wy - hy,
                        x + wx - hx, y + wy - hy,
                        x + wx + hx, y + wy + hy,
                        x - wx + hx, y - wy + hy], -1)


def poly2obb(polys: torch.Tensor, version: str = 'oc') -> torch.Tensor:
    """(..., 8) polygons -> (..., 5) obbs, batched: the reference's
    edge-based construction (``transforms.py:242-331``). The corners are
    taken to form a rectangle and are not re-fit: w and h are edge lengths,
    the angle comes from the longer edge (le90 / le135) or the oc quadrant
    rule. Unlike :func:`poly2obb_np` (the least rectangle of any polygon),
    a quadrilateral that is not a rectangle gives this construction's
    box, as the Gliding Vertex decode needs."""
    pts = polys.reshape(polys.shape[:-1] + (4, 2))
    if version == 'oc':
        cx = pts[..., 0].mean(-1)
        cy = pts[..., 1].mean(-1)
        e01 = torch.linalg.norm(pts[..., 0, :] - pts[..., 1, :], dim=-1)
        e12 = torch.linalg.norm(pts[..., 1, :] - pts[..., 2, :], dim=-1)
        theta0 = torch.atan2(-(pts[..., 1, 0] - pts[..., 0, 0]),
                             pts[..., 1, 1] - pts[..., 0, 1])
        odd = torch.remainder(torch.floor(theta0 / (PI * 0.5)), 2) == 0
        return torch.stack([cx, cy, torch.where(odd, e12, e01),
                            torch.where(odd, e01, e12),
                            torch.remainder(theta0, PI * 0.5)], -1)
    if version not in ('le90', 'le135'):
        raise NotImplementedError(version)
    pt1, pt2, pt3, pt4 = pts.unbind(-2)
    edge1 = torch.linalg.norm(pt1 - pt2, dim=-1)
    edge2 = torch.linalg.norm(pt2 - pt3, dim=-1)
    angle1 = torch.atan2(pt2[..., 1] - pt1[..., 1], pt2[..., 0] - pt1[..., 0])
    angle2 = torch.atan2(pt4[..., 1] - pt1[..., 1], pt4[..., 0] - pt1[..., 0])
    angles = norm_angle(torch.where(edge1 > edge2, angle1, angle2), version)
    return torch.stack([(pt1[..., 0] + pt3[..., 0]) / 2,
                        (pt1[..., 1] + pt3[..., 1]) / 2,
                        torch.maximum(edge1, edge2),
                        torch.minimum(edge1, edge2), angles], -1)


def obb2hbb(obbs: torch.Tensor, version: str = 'oc') -> torch.Tensor:
    """(..., 5) obbs -> (..., 5) circumscribed horizontal boxes in obb form
    (reference ``transforms.py:502-576``): ``oc`` swaps w/h and sets
    theta = pi/2; le90 / le135 keep the long edge as w with theta in
    {0, -pi/2} / {0, pi/2}."""
    x, y, w, h, a = obbs.unbind(-1)
    if version == 'oc':
        cosa, sina = torch.cos(a), torch.sin(a)
        hw = cosa * w + sina * h
        hh = sina * w + cosa * h
        return torch.stack([x, y, hh, hw, torch.full_like(a, PI / 2)], -1)
    if version not in ('le90', 'le135'):
        raise NotImplementedError(version)
    cosa, sina = torch.cos(a).abs(), torch.sin(a).abs()
    ew = cosa * w + sina * h
    eh = sina * w + cosa * h
    long_first = ew >= eh
    short_angle = -PI / 2 if version == 'le90' else PI / 2
    a_out = torch.where(long_first, torch.zeros_like(a),
                        torch.full_like(a, short_angle))
    return torch.stack([x, y, torch.where(long_first, ew, eh),
                        torch.where(long_first, eh, ew), a_out], -1)


def obb2xyxy(obbs: torch.Tensor, version: str = 'oc') -> torch.Tensor:
    """(..., 5) obbs -> (..., 4) circumscribed axis-aligned (x1, y1, x2, y2)
    (reference ``transforms.py:637-702``; the general |cos|, |sin| formula
    for every convention, as the JAX package)."""
    if version not in _VALID_VERSIONS:
        raise NotImplementedError(version)
    x, y, w, h, a = obbs.unbind(-1)
    cosa, sina = torch.cos(a).abs(), torch.sin(a).abs()
    dw = cosa * w + sina * h
    dh = sina * w + cosa * h
    return torch.stack([x - dw / 2, y - dh / 2, x + dw / 2, y + dh / 2], -1)


def hbb2obb(hbbs: torch.Tensor, version: str = 'oc') -> torch.Tensor:
    """(..., 4) xyxy -> (..., 5) obbs per convention (reference
    ``transforms.py:579-634``)."""
    x = (hbbs[..., 0] + hbbs[..., 2]) * 0.5
    y = (hbbs[..., 1] + hbbs[..., 3]) * 0.5
    w = hbbs[..., 2] - hbbs[..., 0]
    h = hbbs[..., 3] - hbbs[..., 1]
    if version == 'oc':
        return torch.stack([x, y, h, w, torch.full_like(x, PI / 2)], -1)
    if version not in ('le90', 'le135'):
        raise NotImplementedError(version)
    long_first = w >= h
    short_angle = -PI / 2 if version == 'le90' else PI / 2
    a_out = torch.where(long_first, torch.zeros_like(x),
                        torch.full_like(x, short_angle))
    return torch.stack([x, y, torch.where(long_first, w, h),
                        torch.where(long_first, h, w), a_out], -1)


# ---- Gaussians (G-RepPoints) ------------------------------------------------
def _rotation(cos_t, sin_t) -> torch.Tensor:
    return torch.stack([cos_t, -sin_t, sin_t, cos_t], -1).reshape(
        cos_t.shape + (2, 2))


def _rotate_diag(rot, diag) -> torch.Tensor:
    """R diag(d) R^T for (..., 2, 2) rotations and (..., 2) diagonals."""
    prod = rot[..., :, None, :] * diag[..., None, None, :] * \
        rot[..., None, :, :]
    return prod[..., 0] + prod[..., 1]


def gt2gaussian(target: torch.Tensor):
    """(..., 5) obbs -> (mu (..., 2), sigma (..., 2, 2)), sigma =
    R diag((w/2)^2, (h/2)^2) R^T with w and h clamped to [1e-7, 1e7] (the
    losses' ``xy_wh_r_2_xy_sigma`` convention)."""
    wh = target[..., 2:4].clamp(1e-7, 1e7)
    r = target[..., 4]
    half = 0.5 * wh
    return target[..., :2], _rotate_diag(_rotation(torch.cos(r),
                                                   torch.sin(r)), half * half)


def gt2gaussian_poly(polys: torch.Tensor, L: float = 3.0):
    """(..., 8) or (..., 4, 2) corner polygons -> (mu, sigma), the
    G-RepPoints convention (reference ``core/bbox/transforms.py:916-937``):
    mu the corners' mean, sigma = R diag(w^2, h^2) / (4 L^2) R^T with w, h
    the first two edges' lengths (their squares clamped at 1e-7) and R the
    first edge's direction, so the box spans +-L sigma."""
    p = polys.reshape(polys.shape[:-1] + (4, 2)) if polys.shape[-1] == 8 \
        else polys
    center = (p[..., 0, :] + p[..., 1, :] + p[..., 2, :] + p[..., 3, :]) / 4
    edge_1 = p[..., 1, :] - p[..., 0, :]
    edge_2 = p[..., 2, :] - p[..., 1, :]
    w2 = torch.clamp(edge_1[..., 0] * edge_1[..., 0] +
                     edge_1[..., 1] * edge_1[..., 1], min=1e-7)
    h2 = torch.clamp(edge_2[..., 0] * edge_2[..., 0] +
                     edge_2[..., 1] * edge_2[..., 1], min=1e-7)
    rot = _rotation(edge_1[..., 0] / torch.sqrt(w2),
                    edge_1[..., 1] / torch.sqrt(w2))
    diag = torch.stack([w2, h2], -1) / (4 * L * L)
    return center, _rotate_diag(rot, diag)


def gaussian2bbox(mu: torch.Tensor, sigma: torch.Tensor,
                  L: float = 3.0) -> torch.Tensor:
    """The inverse of :func:`gt2gaussian_poly`: mu (..., 2), sigma (..., 2,
    2) symmetric -> (..., 8) corner polygons, from the closed-form
    eigendecomposition of a symmetric 2x2 (eigenvalues clamped at 1e-12;
    the reference takes an SVD)."""
    a = sigma[..., 0, 0]
    b = sigma[..., 0, 1]
    c = sigma[..., 1, 1]
    theta = 0.5 * torch.atan2(2 * b, a - c)
    mean = 0.5 * (a + c)
    root = torch.sqrt(torch.clamp(((a - c) / 2) ** 2 + b ** 2, min=0.0))
    lam1 = torch.clamp(mean + root, min=1e-12)
    lam2 = torch.clamp(mean - root, min=1e-12)
    h1, h2 = L * torch.sqrt(lam1), L * torch.sqrt(lam2)
    d = torch.stack([torch.stack([-h1, h2], -1), torch.stack([h1, h2], -1),
                     torch.stack([h1, -h2], -1),
                     torch.stack([-h1, -h2], -1)], -2)      # (..., 4, 2)
    rot = _rotation(torch.cos(theta), torch.sin(theta))
    # corner k = mu + R d_k
    prod = rot[..., None, :, :] * d[..., :, None, :]        # (..., 4, 2, 2)
    corners = mu[..., None, :] + prod[..., 0] + prod[..., 1]
    return corners.reshape(mu.shape[:-1] + (8,))


# ---- numpy twins (the host data path) --------------------------------------
def min_area_rect(points) -> tuple:
    """The rotated rectangle of least area around ``(n, 2)`` points, in
    ``cv2.minAreaRect``'s form ``((cx, cy), (w, h), angle)``: the angle in
    degrees in [-90, 0), ``w`` the side along that direction. Each edge of
    the convex hull is tried as a side; the first of least area wins."""
    pts = np.asarray(points, np.float64).reshape(-1, 2)
    hull = _convex_hull(pts)
    if len(hull) < 3:
        d = hull[-1] - hull[0]
        centre = (hull[0] + hull[-1]) / 2
        rect = (centre, float(np.hypot(*d)), 0.0,
                math.degrees(math.atan2(d[1], d[0])))
    else:
        rect, best = None, math.inf
        for i in range(len(hull)):
            d = hull[(i + 1) % len(hull)] - hull[i]
            u = d / np.hypot(*d)
            along, across = hull @ u, hull @ np.array([-u[1], u[0]])
            w = along.max() - along.min()
            h = across.max() - across.min()
            if w * h < best:
                best = w * h
                centre = (u * (along.max() + along.min()) / 2 +
                          np.array([-u[1], u[0]]) *
                          (across.max() + across.min()) / 2)
                rect = (centre, w, h,
                        math.degrees(math.atan2(u[1], u[0])))
    centre, w, h, angle = rect
    while angle >= 0:
        angle -= 90
        w, h = h, w
    while angle < -90:
        angle += 90
        w, h = h, w
    f32 = np.float32                      # OpenCV's RotatedRect is float32
    return ((float(f32(centre[0])), float(f32(centre[1]))),
            (float(f32(w)), float(f32(h))), float(f32(angle)))


def _convex_hull(pts: np.ndarray) -> np.ndarray:
    """Andrew's monotone chain; collinear and repeated points dropped."""
    order = np.lexsort((pts[:, 1], pts[:, 0]))
    pts = pts[order]

    def turn(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    def half(seq):
        out = []
        for p in seq:
            while len(out) >= 2 and turn(out[-2], out[-1], p) <= 0:
                out.pop()
            out.append(p)
        return out

    lower, upper = half(pts), half(pts[::-1])
    hull = np.array(lower[:-1] + upper[:-1])
    return hull if len(hull) else pts[:1]


def poly2obb_np(poly, version: str = 'oc'):
    """One polygon ``(8,)`` -> ``(cx, cy, w, h, a)``, or None when an edge
    of its rectangle is under 2 px (JAX ``ops/boxes.py:poly2obb_np``; the
    reference's host loaders). ``oc`` and ``le90`` go through
    :func:`min_area_rect` and its angle convention; ``le135`` takes the
    polygon's own first corners."""
    if version in ('oc', 'le90'):
        (x, y), (w, h), a = min_area_rect(
            np.asarray(poly, np.float32).reshape(4, 2))
        if w < 2 or h < 2:
            return None
        if version == 'oc':
            while not 0 < a <= 90:
                if a == -90:
                    a += 180
                else:
                    a += 90
                    w, h = h, w
            return x, y, w, h, a / 180 * PI
        a = a / 180 * PI
        if w < h:
            w, h = h, w
            a += PI / 2
        while not PI / 2 > a >= -PI / 2:
            a += -PI if a >= PI / 2 else PI
        return x, y, w, h, a
    if version == 'le135':
        p = np.asarray(poly[:8], np.float32)
        pt1, pt2, pt3, pt4 = p[0:2], p[2:4], p[4:6], p[6:8]
        edge1 = float(np.linalg.norm(pt1 - pt2))
        edge2 = float(np.linalg.norm(pt2 - pt3))
        if edge1 < 2 or edge2 < 2:
            return None
        if edge1 > edge2:
            angle = float(np.arctan2(pt2[1] - pt1[1], pt2[0] - pt1[0]))
        else:
            angle = float(np.arctan2(pt4[1] - pt1[1], pt4[0] - pt1[0]))
        angle = float(norm_angle(np.asarray(angle), 'le135'))
        return (float(pt1[0] + pt3[0]) / 2, float(pt1[1] + pt3[1]) / 2,
                max(edge1, edge2), min(edge1, edge2), angle)
    raise NotImplementedError(version)


def obb2poly_np(obbs, version: str = 'oc') -> np.ndarray:
    """``(n, 6)`` ``[cx, cy, w, h, a, score]`` (or ``(n, 5)``) -> ``(n, 9)``
    polygons and score, corners in the DOTA submission order
    (:func:`get_best_begin_point`), float32 as the JAX twin computes them."""
    obbs = np.asarray(obbs, np.float32)
    if obbs.size == 0:
        return np.zeros((0, 9), np.float32)
    x, y, w, h, a = (obbs[:, i] for i in range(5))
    score = obbs[:, 5] if obbs.shape[1] > 5 else np.zeros_like(x)
    cosa, sina = np.cos(a), np.sin(a)
    wx, wy = w / 2 * cosa, w / 2 * sina
    hx, hy = -h / 2 * sina, h / 2 * cosa
    polys = np.stack([x - wx - hx, y - wy - hy, x + wx - hx, y + wy - hy,
                      x + wx + hx, y + wy + hy, x - wx + hx, y - wy + hy,
                      score], axis=-1)
    return get_best_begin_point(polys)


def get_best_begin_point(polys) -> np.ndarray:
    """Rotate each polygon's corner order so that the first corner is the
    one nearest the top-left corner of its circumscribed box (the cyclic
    shift of least summed distance to that box's corners)."""
    polys = np.asarray(polys, np.float64)
    pts = polys[:, :8].reshape(-1, 4, 2)
    lo, hi = pts.min(axis=1), pts.max(axis=1)
    dst = np.stack([lo, np.stack([hi[:, 0], lo[:, 1]], -1), hi,
                    np.stack([lo[:, 0], hi[:, 1]], -1)], axis=1)
    costs = np.stack([np.linalg.norm(np.roll(pts, -s, axis=1) - dst,
                                     axis=-1).sum(axis=1)
                      for s in range(4)], axis=1)
    best = costs.argmin(axis=1)
    out = polys.copy()
    for s in range(4):
        m = best == s
        out[m, :8] = np.roll(pts[m], -s, axis=1).reshape(-1, 8)
    return out.astype(np.float32)


def rbbox_flip(bboxes, img_shape, direction: str = 'horizontal',
               version: str = 'oc') -> np.ndarray:
    """Flip ``(..., 5)`` rotated boxes in an image of ``img_shape``
    (``(h, w, ...)``), as the test-time flips do (JAX
    ``ops/boxes.py:rbbox_flip``)."""
    bboxes = np.asarray(bboxes)
    x, y, w, h, a = (bboxes[..., i] for i in range(5))
    if direction == 'horizontal':
        x = img_shape[1] - x - 1
    elif direction == 'vertical':
        y = img_shape[0] - y - 1
    elif direction == 'diagonal':
        return np.stack([img_shape[1] - x - 1, img_shape[0] - y - 1, w, h,
                         a], -1)
    else:
        raise ValueError(direction)
    if version == 'oc':
        turned = a != PI / 2
        return np.stack([x, y, np.where(turned, h, w),
                         np.where(turned, w, h),
                         np.where(turned, PI / 2 - a, a)], -1)
    return np.stack([x, y, w, h, norm_angle(-a, version)], -1)
