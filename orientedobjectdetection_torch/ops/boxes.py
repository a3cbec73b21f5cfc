"""Rotated-box geometry: the part of the angle-convention system the
inference and training paths need (counterpart of
``orientedobjectdetection_tpu/ops/boxes.py``).

Box layout everywhere: ``(..., 5) = (cx, cy, w, h, theta)``, theta in
radians. Conventions (reference ``mmrotate/core/bbox/transforms.py:850-867``):

- ``oc``:    theta in (0, pi/2]; passed through unchanged.
- ``le90``:  theta in [-pi/2, pi/2).
- ``le135``: theta in [-pi/4, 3*pi/4).
"""

from __future__ import annotations

import math

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
