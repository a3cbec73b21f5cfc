"""Rotated-box geometry: the part of the angle-convention system the
inference path needs (counterpart of
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
