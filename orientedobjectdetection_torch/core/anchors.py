"""Rotated anchors and point priors (counterpart of
``orientedobjectdetection_tpu/core/anchors.py``: ``RotatedAnchorGenerator``,
``PseudoAnchorGenerator`` and ``MlvlPointGenerator``).

mmdet's horizontal anchor grid with a zero angle appended, per level
``(H*W*A, 5)`` in ``(h*w, A)`` order: location-major, then the A base
anchors ratio-major (ratio outer, scale inner). The anchor-free heads take
one point per location in the same row-major order.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.registry import PRIOR_GENERATORS


def cached(cache: dict, key, make):
    """``cache[key]``, made by ``make()`` on a miss, kept apart for calls in
    inference mode and outside it: a head keeps its anchors and constants
    across calls, and a tensor made in inference mode (while a request is
    served) could not be saved for the backward of a later train step on
    the same module, while serving keeps the inference tensors it would
    have made anyway."""
    key = (key, torch.is_inference_mode_enabled())
    if key not in cache:
        cache[key] = make()
    return cache[key]


@PRIOR_GENERATORS.register_module()
class RotatedAnchorGenerator:
    """Anchor centers at ``x * stride`` (mmdet's default offset 0)."""

    def __init__(self,
                 strides: Sequence[int],
                 ratios: Sequence[float],
                 scales: Optional[Sequence[float]] = None,
                 base_sizes: Optional[Sequence[int]] = None,
                 octave_base_scale: Optional[float] = None,
                 scales_per_octave: Optional[int] = None,
                 center_offset: float = 0.0):
        self.strides = [(s, s) if isinstance(s, int) else s for s in strides]
        self.base_sizes = list(base_sizes) if base_sizes is not None \
            else [min(s) for s in self.strides]
        if scales is not None:
            self.scales = np.asarray(scales, np.float32)
        elif octave_base_scale is not None and scales_per_octave is not None:
            octave_scales = np.array(
                [2**(i / scales_per_octave) for i in range(scales_per_octave)])
            self.scales = (octave_scales * octave_base_scale).astype(
                np.float32)
        else:
            raise ValueError('either scales or octave_base_scale+'
                             'scales_per_octave must be set')
        self.ratios = np.asarray(ratios, np.float32)
        self.center_offset = center_offset
        self.base_anchors = self._gen_base_anchors()

    @property
    def num_base_anchors(self) -> List[int]:
        return [a.shape[0] for a in self.base_anchors]

    @property
    def num_levels(self) -> int:
        return len(self.strides)

    def _gen_base_anchors(self) -> List[np.ndarray]:
        """Per-level (A, 4) xyxy float32 base anchors (mmdet semantics)."""
        out = []
        for base_size in self.base_sizes:
            x_center = self.center_offset * base_size
            y_center = self.center_offset * base_size
            h_ratios = np.sqrt(self.ratios)
            w_ratios = 1 / h_ratios
            ws = (base_size * w_ratios[:, None] *
                  self.scales[None, :]).reshape(-1)
            hs = (base_size * h_ratios[:, None] *
                  self.scales[None, :]).reshape(-1)
            base = np.stack([x_center - 0.5 * ws, y_center - 0.5 * hs,
                             x_center + 0.5 * ws, y_center + 0.5 * hs], -1)
            out.append(base.astype(np.float32))
        return out

    def grid_priors(self, featmap_sizes: Sequence[Tuple[int, int]],
                    device='cpu') -> List[torch.Tensor]:
        """Per level (H*W*A, 5) float32 anchors [cx, cy, w, h, 0]."""
        if len(featmap_sizes) != self.num_levels:
            raise ValueError(f'{len(featmap_sizes)} feature maps for '
                             f'{self.num_levels} anchor levels')
        multi_level = []
        for lvl, (h, w) in enumerate(featmap_sizes):
            stride_w, stride_h = self.strides[lvl]
            shift_x = torch.arange(w, dtype=torch.float32,
                                   device=device) * stride_w
            shift_y = torch.arange(h, dtype=torch.float32,
                                   device=device) * stride_h
            sy, sx = torch.meshgrid(shift_y, shift_x, indexing='ij')
            shifts = torch.stack([sx.reshape(-1), sy.reshape(-1),
                                  sx.reshape(-1), sy.reshape(-1)], -1)
            base = torch.as_tensor(self.base_anchors[lvl], device=device)
            xyxy = (base[None, :, :] + shifts[:, None, :]).reshape(-1, 4)
            cx = (xyxy[:, 0] + xyxy[:, 2]) * 0.5
            cy = (xyxy[:, 1] + xyxy[:, 3]) * 0.5
            ww = xyxy[:, 2] - xyxy[:, 0]
            hh = xyxy[:, 3] - xyxy[:, 1]
            multi_level.append(
                torch.stack([cx, cy, ww, hh, torch.zeros_like(cx)], -1))
        return multi_level


@PRIOR_GENERATORS.register_module()
class PseudoAnchorGenerator:
    """The refine heads' generator (reference ``anchor_generator.py:54-75``):
    one anchor a location, whose box the previous stage gives, so it has
    valid flags and no grid priors."""

    def __init__(self, strides: Sequence[int]):
        self.strides = [(s, s) if isinstance(s, int) else s for s in strides]

    @property
    def num_base_anchors(self) -> List[int]:
        return [1 for _ in self.strides]

    @property
    def num_levels(self) -> int:
        return len(self.strides)

    def valid_flags(self, featmap_sizes: Sequence[Tuple[int, int]],
                    pad_shape, device='cpu') -> List[torch.Tensor]:
        """Per level (H*W,) bool: the location's cell lies inside the padded
        image (mmdet semantics)."""
        flags = []
        for lvl, (h, w) in enumerate(featmap_sizes):
            stride_w, stride_h = self.strides[lvl]
            valid_w = min(int(np.ceil(pad_shape[1] / stride_w)), w)
            valid_h = min(int(np.ceil(pad_shape[0] / stride_h)), h)
            vx = torch.arange(w, device=device) < valid_w
            vy = torch.arange(h, device=device) < valid_h
            flags.append((vy[:, None] & vx[None, :]).reshape(-1))
        return flags


@PRIOR_GENERATORS.register_module()
class MlvlPointGenerator:
    """Multi-level point priors for anchor-free heads (FCOS): per level
    ``(H*W, 2)`` float32 points ``(x + offset) * stride``, row-major, with
    ``(stride_w, stride_h)`` appended when ``with_stride``."""

    def __init__(self, strides: Sequence[int], offset: float = 0.5):
        self.strides = [(s, s) if isinstance(s, int) else s for s in strides]
        self.offset = offset

    @property
    def num_levels(self) -> int:
        return len(self.strides)

    def grid_priors(self, featmap_sizes: Sequence[Tuple[int, int]], device,
                    with_stride: bool = False) -> List[torch.Tensor]:
        out = []
        for lvl, (h, w) in enumerate(featmap_sizes):
            stride_w, stride_h = self.strides[lvl]
            x = (torch.arange(w, dtype=torch.float32, device=device)
                 + self.offset) * stride_w
            y = (torch.arange(h, dtype=torch.float32, device=device)
                 + self.offset) * stride_h
            yy, xx = torch.meshgrid(y, x, indexing='ij')
            cols = [xx.reshape(-1), yy.reshape(-1)]
            if with_stride:
                cols += [torch.full((h * w,), float(stride_w),
                                    device=device),
                         torch.full((h * w,), float(stride_h),
                                    device=device)]
            out.append(torch.stack(cols, -1))
        return out


def anchor_inside_flags(anchors: torch.Tensor, valid_flags: torch.Tensor,
                        img_shape, allowed_border: float = 0) -> torch.Tensor:
    """Rotated-anchor border filter (reference ``core/anchor/utils.py``):
    a centre-inside test when ``allowed_border >= 0``, else every valid
    anchor passes."""
    if allowed_border < 0:
        return valid_flags
    h, w = img_shape[0], img_shape[1]
    cx, cy = anchors[:, 0], anchors[:, 1]
    inside = (cx >= -allowed_border) & (cy >= -allowed_border) & \
        (cx < w + allowed_border) & (cy < h + allowed_border)
    return valid_flags & inside
