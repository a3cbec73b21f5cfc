"""Huge-image tiling: window planning and the merge of per-window
detections (counterpart of ``orientedobjectdetection_tpu/core/patch.py``;
reference ``core/patch/split.py:8-75`` and ``merge_results.py:7-127``).

Window planning is host numpy. The merge translates each window's
detections into the image frame and runs one rotated NMS per class on
``device``: the card unless ``'cpu'`` is asked for, where each class is one
launch of the pair-mask kernel.
"""

from __future__ import annotations

from math import ceil
from typing import Sequence

import numpy as np
import torch

from ..ops.nms import host_device, nms_rotated


def get_multiscale_patch(sizes: Sequence[int], steps: Sequence[int],
                         ratios: Sequence[float]):
    """Expand (sizes, steps) by inverse ratios (reference
    ``split.py:8-28``): ratio r rescales the image by r, which is windows
    of size / r at step / r."""
    if len(sizes) != len(steps):
        raise ValueError(f'{len(sizes)} sizes and {len(steps)} steps')
    final_sizes, final_steps = [], []
    for r in ratios:
        for s, st in zip(sizes, steps):
            final_sizes.append(int(round(s / r)))
            final_steps.append(int(round(st / r)))
    return final_sizes, final_steps


def slide_window(width: int, height: int, sizes: Sequence[int],
                 steps: Sequence[int], img_rate_thr: float = 0.6
                 ) -> np.ndarray:
    """``(n, 4)`` int64 windows ``(x, y, w, h)`` covering the image, the
    last of each row and column moved back inside it; windows whose
    in-image share is below ``img_rate_thr`` are dropped, unless none
    reaches it, when the largest share counts as 1 (reference
    ``split.py:31-75``)."""
    windows = []
    for size, step in zip(sizes, steps):
        if size < step:
            raise ValueError(f'size {size} < step {step}')
        x_num = 1 if width <= size else ceil((width - size) / step + 1)
        x_start = [step * i for i in range(x_num)]
        if len(x_start) > 1 and x_start[-1] + size > width:
            x_start[-1] = width - size
        y_num = 1 if height <= size else ceil((height - size) / step + 1)
        y_start = [step * i for i in range(y_num)]
        if len(y_start) > 1 and y_start[-1] + size > height:
            y_start[-1] = height - size
        for y in y_start:
            for x in x_start:
                windows.append((x, y, size, size))
    windows = np.asarray(windows, np.int64)

    x1 = np.clip(windows[:, 0], 0, width)
    y1 = np.clip(windows[:, 1], 0, height)
    x2 = np.clip(windows[:, 0] + windows[:, 2], 0, width)
    y2 = np.clip(windows[:, 1] + windows[:, 3], 0, height)
    rates = (x2 - x1) * (y2 - y1) / (windows[:, 2] * windows[:, 3])
    if not (rates >= img_rate_thr).any():
        rates[rates == rates.max()] = 1
    return windows[rates >= img_rate_thr]


def translate_and_merge(per_window_dets, per_window_labels,
                        per_window_valid, windows, num_classes: int,
                        iou_thr: float = 0.1, max_out: int = 2000,
                        device='cuda', plain_pair_mask: bool = False):
    """Merge padded per-window detections into the image frame.

    ``per_window_dets`` ``(W, K, 6)`` ``[cx, cy, w, h, a, score]``,
    ``per_window_labels`` and ``per_window_valid`` ``(W, K)``, ``windows``
    ``(W, 4)`` ``(x, y, w, h)``. Each class's valid detections of all
    windows go through one :func:`nms_rotated` on ``device`` and keep their
    window-major order; past ``max_out`` the highest scores are kept
    (reference ``merge_results.py:69-127``). Returns numpy ``(dets (n, 6),
    labels (n,))``."""
    dets = np.asarray(per_window_dets, np.float32).copy()
    windows = np.asarray(windows)
    dets[..., 0] += windows[:, None, 0]
    dets[..., 1] += windows[:, None, 1]
    labels = np.asarray(per_window_labels).reshape(-1)
    valid = np.asarray(per_window_valid).reshape(-1)
    flat = dets.reshape(-1, 6)
    device = host_device(device, 'translate_and_merge')

    out_d, out_l = [], []
    for cls in range(num_classes):
        cd = flat[valid & (labels == cls)]
        if len(cd) == 0:
            continue
        on_device = torch.from_numpy(cd).to(device)
        keep, _ = nms_rotated(on_device[None, :, :5], on_device[None, :, 5],
                              iou_thr, plain_pair_mask=plain_pair_mask)
        kept = cd[keep[0].cpu().numpy()]
        out_d.append(kept)
        out_l.append(np.full(len(kept), cls, np.int64))
    if not out_d:
        return np.zeros((0, 6), np.float32), np.zeros((0,), np.int64)
    dets = np.concatenate(out_d)
    labels = np.concatenate(out_l)
    if len(dets) > max_out:
        order = np.argsort(-dets[:, 5])[:max_out]
        dets, labels = dets[order], labels[order]
    return dets, labels
