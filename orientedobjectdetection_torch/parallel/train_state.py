"""Device-side image normalization (counterpart of
``orientedobjectdetection_tpu/parallel/train_state.py:normalize_images``).
The training state and step come with the training slice."""

from __future__ import annotations

import torch


def normalize_images(images: torch.Tensor, norm: dict) -> torch.Tensor:
    """Raw (uint8) BGR ``(B, H, W, 3)`` images -> normalized float32, on the
    images' device: the pipeline's ``Normalize`` step moved after the copy,
    so the host sends a quarter of the bytes. ``norm`` is the config's
    ``img_norm_cfg`` (mean/std in BGR order as mmcv's; ``to_rgb`` flips the
    channel axis first)."""
    x = images.to(torch.float32)
    if norm.get('to_rgb', True):
        x = x.flip(-1)
    mean = x.new_tensor(norm['mean'])
    inv_std = 1.0 / x.new_tensor(norm['std'])
    return (x - mean) * inv_std
