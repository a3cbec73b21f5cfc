"""Inference entry points (counterpart of
``orientedobjectdetection_tpu/apis/inference.py``; reference
``apis/inference.py`` and mmdet's ``init_detector`` /
``inference_detector``).

- :func:`init_detector`: config + optional mmrotate-style state dict -> a
  :class:`DetectorBundle` on the card (or on ``device="cpu"``).
- :func:`inference_detector`: one image -> the reference's per-class list
  of ``(n, 6)`` numpy detections.

Images cross the bundle's boundary as ``(B, H, W, 3)`` channels-last, as in
the JAX package; the network runs NCHW inside.
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch
from torch import nn

from ..models import build_detector
from ..utils.config import Config

_DEFAULT_NORM = dict(mean=[123.675, 116.28, 103.53],
                     std=[58.395, 57.12, 57.375], to_rgb=True)


class DetectorBundle:
    """Built detector + the decode/NMS that turns its maps into detections.

    ``device_norm``: optional ``img_norm_cfg`` dict. When set, the bundle
    normalizes on the device (:func:`normalize_images`) and callers feed RAW
    uint8 BGR images. ``plain_pair_mask`` makes the NMS build its pair mask
    with the plain PyTorch version instead of the CUDA kernel (a reference
    run on the card)."""

    def __init__(self, cfg, detector: nn.Module, dtype=torch.float32,
                 device_norm: Optional[dict] = None,
                 plain_pair_mask: bool = False):
        self.cfg = cfg
        self.detector = detector
        self.dtype = dtype
        self.device_norm = dict(device_norm) if device_norm else None
        self.plain_pair_mask = plain_pair_mask
        self.num_classes = int(cfg.model['bbox_head']['num_classes'])
        self.device = next(detector.parameters()).device

    @torch.inference_mode()
    def forward(self, images: torch.Tensor):
        """(B, H, W, 3) images -> the head's per-level float32 maps."""
        images = images.to(self.device)
        if self.device_norm is not None:
            from ..parallel.train_state import normalize_images
            images = normalize_images(images, self.device_norm)
        x = images.permute(0, 3, 1, 2).to(self.dtype)
        outputs = self.detector(x)
        return tuple(tuple(o.float() for o in level) for level in outputs)

    @torch.inference_mode()
    def decode(self, outputs):
        """Head maps -> (dets (B, max_per_img, 6), labels, valid)."""
        return self.detector.bboxes_from_outputs(
            outputs, plain_pair_mask=self.plain_pair_mask)

    def __call__(self, images: torch.Tensor):
        return self.decode(self.forward(images))


def init_detector(config: Union[str, Config], checkpoint=None,
                  device: Union[str, torch.device] = 'cuda',
                  dtype=torch.float32, seed: int = 0,
                  device_norm: Optional[dict] = None) -> DetectorBundle:
    """Build the configured detector with seeded weights, load
    ``checkpoint`` (a state dict with mmrotate names, or the path of a
    ``.pth`` holding one) over them, and move it
    to ``device`` in ``dtype`` (convolutions; frozen BN stays float32).

    Raises RuntimeError when ``device`` is a CUDA device and none is
    present: it never falls back to the CPU."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('init_detector: no CUDA device is available; '
                           'pass device="cpu" to run on the CPU')
    if isinstance(config, str):
        config = Config.fromfile(config)
    detector = build_detector(dict(config.model))
    detector.init_weights(seed)
    if isinstance(checkpoint, str):
        checkpoint = torch.load(checkpoint, map_location='cpu',
                                weights_only=True)
    if checkpoint is not None:
        state = checkpoint.get('state_dict', checkpoint)
        detector.load_state_dict(
            {k: torch.as_tensor(v) for k, v in state.items()})
    detector.eval().to(device)
    for m in detector.modules():
        if isinstance(m, nn.Conv2d):
            m.to(dtype)
    return DetectorBundle(config, detector, dtype, device_norm=device_norm)


def results_to_per_class(dets, labels, valid, num_classes: int
                         ) -> List[np.ndarray]:
    """Padded outputs of one image -> the reference's list of ``(n, 6)``
    arrays, one per class."""
    dets = torch.as_tensor(dets).cpu().numpy()
    labels = torch.as_tensor(labels).cpu().numpy()
    valid = torch.as_tensor(valid).cpu().numpy()
    return [dets[valid & (labels == c)] for c in range(num_classes)]


def _prep_image(img, img_norm_cfg=None) -> np.ndarray:
    """Load + host-normalize. ``img_norm_cfg=None`` returns the RAW uint8
    BGR image (for device-normalizing bundles)."""
    if isinstance(img, str):
        import cv2
        img = cv2.imread(img, cv2.IMREAD_COLOR)
    if img_norm_cfg is None:
        return img
    img = img.astype(np.float32)
    if img_norm_cfg.get('to_rgb', True):
        img = img[..., ::-1]
    mean = np.asarray(img_norm_cfg['mean'], np.float32)
    std = np.asarray(img_norm_cfg['std'], np.float32)
    return (img - mean) / std


def inference_detector(bundle: DetectorBundle, img,
                       img_norm_cfg=None) -> List[np.ndarray]:
    """Single-image inference (path or HWC BGR ndarray); pads to the
    config's ``pad_size`` (default 1024 x 1024)."""
    if bundle.device_norm is not None:
        img_norm_cfg = None                # the bundle normalizes on device
    elif img_norm_cfg is None:
        img_norm_cfg = _DEFAULT_NORM
    img = _prep_image(img, img_norm_cfg)
    pad = bundle.cfg.get('pad_size') or (1024, 1024)
    canvas = np.zeros((pad[0], pad[1], 3),
                      img.dtype if img.dtype == np.uint8 else np.float32)
    h = min(img.shape[0], pad[0])
    w = min(img.shape[1], pad[1])
    canvas[:h, :w] = img[:h, :w]
    dets, labels, valid = bundle(torch.from_numpy(canvas[None]))
    return results_to_per_class(dets[0], labels[0], valid[0],
                                bundle.num_classes)
