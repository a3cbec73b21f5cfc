"""Inference entry points (counterpart of
``orientedobjectdetection_tpu/apis/inference.py``; reference
``apis/inference.py`` and mmdet's ``init_detector`` /
``inference_detector``).

- :func:`init_detector`: config + optional mmrotate-style state dict -> a
  :class:`DetectorBundle` on the card (or on ``device="cpu"``).
- :func:`inference_detector`: one image -> the reference's per-class list
  of ``(n, 6)`` numpy detections.
- :func:`inference_detector_by_patches`: a huge image in windows, batched
  through the bundle, merged back by :func:`..core.patch.translate_and_merge`.
- :func:`inference_detector_tta`: the image and its flips, mapped back and
  merged by per-class rotated NMS.

Images cross the bundle's boundary as ``(B, H, W, 3)`` channels-last, as in
the JAX package; the network runs NCHW inside.
"""

from __future__ import annotations

import contextlib
import copy
from typing import List, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from ..core.patch import get_multiscale_patch, slide_window, \
    translate_and_merge
from ..models import build_detector
from ..models.detectors.single_stage import WEIGHTED_LAYERS
from ..ops.boxes import rbbox_flip
from ..ops.nms import nms_rotated_np
from ..utils.config import Config
from ..utils.image_io import imread

_DEFAULT_NORM = dict(mean=[123.675, 116.28, 103.53],
                     std=[58.395, 57.12, 57.375], to_rgb=True)


class DetectorBundle:
    """Built detector + the decode/NMS that turns its maps into detections.

    ``device_norm``: optional ``img_norm_cfg`` dict. When set, the bundle
    normalizes on the device (:func:`normalize_images`) and callers feed RAW
    uint8 BGR images. ``plain_pair_mask`` makes the NMS build its pair mask
    with the plain PyTorch version instead of the CUDA kernel, and
    ``plain_roi_align`` does the same for a two-stage detector's RoIAlign
    (reference runs on the card). A refine detector's (S2ANet, R3Det)
    class count is its ODM head's, else its last refine head's, else its
    FAM head's, and a two-stage detector's that of its last RoI bbox head,
    as in the JAX package.

    Serving runs in inference mode. The heads keep the anchors and coder
    constants they make in it apart from those they make outside it
    (:func:`..core.anchors.cached`), so a later train step on the same
    module can save its own for the backward.

    ``devices``: data-parallel inference inside one process (the JAX
    package's ``mesh=``): one replica of ``detector`` on each device (the
    first is ``detector`` itself, which must lie on ``devices[0]``), and a
    call splits the batch's leading axis into ``len(devices)`` contiguous
    shards (``torch.tensor_split``), runs each on its own device and
    concatenates the padded detections in order on ``devices[0]``, with no
    collective. :meth:`load_state_dict` loads every replica."""

    def __init__(self, cfg, detector: nn.Module, dtype=torch.float32,
                 device_norm: Optional[dict] = None,
                 plain_pair_mask: bool = False,
                 plain_roi_align: bool = False,
                 devices: Optional[Sequence] = None):
        self.cfg = cfg
        self.detector = detector
        self.dtype = dtype
        self.device_norm = dict(device_norm) if device_norm else None
        self.plain_pair_mask = plain_pair_mask
        self.plain_roi_align = plain_roi_align
        model = cfg.model
        self.two_stage = bool(model.get('roi_head'))
        head = model.get('bbox_head')
        if head is None and self.two_stage:
            head = model['roi_head']['bbox_head']
            if isinstance(head, (list, tuple)):    # RoI Transformer's stages
                head = head[-1]
        if head is None:                        # refine (S2ANet)
            head = model.get('odm_head') or \
                (model.get('refine_heads') or [None])[-1] or \
                model.get('fam_head')
        if head is None:
            raise ValueError('the model config has no bbox_head, '
                             'roi_head.bbox_head, odm_head, refine_heads '
                             'or fam_head')
        self.num_classes = int(head['num_classes'])
        self.device = next(detector.parameters()).device
        self.replicas = [detector]
        if devices:
            devices = [torch.device(d) for d in devices]
            if devices[0] != self.device:
                raise ValueError(f'the detector lies on {self.device}, not '
                                 f'on devices[0] = {devices[0]}')
            self.replicas += [copy.deepcopy(detector).to(d)
                              for d in devices[1:]]

    @property
    def devices(self) -> List[torch.device]:
        return [next(r.parameters()).device for r in self.replicas]

    def load_state_dict(self, state_dict) -> None:
        """Load ``state_dict`` into every replica."""
        for r in self.replicas:
            r.load_state_dict(state_dict)

    def prepare(self, images: torch.Tensor,
                device: Optional[torch.device] = None) -> torch.Tensor:
        """(B, H, W, 3) images -> the network's NCHW input on the device, in
        the serving dtype, normalized there when ``device_norm`` is set."""
        images = images.to(device or self.device)
        if self.device_norm is not None:
            from ..parallel.train_state import normalize_images
            images = normalize_images(images, self.device_norm)
        return images.permute(0, 3, 1, 2).to(self.dtype)

    @torch.inference_mode()
    def forward(self, images: torch.Tensor, replica: int = 0):
        """(B, H, W, 3) images -> the detector's outputs with every
        floating-point tensor in float32: the head's per-level maps, a
        two-stage detector's dict of proposals and RoI-head outputs, or a
        refine detector's dict of its stages' maps and rois."""
        detector = self.replicas[replica]
        x = self.prepare(images, next(detector.parameters()).device)
        if self.two_stage:
            return _float32(detector(
                x, plain_roi_align=self.plain_roi_align))
        return _float32(detector(x))

    @torch.inference_mode()
    def decode(self, outputs, replica: int = 0):
        """Detector outputs -> (dets (B, max_per_img, 6), labels, valid)."""
        return self.replicas[replica].bboxes_from_outputs(
            outputs, plain_pair_mask=self.plain_pair_mask)

    def __call__(self, images: torch.Tensor):
        if len(self.replicas) == 1:
            return self.decode(self.forward(images))
        parts = []
        for i, shard in enumerate(torch.tensor_split(images,
                                                     len(self.replicas))):
            device = self.devices[i]
            with (torch.cuda.device(device) if device.type == 'cuda'
                  else contextlib.nullcontext()):
                parts.append(self.decode(self.forward(shard, i), i))
        return tuple(torch.cat([p[k].to(self.device) for p in parts])
                     for k in range(3))


def _float32(outputs):
    """Nested dicts, lists and tuples of tensors with every floating-point
    tensor cast to float32."""
    if isinstance(outputs, dict):
        return {k: _float32(v) for k, v in outputs.items()}
    if isinstance(outputs, (list, tuple)):
        return type(outputs)(_float32(v) for v in outputs)
    return outputs.float() if outputs.is_floating_point() else outputs


def init_detector(config: Union[str, Config], checkpoint=None,
                  device: Union[str, torch.device] = 'cuda',
                  dtype=torch.float32, seed: int = 0,
                  device_norm: Optional[dict] = None,
                  devices: Optional[Sequence] = None) -> DetectorBundle:
    """Build the configured detector with seeded weights, load
    ``checkpoint`` (a state dict with mmrotate names, or the path of a
    ``.pth`` holding one, such as a training checkpoint) over them, and
    move it
    to ``device`` in ``dtype`` (convolutions, linear layers and ORConv2d;
    frozen BN stays float32). ``devices``: a replica on each, the batch
    split over them (:class:`DetectorBundle`); ``device`` is then
    ``devices[0]``.

    Raises RuntimeError when ``device`` is a CUDA device and none is
    present: it never falls back to the CPU."""
    if devices:
        device = devices[0]
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
        # a state dict, mmcv's {'state_dict': ...} or the trainer's
        # {'model': ..., 'optimizer': ..., 'step': ...}
        state = checkpoint.get('state_dict', checkpoint.get('model',
                                                            checkpoint))
        detector.load_state_dict(
            {k: torch.as_tensor(v) for k, v in state.items()})
    detector.eval().to(device)
    for m in detector.modules():
        if isinstance(m, WEIGHTED_LAYERS):
            m.to(dtype)
    return DetectorBundle(config, detector, dtype, device_norm=device_norm,
                          devices=devices)


def results_to_per_class(dets, labels, valid, num_classes: int
                         ) -> List[np.ndarray]:
    """Padded outputs of one image -> the reference's list of ``(n, 6)``
    arrays, one per class."""
    dets = torch.as_tensor(dets).cpu().numpy()
    labels = torch.as_tensor(labels).cpu().numpy()
    valid = torch.as_tensor(valid).cpu().numpy()
    return [dets[valid & (labels == c)] for c in range(num_classes)]


def _prep_image(img, img_norm_cfg=None) -> np.ndarray:
    """Load (a PNG, JPEG, BMP or TIFF path, :func:`..utils.image_io.imread`) +
    host-normalize.
    ``img_norm_cfg=None`` returns the RAW uint8 BGR image (for
    device-normalizing bundles)."""
    if isinstance(img, str):
        img = imread(img)
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
    """Single-image inference (PNG, JPEG, BMP or TIFF path, or HWC BGR
    ndarray); pads to the config's ``pad_size`` (default 1024 x 1024)."""
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


def inference_detector_by_patches(bundle: DetectorBundle, img,
                                  sizes: Sequence[int] = (1024,),
                                  steps: Sequence[int] = (824,),
                                  ratios: Sequence[float] = (1.0,),
                                  merge_iou_thr: float = 0.1,
                                  bs: int = 4,
                                  img_norm_cfg=None) -> List[np.ndarray]:
    """Huge-image inference (reference ``apis/inference.py:13-94``): the
    windows of :func:`slide_window` over the image (sizes and steps
    expanded by ``ratios``), ``bs`` windows a batch, each window cropped
    into a zero canvas of the largest window's size; the windows'
    detections merged in the image frame by per-class rotated NMS at
    ``merge_iou_thr`` on the bundle's device. The last batch holds only the
    windows that are left. Returns the per-class list of ``(n, 6)``
    arrays."""
    if bundle.device_norm is not None:
        img_norm_cfg = None                # the bundle normalizes on device
    elif img_norm_cfg is None:
        img_norm_cfg = _DEFAULT_NORM
    norm = _prep_image(img, img_norm_cfg)
    height, width = norm.shape[:2]
    sizes_f, steps_f = get_multiscale_patch(sizes, steps, ratios)
    windows = slide_window(width, height, sizes_f, steps_f)
    win_size = int(windows[:, 2].max())
    tile_dtype = norm.dtype if norm.dtype == np.uint8 else np.float32
    all_dets, all_labels, all_valid = [], [], []
    for b in range(0, len(windows), bs):
        batch_wins = windows[b:b + bs]
        tiles = np.zeros((len(batch_wins), win_size, win_size, 3),
                         tile_dtype)
        for i, (x, y, w, h) in enumerate(batch_wins):
            crop = norm[y:y + h, x:x + w]
            tiles[i, :crop.shape[0], :crop.shape[1]] = crop
        dets, labels, valid = bundle(torch.from_numpy(tiles))
        all_dets.append(dets.cpu().numpy())
        all_labels.append(labels.cpu().numpy())
        all_valid.append(valid.cpu().numpy())
    merged_dets, merged_labels = translate_and_merge(
        np.concatenate(all_dets), np.concatenate(all_labels),
        np.concatenate(all_valid), windows, bundle.num_classes,
        iou_thr=merge_iou_thr, device=bundle.device,
        plain_pair_mask=bundle.plain_pair_mask)
    return [merged_dets[merged_labels == c]
            for c in range(bundle.num_classes)]


def inference_detector_tta(bundle: DetectorBundle, img,
                           directions=('horizontal', 'vertical'),
                           img_norm_cfg=None,
                           version: str = 'le90') -> List[np.ndarray]:
    """Flip test-time augmentation (reference ``rotated_anchor_head.py
    :692-787`` aug_test and ``bbox_nms_rotated.py:95-144``): the image and
    each flip through :func:`inference_detector`, the flips' detections
    mapped back by :func:`..ops.boxes.rbbox_flip` in the frame of the
    image's own shape (the flip happens before the padding), then one
    rotated NMS at 0.1 per class on the bundle's device."""
    if isinstance(img, str):
        img = imread(img)
    variants = [(img, None)]
    for d in directions:
        flipped = img[:, ::-1] if d == 'horizontal' else img[::-1]
        variants.append((np.ascontiguousarray(flipped), d))

    all_dets = {c: [] for c in range(bundle.num_classes)}
    for im, d in variants:
        for c, dets in enumerate(inference_detector(bundle, im,
                                                    img_norm_cfg)):
            dets = np.asarray(dets, np.float32).reshape(-1, 6)
            if d is not None and len(dets):
                mapped = rbbox_flip(dets[:, :5], im.shape[:2], d, version)
                dets = np.concatenate([mapped.astype(np.float32),
                                       dets[:, 5:6]], -1)
            all_dets[c].append(dets)

    out = []
    for c in range(bundle.num_classes):
        merged = np.concatenate(all_dets[c])
        if len(merged):
            merged = merged[nms_rotated_np(
                merged[:, :5], merged[:, 5], 0.1, device=bundle.device,
                plain_pair_mask=bundle.plain_pair_mask)]
        out.append(merged)
    return out
