#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (H100).

Drives the port's two main paths, serving and training, on Rotated
RetinaNet R50-FPN le90 at full width
(configs/rotated_retinanet/rotated_retinanet_obb_r50_fpn_1x_dota_le90.py)
with seeded random weights, through ``init_detector`` / ``DetectorBundle``
and ``create_train_state`` / ``make_train_step``, and holds every CUDA
kernel of those paths against its plain PyTorch version:

1. device    require a CUDA device; print its name and power limit
2. build     compile the kernels from csrc/ with nvcc, all at once (ptxas
             report)
3. kernel    nms_pair_mask vs its plain version on DOTA-like inputs
             (B=8 x N=2000, N=300, duplicates and padding); time both
4. slice     float32, 2 images of 1024^2: detections with the kernel equal
             those with the plain pair mask
5. serving   bfloat16, batch 8 of 1024^2 uint8 images: throughput, the
             split between forward and decode+NMS, peak memory, launches
6. kernel    box_iou_rotated vs its plain version at the assignment shape
             (B=8, G=32 gts x the 196,416 anchors of a 1024^2 image; IoF;
             G=128 dense gts; duplicates and zero padding); time both
7. train     float32, 2 images: one train step with the kernel and one
   slice     from the same state with the plain IoU matrix agree
8. training  bfloat16 autocast, batch 8 of 1024^2 uint8 images, the
             config's optimizer: 3 warm + 10 timed steps, imgs/s, peak
             memory, launches per step, a falling loss, one profiled step

Every phase raises on failure. The launch counts are set to 0 just before
each main path (5, 8) and read just after. The last two lines of standard
output are one JSON object with the kernels' numbers and one with the
device: ``{"ok": true, "device": {"platform": "gpu", "kind": ...,
"count": 1}}``. Run from the repository root: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'configs',
                      'rotated_retinanet',
                      'rotated_retinanet_obb_r50_fpn_1x_dota_le90.py')
IOU_THR = 0.1            # the config's test_cfg.nms.iou_thr
BAND = 2e-3              # mask may differ only this close to the threshold
DETS_ATOL = 1e-3
# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s and
# fp32 (non-tensor-core) FLOP/s, at the full 700 W power limit.
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
FLOP_PER_PAIR = 300      # the TPU kernel's cost model (iou_pallas.py:459)
FLOP_PER_IOU_PAIR = 600  # the same for the IoU matrix (iou_pallas.py:386)
# IoU matrix, kernel vs plain: sincosf and FMA contraction move an IoU by up
# to ~1e-5 (largest seen on an H100: 8.1e-6, an IoF close to 1)
IOU_ATOL = 2e-5
LOSS_RTOL = 1e-4         # train step, kernel vs plain matrix
ASSIGN_THRS = (0.4, 0.5)  # the config's neg_iou_thr and pos_iou_thr
ASSIGN_BAND = 1e-5       # assignments may differ this close to a threshold
KERNELS = {
    'nms_pair_mask': dict(
        route='cuda', source='orientedobjectdetection_torch/csrc/'
        'nms_pair_mask.cu',
        replaces='orientedobjectdetection_tpu/ops/iou_pallas.py:399'),
    'box_iou_rotated': dict(
        route='cuda', source='orientedobjectdetection_torch/csrc/'
        'box_iou_rotated.cu',
        replaces='orientedobjectdetection_tpu/ops/iou_pallas.py:347'),
}


def log(msg: str):
    print(msg, flush=True)


def sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


def kernel_wrappers() -> dict:
    """Kernel name -> the wrapper that counts its launches."""
    from orientedobjectdetection_torch.ops.iou_kernels import (
        box_iou_rotated_matrix, nms_pair_mask)
    return {'nms_pair_mask': nms_pair_mask,
            'box_iou_rotated': box_iou_rotated_matrix}


def reset_launches():
    for wrapper in kernel_wrappers().values():
        wrapper.launches = 0


def read_launches() -> dict:
    return {name: w.launches for name, w in kernel_wrappers().items()}


# ---- 1. device -----------------------------------------------------------
def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError('chip_smoke: no CUDA device is available')
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f'[device] {kind} x{torch.cuda.device_count()}, torch '
        f'{torch.__version__}, CUDA {torch.version.cuda}')
    log(smi)                 # name, power limit: as nvidia-smi gives them
    return dict(kind=kind, count=torch.cuda.device_count(), card=smi)


# ---- 2. build ------------------------------------------------------------
def phase_build():
    from orientedobjectdetection_torch.utils.cuda_build import build
    t0 = time.perf_counter()
    libs = build(list(KERNELS))
    log(f'[build] {len(libs)} kernel(s) in '
        f'{time.perf_counter() - t0:.2f} s')
    for name, lib in libs.items():
        log(f'[build] {name}: nvcc {lib.seconds:.2f} s -> {lib.path.name}')
        for line in lib.log.splitlines():
            if 'registers' in line or 'spill' in line or 'smem' in line:
                log(f'[build]   {line.strip()}')


# ---- 3. kernel vs plain --------------------------------------------------
def dota_candidates(bsz, n, seed, num_classes=15, duplicates=False):
    """Score-sorted, class-major NMS inputs like the multiclass path makes:
    centres in 0-1024, sides 4-64 px, angles in [-pi/2, pi/2), 15 classes.
    ``duplicates``: neighbours repeat boxes exactly, and the last quarter is
    zero-size padding of class ``num_classes``."""
    rng = np.random.default_rng(seed)
    boxes = np.stack([rng.uniform(0, 1024, (bsz, n)),
                      rng.uniform(0, 1024, (bsz, n)),
                      rng.uniform(4, 64, (bsz, n)),
                      rng.uniform(4, 64, (bsz, n)),
                      rng.uniform(-np.pi / 2, np.pi / 2, (bsz, n))],
                     -1).astype(np.float32)
    cls = np.sort(rng.integers(0, num_classes, (bsz, n)), -1)
    if duplicates:
        boxes[:, 1::2] = boxes[:, 0:-1:2]
        cls[:, 1::2] = cls[:, 0:-1:2]
        pad = n // 4
        boxes[:, -pad:] = 0.0
        cls[:, -pad:] = num_classes
    return boxes, cls.astype(np.int32)


def check_pair_mask(boxes, cls) -> tuple:
    """Kernel (wrapper) vs plain version on the same device tensors.
    Returns (max |kernel - plain| outside the band, in-band mismatches)."""
    from orientedobjectdetection_torch.ops.iou_kernels import (
        nms_pair_mask, nms_pair_mask_plain, pair_iou)
    got = nms_pair_mask(boxes, IOU_THR, cls)
    ref = nms_pair_mask_plain(boxes, IOU_THR, cls)
    band = (pair_iou(boxes) - IOU_THR).abs() < BAND
    diff = (got.int() - ref.int()).abs()
    err = int(diff[~band].max()) if (~band).any() else 0
    if err:
        raise AssertionError(f'pair mask differs from the plain version '
                             f'outside the band at {int((diff[~band]).sum())}'
                             f' pairs')
    n = boxes.shape[1]
    lower = torch.ones(n, n, dtype=torch.bool, device=boxes.device).tril()
    if got[:, lower].any():
        raise AssertionError('pair mask has bits on or below the diagonal')
    return err, int(diff[band].sum())


def time_ms(fn, reps, device, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    sync(device)
    if torch.device(device).type == 'cuda':
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def pair_mask_bound_ms(boxes, cls) -> tuple:
    """Least time for these inputs: each input byte read and each output
    byte written once, and FLOP_PER_PAIR for every pair the data needs
    (same class, i < j), at the published peaks."""
    n = boxes.shape[1]
    same = cls[:, :, None] == cls[:, None, :]
    live = int(torch.triu(same, diagonal=1).sum())
    nbytes = (boxes.numel() * 4 + cls.numel() * 4 + boxes.shape[0] * n * n)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = live * FLOP_PER_PAIR / PEAK_FP32 * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                 else 'operations'), live


def phase_kernel(device, card='', bsz=8, n=2000, small_n=300, reps=50,
                 plain_reps=3) -> dict:
    from orientedobjectdetection_torch.ops.iou_kernels import (
        nms_pair_mask, nms_pair_mask_plain)
    cases = {'main': dota_candidates(bsz, n, 0),
             'small': dota_candidates(bsz, small_n, 1),
             'duplicates': dota_candidates(2, small_n, 2, duplicates=True)}
    max_err = 0
    main = None
    for name, (b, c) in cases.items():
        boxes = torch.from_numpy(b).to(device)
        cls = torch.from_numpy(c).to(device)
        err, in_band = check_pair_mask(boxes, cls)
        max_err = max(max_err, err)
        log(f'[kernel] nms_pair_mask {name} B={b.shape[0]} N={b.shape[1]}: '
            f'equal to plain outside +-{BAND} of thr={IOU_THR} '
            f'({in_band} in-band differences)')
        if name == 'main':
            main = (boxes, cls)
    boxes, cls = main
    ms = time_ms(lambda: nms_pair_mask(boxes, IOU_THR, cls), reps, device)
    plain_ms = time_ms(lambda: nms_pair_mask_plain(boxes, IOU_THR, cls),
                       plain_reps, device, warmup=1)
    bound_ms, bound_by, live = pair_mask_bound_ms(boxes, cls)
    log(f'[kernel] {card} | nms_pair_mask B={bsz} N={n}: kernel {ms:.4f} '
        f'ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}; '
        f'{live} same-class pairs), library none')
    return dict(name='nms_pair_mask', **KERNELS['nms_pair_mask'],
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


# ---- 4./5. the detector ----------------------------------------------------
def build_bundle(device, dtype, max_candidates=2000, seed=0):
    """The config's detector with seeded weights, normalizing raw uint8 BGR
    images on the device.

    Random weights leave every score near the focal prior 0.01, below
    score_thr 0.05, so NMS would see padding only: the class bias is zeroed
    (scores near 0.5) so the path carries real boxes, and the regression
    output is scaled down so boxes stay near their anchors, where they
    overlap as a trained detector's do. ``max_candidates`` is the config's
    NMS size (2000); the CPU rehearsal makes it small."""
    from orientedobjectdetection_torch.apis import init_detector
    from orientedobjectdetection_torch.utils import Config
    cfg = Config.fromfile(CONFIG)
    bundle = init_detector(cfg, device=device, dtype=dtype, seed=seed,
                           device_norm=cfg.img_norm_cfg)
    head = bundle.detector.bbox_head
    head.test_cfg['max_candidates'] = max_candidates
    with torch.no_grad():
        head.retina_cls.bias.zero_()
        head.retina_reg.weight.mul_(0.05)
    return bundle


def raw_images(bsz, size, seed) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (bsz, size, size, 3),
                                         dtype=np.uint8))


def nms_inputs_per_image(bundle, outputs) -> list:
    """Valid (box, class) candidates entering NMS, per image: scores above
    score_thr, capped at max_candidates."""
    head = bundle.detector.bbox_head
    cfg = head.test_cfg
    with torch.inference_mode():
        _, scores = head.candidates(outputs)
    over = (scores > float(cfg.get('score_thr', 0.05))).flatten(1).sum(1)
    cap = int(cfg.get('max_candidates', 2000))
    return [min(int(v), cap) for v in over]


def check_dets(dets, labels, valid, bsz, num_classes):
    if dets.shape[0] != bsz or dets.shape[-1] != 6:
        raise AssertionError(f'dets shape {tuple(dets.shape)}')
    if not torch.isfinite(dets).all():
        raise AssertionError('non-finite detections')
    if not valid.any(1).all():
        raise AssertionError('an image produced no detection')
    lv = labels[valid]
    if (lv < 0).any() or (lv >= num_classes).any() or \
            (labels[~valid] != -1).any():
        raise AssertionError('labels out of range')


def phase_slice(device, bsz=2, size=1024, max_candidates=2000) -> None:
    """float32: the slice run with the kernel and run again with the plain
    pair mask gives the same detections."""
    from orientedobjectdetection_torch.apis import DetectorBundle
    bundle = build_bundle(device, torch.float32, max_candidates)
    plain = DetectorBundle(bundle.cfg, bundle.detector, torch.float32,
                           device_norm=bundle.device_norm,
                           plain_pair_mask=True)
    images = raw_images(bsz, size, 10)
    dets, labels, valid = bundle(images)
    p_dets, p_labels, p_valid = plain(images)
    sync(device)
    check_dets(dets, labels, valid, bsz, bundle.num_classes)
    if not (torch.equal(valid, p_valid) and torch.equal(labels, p_labels)):
        raise AssertionError('kernel and plain pair mask give different '
                             'labels or valid flags')
    err = float((dets - p_dets).abs().max())
    if err > DETS_ATOL:
        raise AssertionError(f'dets differ by {err} > {DETS_ATOL}')
    log(f'[slice] float32 B={bsz} {size}^2: kernel and plain pair mask '
        f'agree (labels/valid exact, dets max |diff| {err:.3g}); '
        f'valid dets per image {valid.sum(1).tolist()}; NMS candidates per '
        f'image {nms_inputs_per_image(bundle, bundle.forward(images))}')


def phase_serving(device, card='', bsz=8, size=1024, warm=3, timed=10,
                  dtype=torch.bfloat16, max_candidates=2000) -> dict:
    """Requests of ``bsz`` raw images through the bundle; returns the
    kernels' launch counts of this run."""
    bundle = build_bundle(device, dtype, max_candidates)
    images = raw_images(bsz, size, 20)
    if torch.device(device).type == 'cuda':
        images = images.pin_memory()
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    fwd, dec = [], []
    for i in range(warm + timed):
        t0 = time.perf_counter()
        outputs = bundle.forward(images)
        sync(device)
        t1 = time.perf_counter()
        dets, labels, valid = bundle.decode(outputs)
        sync(device)
        t2 = time.perf_counter()
        if i >= warm:
            fwd.append(t1 - t0)
            dec.append(t2 - t1)
    counts = read_launches()
    launches = counts['nms_pair_mask']
    expected = warm + timed if torch.device(device).type == 'cuda' else 0
    if launches != expected:
        raise AssertionError(f'nms_pair_mask launched {launches} times for '
                             f'{warm + timed} requests (expected {expected})')
    check_dets(dets, labels, valid, bsz, bundle.num_classes)
    total = sum(fwd) + sum(dec)
    mem = (torch.cuda.max_memory_allocated() / 2**30
           if torch.device(device).type == 'cuda' else float('nan'))
    log(f'[serving] {card} | {str(dtype).split(".")[-1]} B={bsz} {size}^2, '
        f'{timed} timed requests after {warm} warm: '
        f'{bsz * timed / total:.2f} imgs/s; per request forward '
        f'{1e3 * sum(fwd) / timed:.2f} ms, decode+NMS '
        f'{1e3 * sum(dec) / timed:.2f} ms; peak memory {mem:.2f} GiB; '
        f'nms_pair_mask launches {launches} for {warm + timed} requests')
    log(f'[serving] NMS candidates per image '
        f'{nms_inputs_per_image(bundle, outputs)}; valid dets per image '
        f'{valid.sum(1).tolist()}')
    profile_request(bundle, images, device)
    return counts


def profile_request(bundle, images, device):
    """One more request under torch.profiler."""
    from torch.profiler import record_function

    def request():
        with record_function('request.forward'):
            outputs = bundle.forward(images)
        with record_function('request.decode_nms'):
            bundle.decode(outputs)

    profile_run(request, device, 'request', 'request.')


def profile_run(fn, device, label, prefix, top=12) -> dict:
    """``fn()`` once under torch.profiler: device busy share of its wall
    time, the device time of the kernels launched inside each
    ``record_function`` range named ``prefix*`` (on the calling thread), and
    the kernels that take the most device time. Returns device microseconds
    by kernel name, by range, and in total."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        sync(device)
        wall_us = (time.perf_counter() - t0) * 1e6
    averages = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    # the record_function ranges also appear as device-side spans: not
    # kernels
    kernels = [e for e in averages if e.device_type == cuda
               and not e.key.startswith(prefix)]
    busy_us = sum(e.self_device_time_total for e in kernels)
    result = dict(busy_us=busy_us, wall_us=wall_us, spans={},
                  kernels={e.key: e.self_device_time_total for e in kernels})
    if busy_us == 0:
        log(f'[profile] {label} {wall_us / 1e3:.2f} ms; device time not '
            f'measured by the profiler')
        return result
    log(f'[profile] {label} {wall_us / 1e3:.2f} ms wall (profiler on), '
        f'device busy {busy_us / 1e3:.2f} ms ({100 * busy_us / wall_us:.1f}'
        f'%), {sum(e.count for e in kernels)} kernel launches')
    for e in averages:
        if e.key.startswith(prefix) and e.device_type != cuda:
            result['spans'][e.key] = e.device_time_total
            log(f'[profile]   {e.key}: host {e.cpu_time_total / 1e3:.2f} ms,'
                f' device {e.device_time_total / 1e3:.2f} ms in its '
                f'kernels')
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f'[profile]   {e.self_device_time_total / 1e3:8.3f} ms '
            f'{e.count:5d}x  {e.key[:90]}')
    return result


# ---- 6. IoU matrix kernel vs plain ------------------------------------------
def config_anchors(size, device) -> torch.Tensor:
    """The config's anchors for a ``size`` x ``size`` image, (N, 5), level
    by level in grid order, as the head's loss sees them."""
    from orientedobjectdetection_torch.utils import Config
    from orientedobjectdetection_torch.utils.registry import PRIOR_GENERATORS
    from orientedobjectdetection_torch import core  # noqa: F401 (registers)
    cfg = Config.fromfile(CONFIG).model['bbox_head']['anchor_generator']
    gen = PRIOR_GENERATORS.build(dict(cfg))
    sizes = [(-(-size // s[1]), -(-size // s[0])) for s in gen.strides]
    return torch.cat(gen.grid_priors(sizes, device=device), 0)


def seeded_gts(anchors, bsz, g, valid, seed, duplicates=False):
    """Padded gt sets (B, G, 5), labels and mask: ``valid`` boxes per image,
    each a perturbed copy of an anchor at most a quarter of the image (or
    64 px) wide, so each has anchors above the positive threshold, zero
    boxes after.
    ``duplicates``: every second valid box repeats the one before it."""
    rng = np.random.default_rng(seed)
    pool = anchors.cpu().numpy()
    extent = float(pool[:, :2].max())
    pool = pool[pool[:, 2:4].max(1) <= max(extent / 4, 64.0)]
    gts = np.zeros((bsz, g, 5), np.float32)
    for b in range(bsz):
        box = pool[rng.choice(len(pool), valid)].copy()
        box[:, :2] += rng.uniform(-3, 3, (valid, 2))
        box[:, 2:4] *= rng.uniform(0.8, 1.25, (valid, 2))
        box[:, 4] = rng.uniform(-0.3, 0.3, valid)
        if duplicates:
            pairs = valid // 2
            box[1:2 * pairs:2] = box[0:2 * pairs:2]
        gts[b, :valid] = box
    labels = rng.integers(0, 15, (bsz, g)).astype(np.int64)
    mask = np.arange(g)[None, :].repeat(bsz, 0) < valid
    return (torch.from_numpy(gts), torch.from_numpy(labels),
            torch.from_numpy(mask))


def reachable(boxes1, boxes2) -> torch.Tensor:
    """(..., N, M) bool: the pairs whose bounding rects, inflated to
    r = (w + h) / 2, meet. Every other pair has IoU exactly 0 and the
    kernel skips its clip math."""
    r1 = 0.5 * (boxes1[..., 2] + boxes1[..., 3])[..., :, None]
    r2 = 0.5 * (boxes2[..., 2] + boxes2[..., 3])[..., None, :]
    dx = (boxes1[..., 0][..., :, None] - boxes2[..., 0][..., None, :]).abs()
    dy = (boxes1[..., 1][..., :, None] - boxes2[..., 1][..., None, :]).abs()
    return (dx <= r1 + r2) & (dy <= r1 + r2)


def check_iou_matrix(boxes1, boxes2, mode) -> tuple:
    """Kernel (wrapper) vs plain version on the same device tensors.
    Returns (max |kernel - plain|, live pairs)."""
    from orientedobjectdetection_torch.ops.iou_kernels import (
        box_iou_rotated_matrix, box_iou_rotated_matrix_plain)
    got = box_iou_rotated_matrix(boxes1, boxes2, mode)
    ref = box_iou_rotated_matrix_plain(boxes1, boxes2, mode)
    if got.shape != ref.shape:
        raise AssertionError(f'shape {tuple(got.shape)} vs plain '
                             f'{tuple(ref.shape)}')
    if not torch.isfinite(got).all():
        raise AssertionError('non-finite IoU')
    err = float((got - ref).abs().max())
    if err > IOU_ATOL:
        raise AssertionError(f'IoU matrix differs from the plain version by '
                             f'{err} > {IOU_ATOL}')
    live = reachable(boxes1, boxes2)
    if live.dim() < got.dim():
        live = live.expand_as(got)
    if (got[~live] != 0).any() or (ref[~live] != 0).any():
        raise AssertionError('an out-of-reach pair is not exactly 0')
    return err, int(live.sum())


def iou_matrix_bound_ms(boxes1, boxes2, live) -> tuple:
    """Least time for these inputs: each input byte read and each output
    byte written once, and FLOP_PER_IOU_PAIR for every pair within reach,
    at the published peaks."""
    batch = max(b.shape[0] if b.dim() == 3 else 1 for b in (boxes1, boxes2))
    out_bytes = batch * boxes1.shape[-2] * boxes2.shape[-2] * 4
    nbytes = boxes1.numel() * 4 + boxes2.numel() * 4 + out_bytes
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = live * FLOP_PER_IOU_PAIR / PEAK_FP32 * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                 else 'operations')


def phase_iou_kernel(device, card='', bsz=8, g=32, valid=8, size=1024,
                     dense_g=128, reps=50, plain_reps=3) -> dict:
    from orientedobjectdetection_torch.ops.iou_kernels import (
        box_iou_rotated_matrix, box_iou_rotated_matrix_plain)
    anchors = config_anchors(size, device)
    n = anchors.shape[0]
    gts = seeded_gts(anchors, bsz, g, valid, 30)[0].to(device)
    dense = seeded_gts(anchors, 2, dense_g, dense_g, 31)[0].to(device)
    dup = seeded_gts(anchors, 2, g, valid, 32, duplicates=True)[0].to(device)
    cases = {
        'assignment': (gts, anchors, 'iou'),            # (B, G, N)
        'ignore-iof': (anchors, gts, 'iof'),            # (B, N, K)
        'dense': (dense, anchors, 'iou'),
        'duplicates': (dup, anchors, 'iou'),
        'one-image': (dup[0].contiguous(), anchors, 'iof'),
    }
    max_err = 0.0
    main_live = 0
    for name, (b1, b2, mode) in cases.items():
        err, live = check_iou_matrix(b1, b2, mode)
        max_err = max(max_err, err)
        total = max(b.shape[0] if b.dim() == 3 else 1 for b in (b1, b2)) * \
            b1.shape[-2] * b2.shape[-2]
        log(f'[kernel] box_iou_rotated {name} {tuple(b1.shape)} x '
            f'{tuple(b2.shape)} {mode}: max |kernel - plain| {err:.3g} <= '
            f'{IOU_ATOL}; {live} of {total} pairs within reach, the rest '
            f'exactly 0')
        if name == 'assignment':
            main_live = live
    ms = time_ms(lambda: box_iou_rotated_matrix(gts, anchors), reps, device)
    plain_ms = time_ms(lambda: box_iou_rotated_matrix_plain(gts, anchors),
                       plain_reps, device, warmup=1)
    bound_ms, bound_by = iou_matrix_bound_ms(gts, anchors, main_live)
    log(f'[kernel] {card} | box_iou_rotated B={bsz} G={g} ({valid} valid) '
        f'N={n}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound '
        f'{bound_ms:.4f} ms ({bound_by}; {main_live} pairs within reach), '
        f'library none')
    return dict(name='box_iou_rotated', **KERNELS['box_iou_rotated'],
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


# ---- 7./8. the trainer ------------------------------------------------------
def build_trainer(device, dtype, seed=0, plain_iou=False):
    """The config's detector with seeded weights and the config's optimizer
    (SGD, momentum, weight decay, clip, linear warmup, frozen stem and
    stage 1), normalizing raw uint8 BGR images on the device. Returns
    (detector, state, train_step). ``plain_iou``: the assigner computes its
    IoU matrix with the plain version (a reference run)."""
    from orientedobjectdetection_torch.models import build_detector
    from orientedobjectdetection_torch.parallel import (
        build_lr_schedule, build_optimizer, create_train_state,
        make_train_step)
    from orientedobjectdetection_torch.utils import Config
    cfg = Config.fromfile(CONFIG)
    detector = build_detector(dict(cfg.model))
    detector.bbox_head.assigner.plain_iou = plain_iou
    schedule = build_lr_schedule(dict(cfg.lr_config), cfg.optimizer['lr'],
                                 steps_per_epoch=1000)
    tx = build_optimizer(dict(cfg.optimizer), schedule,
                         grad_clip=cfg.optimizer_config['grad_clip'],
                         frozen_stages=detector.backbone.frozen_stages)
    state = create_train_state(detector, tx, device=device, seed=seed)
    step = make_train_step(detector, tx, device_norm=cfg.img_norm_cfg,
                           dtype=dtype)
    return detector, state, step


def train_batch(bsz, size, g, valid, seed, device) -> dict:
    """Raw uint8 images and seeded padded gts, on the host (pinned when the
    run is on a card)."""
    gts, labels, mask = seeded_gts(config_anchors(size, 'cpu'), bsz, g,
                                   valid, seed)
    batch = dict(images=raw_images(bsz, size, seed + 1), gt_bboxes=gts,
                 gt_labels=labels, gt_mask=mask)
    if torch.device(device).type == 'cuda':
        batch = {k: v.pin_memory() for k, v in batch.items()}
    return batch


def check_assignments(detector, batch, size, device) -> tuple:
    """The assigner on the batch's gts with the kernel and with the plain
    matrix: equal except where a prior's max IoU lies within ASSIGN_BAND of
    a threshold or its IoU with some gt within ASSIGN_BAND of that gt's best
    (a low-quality match that rounding can move). Returns (positives,
    differing priors, all of them inside the band)."""
    from orientedobjectdetection_torch.ops.iou_kernels import (
        box_iou_rotated_matrix_plain)
    assigner = detector.bbox_head.assigner
    anchors = config_anchors(size, device)
    gts, labels, mask = (batch[k].to(device) for k in
                         ('gt_bboxes', 'gt_labels', 'gt_mask'))
    was = assigner.plain_iou
    try:
        assigner.plain_iou = False
        got = assigner(anchors, gts, labels, mask)
        assigner.plain_iou = True
        ref = assigner(anchors, gts, labels, mask)
    finally:
        assigner.plain_iou = was
    differ = got.assigned_gt_inds != ref.assigned_gt_inds
    overlaps = box_iou_rotated_matrix_plain(gts, anchors)
    overlaps = overlaps * mask[:, :, None]
    near_best = ((overlaps - overlaps.amax(2, keepdim=True)).abs()
                 < ASSIGN_BAND).any(1)
    band = near_best.clone()
    for thr in ASSIGN_THRS:
        band |= (ref.max_overlaps - thr).abs() < ASSIGN_BAND
    outside = int((differ & ~band).sum())
    if outside:
        raise AssertionError(f'{outside} assignments differ between kernel '
                             f'and plain outside the band')
    if float((got.max_overlaps - ref.max_overlaps).abs().max()) > IOU_ATOL:
        raise AssertionError('max_overlaps differ between kernel and plain')
    return int((got.assigned_gt_inds >= 0).sum()), int(differ.sum())


def check_metrics(metrics):
    for k in ('loss_cls', 'loss_bbox', 'loss', 'grad_norm'):
        if not torch.isfinite(metrics[k]):
            raise AssertionError(f'{k} is not finite: {metrics[k]}')


def one_train_step(device, batch, plain_iou) -> tuple:
    """A fresh seeded float32 trainer takes one step on ``batch``. Checks
    that exactly the trainable tensors moved; returns the metrics as floats
    and the numbers of frozen and trainable tensors."""
    detector, state, step = build_trainer(device, torch.float32,
                                          plain_iou=plain_iou)
    before = {n: p.detach().clone() for n, p in detector.named_parameters()}
    state, metrics = step(state, batch)
    sync(device)
    check_metrics(metrics)
    for n, p in detector.named_parameters():
        moved = not torch.equal(p, before[n])
        if moved != p.requires_grad:
            raise AssertionError(f'{n}: frozen tensor changed' if moved
                                 else f'{n}: trainable tensor did not change')
    frozen = sum(not p.requires_grad for p in detector.parameters())
    return ({k: float(v) for k, v in metrics.items()}, frozen,
            len(before) - frozen)


def phase_train_slice(device, bsz=2, size=1024, g=32, valid=8) -> None:
    """float32: one train step with the kernel and one from the same seeded
    state with the plain IoU matrix give the same assignments and losses;
    frozen tensors stay, trainable ones move."""
    batch = train_batch(bsz, size, g, valid, 40, device)
    detector = build_trainer(device, torch.float32)[0]
    positives, differ = check_assignments(detector, batch, size, device)
    del detector
    if positives < 1:
        raise AssertionError('the batch has no positive anchor')
    kernel, frozen, trainable = one_train_step(device, batch, False)
    plain = one_train_step(device, batch, True)[0]
    for k in ('loss_cls', 'loss_bbox'):
        if abs(kernel[k] - plain[k]) > LOSS_RTOL * abs(plain[k]):
            raise AssertionError(f'{k}: kernel {kernel[k]} vs plain '
                                 f'{plain[k]}')
    log(f'[train-slice] float32 B={bsz} {size}^2, G={g} ({valid} valid): '
        f'{positives} positive anchors; assignments with kernel and plain '
        f'matrix differ at {differ} priors, all within {ASSIGN_BAND} of a '
        f'threshold or of a gt\'s best IoU; kernel {kernel} vs plain '
        f'{plain} (rtol {LOSS_RTOL}); {frozen} frozen tensors unchanged, '
        f'{trainable} trainable tensors changed')


def phase_training(device, card='', bsz=8, size=1024, g=32, valid=8, warm=3,
                   timed=10, dtype=torch.bfloat16) -> dict:
    """``warm + timed`` train steps on one fixed batch; returns the
    kernels' launch counts of this run."""
    on_card = torch.device(device).type == 'cuda'
    detector, state, step = build_trainer(device, dtype)
    batch = train_batch(bsz, size, g, valid, 50, device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    history = []
    for _ in range(warm):
        state, metrics = step(state, batch)
        history.append(metrics)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(timed):
        state, metrics = step(state, batch)
        history.append(metrics)
    sync(device)
    seconds = time.perf_counter() - t0
    counts = read_launches()
    launches = counts['box_iou_rotated']
    expected = warm + timed if on_card else 0   # one IoU matrix per step
    if launches != expected:
        raise AssertionError(f'box_iou_rotated launched {launches} times in '
                             f'{warm + timed} steps (expected {expected})')
    for metrics in history:
        check_metrics(metrics)
    losses = [float(m['loss']) for m in history]
    if not losses[-1] < losses[0]:
        raise AssertionError(f'the loss did not fall on the fixed batch: '
                             f'{losses}')
    if state.step != warm + timed:
        raise AssertionError(f'state.step {state.step}')
    mem = torch.cuda.max_memory_allocated() / 2**30 if on_card \
        else float('nan')
    log(f'[training] {card} | {str(dtype).split(".")[-1]} B={bsz} {size}^2, '
        f'G={g} ({valid} valid), {timed} timed steps after {warm} warm: '
        f'{bsz * timed / seconds:.2f} imgs/s, {1e3 * seconds / timed:.2f} '
        f'ms per step; peak memory {mem:.2f} GiB; box_iou_rotated launches '
        f'{launches} in {warm + timed} steps '
        f'({launches / (warm + timed):g} per step)')
    log(f'[training] loss {losses[0]:.4f} -> {losses[-1]:.4f} (loss_cls '
        f'{float(history[0]["loss_cls"]):.4f} -> '
        f'{float(history[-1]["loss_cls"]):.4f}, loss_bbox '
        f'{float(history[0]["loss_bbox"]):.4f} -> '
        f'{float(history[-1]["loss_bbox"]):.4f}); grad_norm '
        f'{float(history[0]["grad_norm"]):.3f} -> '
        f'{float(history[-1]["grad_norm"]):.3f}')
    prof = profile_run(lambda: step(state, batch), device, 'train step',
                       'train.')
    if prof['busy_us']:
        spans = prof['spans']
        named = sum(spans.get(k, 0) for k in
                    ('train.forward', 'train.loss', 'train.update'))
        b2_us = sum(us for name, us in prof['kernels'].items()
                    if 'iou_matrix_kernel' in name)
        # backward's kernels are launched by the autograd thread, outside
        # the ranges of the calling thread: they are the remainder
        log(f'[profile] device time: forward '
            f'{spans.get("train.forward", 0) / 1e3:.2f} ms, targets + loss '
            f'{spans.get("train.loss", 0) / 1e3:.2f} ms (box_iou_rotated '
            f'{b2_us / 1e3:.3f} ms of it), optimizer '
            f'{spans.get("train.update", 0) / 1e3:.2f} ms, backward (the '
            f'rest) {(prof["busy_us"] - named) / 1e3:.2f} ms')
    return counts


def main() -> int:
    info = phase_device()
    # float32 comparisons run in full float32 (no TF32 in cuDNN or cuBLAS)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    phase_build()
    records = [phase_kernel('cuda', card=info['card'])]
    phase_slice('cuda')
    serving = phase_serving('cuda', card=info['card'])
    records.append(phase_iou_kernel('cuda', card=info['card']))
    phase_train_slice('cuda')
    training = phase_training('cuda', card=info['card'])
    for rec in records:
        # launches on the main paths: serving's requests + training's steps
        rec['launches'] = serving[rec['name']] + training[rec['name']]
        if rec['launches'] < 1:
            raise AssertionError(f'{rec["name"]} never ran on a main path')
    log(f'[done] {time.perf_counter() - t0:.1f} s on {info["card"]}')
    print(json.dumps({'kernels': records}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': info['kind'], 'count': info['count']}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
