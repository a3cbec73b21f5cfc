#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (H100).

Drives the port's serving path, Rotated RetinaNet R50-FPN le90 at full
width (configs/rotated_retinanet/rotated_retinanet_obb_r50_fpn_1x_dota_le90.py)
with seeded random weights, through ``init_detector`` / ``DetectorBundle``,
and holds every CUDA kernel of that path against its plain PyTorch version:

1. device   require a CUDA device; print its name and power limit
2. build    compile the kernels from csrc/ with nvcc (ptxas report)
3. kernel   nms_pair_mask vs its plain version on DOTA-like inputs
            (B=8 x N=2000, N=300, duplicates and padding); time both
4. slice    float32, 2 images of 1024^2: detections with the kernel equal
            those with the plain pair mask
5. serving  bfloat16, batch 8 of 1024^2 uint8 images: throughput, the split
            between forward and decode+NMS, peak memory, kernel launches

Every phase raises on failure. The last two lines of standard output are
one JSON object with the kernels' numbers and one with the device:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
Run from the repository root: ``python3 chip_smoke.py``.
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
KERNELS = {
    'nms_pair_mask': dict(
        route='cuda', source='orientedobjectdetection_torch/csrc/'
        'nms_pair_mask.cu',
        replaces='orientedobjectdetection_tpu/ops/iou_pallas.py:399'),
}


def log(msg: str):
    print(msg, flush=True)


def sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


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
    pair-mask launch count of this run."""
    from orientedobjectdetection_torch.ops.iou_kernels import nms_pair_mask
    bundle = build_bundle(device, dtype, max_candidates)
    images = raw_images(bsz, size, 20)
    if torch.device(device).type == 'cuda':
        images = images.pin_memory()
        torch.cuda.reset_peak_memory_stats()
    nms_pair_mask.launches = 0
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
    launches = nms_pair_mask.launches
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
    return {'nms_pair_mask': launches}


def profile_request(bundle, images, device, top=12):
    """One more request under torch.profiler: device busy share of the
    request's wall time and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile, record_function
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        with record_function('request.forward'):
            outputs = bundle.forward(images)
        with record_function('request.decode_nms'):
            bundle.decode(outputs)
        sync(device)
        wall_us = (time.perf_counter() - t0) * 1e6
    averages = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    # the record_function ranges also appear as device-side spans: not
    # kernels
    kernels = [e for e in averages if e.device_type == cuda
               and not e.key.startswith('request.')]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us == 0:
        log(f'[profile] request {wall_us / 1e3:.2f} ms; device time not '
            f'measured by the profiler')
        return
    log(f'[profile] request {wall_us / 1e3:.2f} ms wall (profiler on), '
        f'device busy {busy_us / 1e3:.2f} ms ({100 * busy_us / wall_us:.1f}'
        f'%), {sum(e.count for e in kernels)} kernel launches')
    for e in averages:
        if e.key.startswith('request.') and e.device_type != cuda:
            log(f'[profile]   {e.key}: host {e.cpu_time_total / 1e3:.2f} ms,'
                f' device {e.device_time_total / 1e3:.2f} ms in its '
                f'kernels')
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f'[profile]   {e.self_device_time_total / 1e3:8.3f} ms '
            f'{e.count:5d}x  {e.key[:90]}')


def main() -> int:
    info = phase_device()
    # float32 comparisons run in full float32 (no TF32 in cuDNN or cuBLAS)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    phase_build()
    records = [phase_kernel('cuda', card=info['card'])]
    phase_slice('cuda')
    launches = phase_serving('cuda', card=info['card'])
    for rec in records:
        rec['launches'] = launches[rec['name']]
        if rec['launches'] < 1:
            raise AssertionError(f'{rec["name"]} never ran on the main path')
    log(f'[done] {time.perf_counter() - t0:.1f} s on {info["card"]}')
    print(json.dumps({'kernels': records}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': info['kind'], 'count': info['count']}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
