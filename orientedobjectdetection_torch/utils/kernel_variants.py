"""Time edited copies of the port's CUDA kernels against each other on one
card, on the inputs the main paths give them.

Each variant is a list of ``(text, replacement)`` edits to
``csrc/<kernel>.cu``. Every copy is compiled by ``nvcc`` with the flags of
:mod:`.cuda_build`, loaded with ``ctypes`` and launched through the same C
interface as the shipped source, held against the shipped kernel (pair
mask: equal outside the ±2e-3 band around the threshold, where the
variant keeps the result; RoIAlign: bit-equal) and timed in turns
(A B C ... C B A, three times) with CUDA events. ``shipped`` is the source
as it is.

The inputs come from ``chip_smoke.py``'s phases: the NMS candidates of one
RetinaNet and one Oriented R-CNN request at batch 8 x 1024², the synthetic
B=8 x N=2000 candidates of 15 classes, and the levels and proposals of the
Oriented R-CNN request. So run it from the repository root, on a card::

    python -m orientedobjectdetection_torch.utils.kernel_variants
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from . import cuda_build

PAIR_MASK = {
    'shipped': [],
    'one tile per block': [('kChunk = 2;', 'kChunk = 1;')],
    'four tiles per block': [('kChunk = 2;', 'kChunk = 4;')],
    'whole band per block': [('kChunk = 2;', 'kChunk = 1 << 20;')],
    # the clip math skipped (the mask is then not the kernel's): what the
    # rest of the kernel costs
    'no clip': [('fminf(intersection_area(rcx, rcy, rows.x[pr], rows.y[pr], '
                 'qcx,\n                                      qcy, cols.x[pc]'
                 ', cols.y[pc]),\n                    fminf(p_area, q_area));',
                 'fminf(p_area, q_area);')],
    # every same-class pair clipped
    'no reject': [('if (__float_as_int(key.w) == rcls &&\n                '
                   'fabsf(key.x - rx) <= reach && fabsf(key.y - ry) <= '
                   'reach) {', 'if (__float_as_int(key.w) == rcls) {')],
}
ROI_ALIGN = {
    'shipped': [],
    '8 RoIs per block': [('kMaxTeams = 4;', 'kMaxTeams = 8;')],
    '16 RoIs per block': [('kMaxTeams = 4;', 'kMaxTeams = 16;')],
    'one block per SM at most 255 registers':
        [('__launch_bounds__(kThreads, 2)', '__launch_bounds__(kThreads)')],
}
EXACT = {'no clip'}       # variants whose result is not compared


def edited_sources(name: str, variants: dict) -> dict:
    """Variant name -> the edited text of ``csrc/<name>.cu``; raises when
    an edit no longer matches the source."""
    text = (cuda_build.CSRC / f'{name}.cu').read_text()
    out = {}
    for variant, edits in variants.items():
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                raise ValueError(f'{name}.cu, {variant!r}: {old!r} does not '
                                 f'occur exactly once')
            src = src.replace(old, new)
        out[variant] = src
    return out


def build(name: str, variants: dict, workdir: Path) -> dict:
    """Compile every variant of ``csrc/<name>.cu`` at once; returns variant
    -> the loaded C function."""
    procs = {}
    for i, (variant, src) in enumerate(edited_sources(name, variants).items()):
        path = cuda_build.CSRC / f'_variant_{os.getpid()}_{i}.cu'
        path.write_text(src)    # beside the source, for its headers
        lib = workdir / f'{name}_{i}.so'
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, '-o', str(lib),
               str(path)]
        procs[variant] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True), path, lib)
    fns = {}
    for variant, (proc, path, lib) in procs.items():
        log, _ = proc.communicate()
        path.unlink()
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed on {variant!r}:\n{log}')
        regs = [line.split('Used ')[1].split(',')[0] for line in
                log.splitlines() if 'Used ' in line]
        print(f'[variants] {name} {variant!r}: {", ".join(regs)}')
        fns[variant] = getattr(ctypes.CDLL(str(lib)), name)
    return fns


def time_in_turns(runs: dict, reps: int, rounds: int = 3) -> dict:
    """Variant -> the list of its mean ms over ``reps`` launches, measured
    in turns A B ... B A, ``rounds`` times."""
    times = {v: [] for v in runs}
    order = list(runs) + list(runs)[::-1]
    for _ in range(rounds):
        for v in order:
            for _ in range(3):
                runs[v]()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                runs[v]()
            end.record()
            torch.cuda.synchronize()
            times[v].append(start.elapsed_time(end) / reps)
    return times


def report(label: str, times: dict):
    for v, t in times.items():
        print(f'[variants] {label} {v!r}: {min(t):.4f}-{max(t):.4f} ms')


def pair_mask_variants(inputs: dict, workdir: Path, thr: float = 0.1,
                       band: float = 2e-3):
    from ..ops.iou_kernels import nms_pair_mask, pair_iou
    fns = build('nms_pair_mask', PAIR_MASK, workdir)
    stream = torch.cuda.current_stream().cuda_stream
    for label, (boxes, cls) in inputs.items():
        ref = nms_pair_mask(boxes, thr, cls)
        outside = (pair_iou(boxes) - thr).abs() >= band
        runs = {}
        for variant, fn in fns.items():
            out = torch.empty_like(ref)

            def run(fn=fn, out=out):
                err = fn(ctypes.c_void_p(boxes.data_ptr()),
                         ctypes.c_void_p(cls.data_ptr()),
                         ctypes.c_void_p(out.data_ptr()),
                         ctypes.c_int(boxes.shape[0]),
                         ctypes.c_int(boxes.shape[1]), ctypes.c_float(thr),
                         ctypes.c_void_p(stream))
                if err:
                    raise RuntimeError(f'CUDA error {err}')

            run()
            torch.cuda.synchronize()
            if variant not in EXACT and \
                    not torch.equal(out[outside], ref[outside]):
                raise AssertionError(f'{variant!r} differs on {label}')
            runs[variant] = run
        report(f'nms_pair_mask {label}', time_in_turns(runs, 50))


def roi_align_variants(inputs: dict, workdir: Path,
                       scales=(1 / 4, 1 / 8, 1 / 16, 1 / 32)):
    from ..ops.roi_align_kernels import roi_align_rotated_pyramid, vector_path
    from ..ops.roi_align_rotated import level_of_rois
    fns = build('roi_align_rotated', ROI_ALIGN, workdir)
    stream = torch.cuda.current_stream().cuda_stream
    for label, (feats, rois) in inputs.items():
        ref = roi_align_rotated_pyramid(feats, rois, (7, 7), scales)
        n, (b, r), c = len(feats), rois.shape[:2], feats[0].shape[-1]
        levels = level_of_rois(rois, n, 56.0).to(torch.int32).contiguous()
        args = [(ctypes.c_void_p * n)(*[f.data_ptr() for f in feats]),
                (ctypes.c_int * n)(*[f.shape[1] for f in feats]),
                (ctypes.c_int * n)(*[f.shape[2] for f in feats]),
                (ctypes.c_float * n)(*scales), ctypes.c_int(n),
                ctypes.c_void_p(rois.data_ptr()),
                ctypes.c_void_p(levels.data_ptr())]
        flags = [ctypes.c_int(b), ctypes.c_int(r), ctypes.c_int(c),
                 ctypes.c_int(int(feats[0].dtype == torch.bfloat16)),
                 ctypes.c_int(int(vector_path(feats))), ctypes.c_int(0),
                 ctypes.c_void_p(stream)]
        runs = {}
        for variant, fn in fns.items():
            out = torch.empty_like(ref)

            def run(fn=fn, out=out):
                err = fn(*args, ctypes.c_void_p(out.data_ptr()), *flags)
                if err:
                    raise RuntimeError(f'CUDA error {err}')

            run()
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                raise AssertionError(f'{variant!r} differs on {label}')
            runs[variant] = run
        report(f'roi_align_rotated {label}', time_in_turns(runs, 20))
        # the same kernel with the RoIs in spatial order: level, then the
        # row and column of their centre's cell
        lvl = level_of_rois(rois, n, 56.0)
        stride = torch.tensor([1 / s for s in scales],
                              device=rois.device)[lvl]
        key = lvl * 2 ** 21 + (rois[..., 1] / stride).floor().clamp(
            0, 1023).long() * 1024 + (rois[..., 0] / stride).floor().clamp(
            0, 1023).long()
        order = torch.argsort(key, dim=1)
        ordered = rois.gather(1, order[..., None].expand(-1, -1, 5))
        report(f'roi_align_rotated {label}, RoIs as given and in spatial '
               f'order', time_in_turns({
                   'as given': lambda: roi_align_rotated_pyramid(
                       feats, rois, (7, 7), scales),
                   'spatial order': lambda: roi_align_rotated_pyramid(
                       feats, ordered.contiguous(), (7, 7), scales)}, 20))


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError('kernel_variants needs a CUDA device')
    sys.path.insert(0, os.getcwd())
    import chip_smoke
    _, retina = chip_smoke.phase_serving('cuda', warm=0, timed=1)
    _, orcnn = chip_smoke.phase_orcnn_serving('cuda', warm=0, timed=1,
                                              split=0)
    boxes, cls = chip_smoke.dota_candidates(8, 2000, 0)
    synthetic = (torch.from_numpy(boxes).cuda(), torch.from_numpy(cls).cuda())
    rois = torch.from_numpy(chip_smoke.seeded_rois(8, 2000, 1024, 70)).cuda()
    f32 = chip_smoke.seeded_pyramid(8, 1024, 256, torch.float32, 'cuda', 71)
    print(f'[variants] {torch.cuda.get_device_name(0)}')
    with tempfile.TemporaryDirectory() as workdir:
        pair_mask_variants({'synthetic 15 classes': synthetic,
                            'RetinaNet request': retina['retinanet'],
                            'Oriented R-CNN request': orcnn['orcnn']},
                           Path(workdir))
        roi_align_variants({'synthetic bf16': ([f.bfloat16() for f in f32],
                                               rois),
                            'synthetic float32': (f32, rois),
                            'Oriented R-CNN request': orcnn['orcnn_roi']},
                           Path(workdir))
    return 0


if __name__ == '__main__':
    sys.exit(main())
