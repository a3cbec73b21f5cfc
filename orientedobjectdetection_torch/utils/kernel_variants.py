"""Time edited copies of the port's CUDA kernels against each other on one
card, on the inputs the main paths give them.

Each variant is a list of ``(text, replacement)`` edits to
``csrc/<kernel>.cu``. Every copy is compiled by ``nvcc`` with the flags of
:mod:`.cuda_build`, loaded with ``ctypes`` and launched through the same C
interface as the shipped source, held against the shipped kernel (pair
mask: equal outside the ±2e-3 band around the threshold, where the
variant keeps the result; RoIAlign and IoU matrix: bit-equal) and timed in
turns (A B C ... C B A, three times) with CUDA events. ``shipped`` is the
source as it is. ``--parent DIR`` adds the IoU-matrix source of another
checkout (the commit before its redesign) and edits of it
(``PARENT_IOU_MATRIX``), held and timed the same way.

The inputs come from ``chip_smoke.py``'s phases: the NMS candidates of one
RetinaNet and one Oriented R-CNN request at batch 8 x 1024², the synthetic
B=8 x N=2000 candidates of 15 classes, and the levels and proposals of the
Oriented R-CNN request; for the IoU matrix, every case of phase 6 (B=8,
G=32 and G=512 padded gt sets against the 196,416 anchors of a 1024²
image, both ways round, dense, duplicated and unbatched sets) and the
assigner's inputs of phase 8's train steps, of which the G=32 and G=512
assignments and the train step's are timed. So run it from the repository
root, on a card::

    python -m orientedobjectdetection_torch.utils.kernel_variants \
        [--kernels box_iou_rotated ...] [--parent DIR]
"""

from __future__ import annotations

import argparse
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
# The IoU matrix: every variant but the "no clip" ones must equal the shipped
# kernel bit for bit.
IOU_MATRIX = {
    'shipped': [],
    # the clip math skipped: what the stores, staging and reject cost
    'no clip': [('float inter = kRowsFirst\n'
                 '        ? intersection_area(rcx, rcy, rx, ry, qcx, qcy, '
                 'px, py)\n'
                 '        : intersection_area(qcx, qcy, px, py, rcx, rcy, '
                 'rx, ry);', 'float inter = 0.0f;')],
    # every pair of a column of the set clipped
    'no reach test': [('if (fabsf(key.x - qx) <= reach && fabsf(key.y - qy) '
                       '<= reach) {', 'if (column(tid) < n) {'),
                      ('near_rows = mine;', '')],
    # zero-area boxes clipped where their centres are in reach
    'no area reject': [('return w * h > 0.0f ? 0.5f * (w + h) : '
                        '-__int_as_float(0x7f800000);',
                        'return 0.5f * (w + h);')],
    # every row tested against every column
    'no row cull': [('near_rows = mine;', '')],
    # a tile's columns in one run, as in the first design
    'contiguous tiles': [('kChunk = 32;', 'kChunk = 256;')],
    'chunks of 16 columns': [('kChunk = 32;', 'kChunk = 16;')],
    'chunks of 64 columns': [('kChunk = 32;', 'kChunk = 64;')],
    'scalar stores': [('const bool vec_stores = ', 'const bool vec_stores = '
                       'false && ')],
    'write-back stores': [('__stcs(reinterpret_cast<float4*>(dst),',
                           '__stwb(reinterpret_cast<float4*>(dst),')],
    'scalar loads': [('const bool vec_loads = ', 'const bool vec_loads = '
                      'false && ')],
    # at most 64 registers a thread instead of 51
    'four blocks per SM': [('kBlocksPerSM = 5;', 'kBlocksPerSM = 4;')],
}
# The same measurements on the source before its redesign, from a checkout
# of that commit (``--parent DIR``); 'parent' itself must equal the shipped
# kernel bit for bit.
PARENT_IOU_MATRIX = {
    'parent': [],
    # the clip math skipped: the store and reach-test floor of that layout
    'parent, no clip': [
        ('? intersection_area(rcx, rcy, rx, ry, qcx, qcy, qx, qy)\n'
         '          : intersection_area(qcx, qcy, qx, qy, rcx, rcy, rx, ry);',
         '? 0.0f : 0.0f;')],
    # every pair clipped
    'parent, no reach test': [
        ('if (fabsf(rx - qx) <= reach && fabsf(ry - qy) <= reach) {',
         'if (reach == reach) {')],
    # a box whose area is not positive reaches nothing, as in the pair mask
    'parent, area in the reach test': [
        ('s.reach[tid] = 0.5f * (bx[2] + bx[3]);',
         's.reach[tid] = bx[2] * bx[3] > 0.0f ? 0.5f * (bx[2] + bx[3]) '
         ': -__int_as_float(0x7f800000);'),
        ('const float q_reach = 0.5f * (qw + qh);',
         'const float q_reach = qw * qh > 0.0f ? 0.5f * (qw + qh) '
         ': -__int_as_float(0x7f800000);')],
}
# variants whose result is not compared
EXACT = {'no clip', 'parent, no clip'}


def edited_sources(name: str, variants: dict,
                   csrc: Path = cuda_build.CSRC) -> dict:
    """Variant name -> the edited text of ``<csrc>/<name>.cu``; raises when
    an edit no longer matches the source."""
    text = (csrc / f'{name}.cu').read_text()
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


def build(name: str, variants: dict, workdir: Path,
          csrc: Path = cuda_build.CSRC) -> dict:
    """Compile every variant of ``<csrc>/<name>.cu`` at once; returns
    variant -> the loaded C function."""
    procs = {}
    libdir = Path(tempfile.mkdtemp(dir=workdir))
    for i, (variant, src) in enumerate(
            edited_sources(name, variants, csrc).items()):
        path = csrc / f'_variant_{os.getpid()}_{i}.cu'
        path.write_text(src)    # beside the source, for its headers
        lib = libdir / f'{name}_{i}.so'
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
        usage = [line.split('Used ')[1] if 'Used ' in line
                 else line.strip() for line in log.splitlines()
                 if 'Used ' in line or 'spill' in line]
        print(f'[variants] {name} {variant!r}: {"; ".join(usage)}')
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
                 ctypes.c_int(2), ctypes.c_void_p(stream)]
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


def iou_matrix_inputs(size: int = 1024) -> dict:
    """Label -> (boxes1, boxes2, mode) on the card: every case of
    ``chip_smoke.py``'s phase 6, and the assigner's inputs in phase 8's
    train steps (its batch's gts, clamped to sides of at least 1e-3 as
    ``rbbox_overlaps`` clamps them: padded rows are 1e-3 boxes at the
    origin there, not zero boxes)."""
    import chip_smoke
    from ..ops.iou import _clamp_wh
    anchors = chip_smoke.config_anchors(size, 'cuda')
    cases = chip_smoke.iou_matrix_cases(anchors, 'cuda')
    gts = chip_smoke.train_batch(8, size, 32, 8, 50, 'cpu')['gt_bboxes']
    cases['train step'] = (_clamp_wh(gts).cuda(), anchors, 'iou')
    return cases


def iou_matrix_variants(inputs: dict, timed: dict, workdir: Path,
                        parent=None):
    """Every variant on every input, held against the shipped kernel; the
    inputs in ``timed`` (label -> launches per turn) timed in turns."""
    from ..ops.iou_kernels import (MATRIX_ARGS, box_iou_rotated_matrix,
                                   matrix_layout)
    fns = build('box_iou_rotated', IOU_MATRIX, workdir)
    if parent is not None:
        fns.update(build('box_iou_rotated', PARENT_IOU_MATRIX, workdir,
                         Path(parent) / 'orientedobjectdetection_torch' /
                         'csrc'))
    for fn in fns.values():
        fn.argtypes = MATRIX_ARGS
        fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    differ = []
    for label, (boxes1, boxes2, mode) in inputs.items():
        rows, cols, flags = matrix_layout(boxes1, boxes2, mode)
        ref = box_iou_rotated_matrix(boxes1, boxes2, mode)
        ref = ref.transpose(-1, -2) if not flags[-1] else ref
        ref = ref.reshape(flags[:3])
        runs = {}
        for variant, fn in fns.items():
            out = torch.empty(flags[:3], dtype=torch.float32,
                              device=rows.device)

            def run(fn=fn, out=out):
                err = fn(rows.data_ptr(), cols.data_ptr(), out.data_ptr(),
                         *flags, stream)
                if err:
                    raise RuntimeError(f'CUDA error {err}')

            run()
            torch.cuda.synchronize()
            if variant in EXACT:
                pass
            elif torch.equal(out, ref):
                print(f'[variants] box_iou_rotated {label} {variant!r}: '
                      f'bit-equal to the shipped kernel')
            else:
                print(f'[variants] box_iou_rotated {label} {variant!r}: '
                      f'{int((out != ref).sum())} elements differ from the '
                      f'shipped kernel, max '
                      f'{float((out - ref).abs().max()):.3g}')
                differ.append((label, variant))
            runs[variant] = run
        if label in timed:
            # the write floor: PyTorch's fill of a buffer of the same size
            runs['zero_ of an output-sized buffer'] = torch.empty(
                flags[:3], dtype=torch.float32, device=rows.device).zero_
            report(f'box_iou_rotated {label}',
                   time_in_turns(runs, timed[label]))
        del runs, ref
        torch.cuda.empty_cache()
    if differ:
        raise AssertionError(f'variants differ from the shipped kernel: '
                             f'{differ}')


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--kernels', nargs='+', default=[
        'nms_pair_mask', 'roi_align_rotated', 'box_iou_rotated'])
    parser.add_argument('--parent', help='a checkout of an earlier commit: '
                        'its box_iou_rotated.cu joins the IoU-matrix '
                        'variants')
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError('kernel_variants needs a CUDA device')
    sys.path.insert(0, os.getcwd())
    import chip_smoke
    print(f'[variants] {torch.cuda.get_device_name(0)}')
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip())
    with tempfile.TemporaryDirectory() as workdir:
        if 'box_iou_rotated' in args.kernels:
            iou_matrix_variants(iou_matrix_inputs(), {
                'assignment': 50, 'padded-512': 10, 'train step': 50},
                Path(workdir), args.parent)
        if 'nms_pair_mask' in args.kernels or \
                'roi_align_rotated' in args.kernels:
            _, retina = chip_smoke.phase_serving('cuda', warm=0, timed=1)
            _, orcnn = chip_smoke.phase_orcnn_serving('cuda', warm=0,
                                                      timed=1, split=0)
        if 'nms_pair_mask' in args.kernels:
            boxes, cls = chip_smoke.dota_candidates(8, 2000, 0)
            synthetic = (torch.from_numpy(boxes).cuda(),
                         torch.from_numpy(cls).cuda())
            pair_mask_variants({'synthetic 15 classes': synthetic,
                                'RetinaNet request': retina['retinanet'],
                                'Oriented R-CNN request': orcnn['orcnn']},
                               Path(workdir))
        if 'roi_align_rotated' in args.kernels:
            rois = torch.from_numpy(
                chip_smoke.seeded_rois(8, 2000, 1024, 70)).cuda()
            f32 = chip_smoke.seeded_pyramid(8, 1024, 256, torch.float32,
                                            'cuda', 71)
            roi_align_variants({'synthetic bf16': (
                [f.bfloat16() for f in f32], rois),
                'synthetic float32': (f32, rois),
                'Oriented R-CNN request': orcnn['orcnn_roi']},
                Path(workdir))
    return 0


if __name__ == '__main__':
    sys.exit(main())
