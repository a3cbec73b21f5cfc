"""Native (C++) host geometry, loaded with ``ctypes`` (counterpart of
``orientedobjectdetection_tpu/native/__init__.py``).

``csrc/rnms.cpp`` (the port's own copy of the JAX package's source) is
built with ``g++`` at first use into ``_build/rnms-<hash>.so`` inside the
package, named by a hash of the source and the flags as
``utils/cuda_build.py`` names the CUDA kernels, and loaded once a process.
It serves the host call sites, ``ops/nms.py:nms_rotated_np(device='cpu')``
above all: ``rbox_iou``, ``nms_rotated`` and ``nms_hbb``. Where the JAX
package falls back to its jnp path without a compiler, the port raises
RuntimeError: it never falls back quietly.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / 'csrc' / 'rnms.cpp'
BUILD_DIR = Path(__file__).resolve().parent / '_build'
FLAGS = ('-O3', '-shared', '-fPIC', '-std=c++17')
_LOCK = threading.Lock()
_LIB = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(' '.join(FLAGS).encode())
    return BUILD_DIR / f'rnms-{digest.hexdigest()[:16]}.so'


def _build(target: Path) -> None:
    compiler = shutil.which(os.environ.get('CXX', 'g++'))
    if compiler is None:
        raise RuntimeError('the native host NMS needs a C++ compiler (g++, '
                           'or $CXX) to build csrc/rnms.cpp')
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f'.{os.getpid()}.tmp')
    proc = subprocess.run([compiler, *FLAGS, '-o', str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f'{compiler} failed on rnms.cpp (exit '
                           f'{proc.returncode}):\n{proc.stderr}')
    os.replace(tmp, target)        # atomic when processes build at once


def load() -> ctypes.CDLL:
    """The library, built first when ``_build/`` does not hold it."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            target = library_path()
            if not target.exists():
                _build(target)
            lib = ctypes.CDLL(str(target))
            i64 = ctypes.c_int64
            f32p = np.ctypeslib.ndpointer(np.float32, flags='C_CONTIGUOUS')
            i64p = np.ctypeslib.ndpointer(np.int64, flags='C_CONTIGUOUS')
            lib.oodt_rbox_iou.argtypes = [f32p, i64, f32p, i64, ctypes.c_int,
                                          f32p]
            lib.oodt_rbox_iou.restype = None
            lib.oodt_rnms_rotated.argtypes = [f32p, f32p, i64,
                                              ctypes.c_float, i64p]
            lib.oodt_rnms_rotated.restype = i64
            lib.oodt_nms_hbb.argtypes = [f32p, f32p, i64, ctypes.c_float,
                                         i64p]
            lib.oodt_nms_hbb.restype = i64
            _LIB = lib
    return _LIB


def rbox_iou(boxes1, boxes2, mode: str = 'iou') -> np.ndarray:
    """Pairwise rotated IoU (or IoF) on the host: ``(N, 5) x (M, 5) ->
    (N, M)`` float32."""
    lib = load()
    b1 = np.ascontiguousarray(boxes1, np.float32).reshape(-1, 5)
    b2 = np.ascontiguousarray(boxes2, np.float32).reshape(-1, 5)
    out = np.empty((b1.shape[0], b2.shape[0]), np.float32)
    lib.oodt_rbox_iou(b1, b1.shape[0], b2, b2.shape[0],
                      int(mode == 'iof'), out.reshape(-1))
    return out


def nms_rotated(boxes, scores, iou_thr: float) -> np.ndarray:
    """Greedy rotated NMS on the host: the survivors' indices (int64) in
    descending score order, the lowest index first on a tie."""
    lib = load()
    b = np.ascontiguousarray(boxes, np.float32).reshape(-1, 5)
    s = np.ascontiguousarray(scores, np.float32).reshape(-1)
    keep = np.empty((b.shape[0],), np.int64)
    k = lib.oodt_rnms_rotated(b, s, b.shape[0], float(iou_thr), keep)
    return keep[:k]


def nms_hbb(boxes, scores, iou_thr: float) -> np.ndarray:
    """Greedy axis-aligned NMS on the host over ``(x1, y1, x2, y2)``
    boxes."""
    lib = load()
    b = np.ascontiguousarray(boxes, np.float32).reshape(-1, 4)
    s = np.ascontiguousarray(scores, np.float32).reshape(-1)
    keep = np.empty((b.shape[0],), np.int64)
    k = lib.oodt_nms_hbb(b, s, b.shape[0], float(iou_thr), keep)
    return keep[:k]
