"""Build the port's CUDA sources into shared libraries with a plain C
interface, loaded with ``ctypes``.

Each ``csrc/<name>.cu`` is compiled by one ``nvcc`` for ``sm_90a`` into
``_build/<name>-<hash of the source, the shared headers and the flags>.so``
inside the package (listed in ``.gitignore``). All sources that are not built yet are compiled by
``nvcc`` processes started together, so a cold start costs the slowest
compile, not the sum. A library whose file already exists is loaded as is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parent.parent / '_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')


@dataclass
class Library:
    name: str
    lib: ctypes.CDLL
    path: Path
    seconds: float      # compile wall time, 0.0 when loaded from _build/
    log: str            # nvcc's output (ptxas registers, smem, spills)


_LOADED: Dict[str, Library] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which('nvcc')
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / 'bin' / 'nvcc').exists():
        return str(Path(CUDA_HOME) / 'bin' / 'nvcc')
    raise RuntimeError('nvcc not found: the CUDA kernels of '
                       'orientedobjectdetection_torch need the CUDA toolkit')


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f'{name}.cu').read_bytes())
    for header in sorted(CSRC.glob('*.cuh')):
        digest.update(header.read_bytes())
    digest.update(' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / f'{name}-{digest.hexdigest()[:16]}.so'


def build(names: Sequence[str]) -> Dict[str, Library]:
    """Compile (if needed) and load ``csrc/<name>.cu`` for every name.

    Raises RuntimeError with nvcc's output when a compile fails."""
    todo = [n for n in names if n not in _LOADED]
    pending = {}
    for name in todo:
        target = _target(name)
        if target.exists():
            _LOADED[name] = Library(name, ctypes.CDLL(str(target)), target,
                                    0.0, 'loaded from ' + target.name)
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f'.{os.getpid()}.tmp')
        cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        pending[name] = (proc, tmp, target, time.perf_counter())
    for name, (proc, tmp, target, t0) in pending.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed on {name}.cu '
                               f'(exit {proc.returncode}):\n{log}')
        os.replace(tmp, target)
        _LOADED[name] = Library(name, ctypes.CDLL(str(target)), target,
                                seconds, log)
    return {n: _LOADED[n] for n in names}
