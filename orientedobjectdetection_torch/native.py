"""Native (C++) host code, loaded with ``ctypes``: the rotated-box geometry
(counterpart of ``orientedobjectdetection_tpu/native/__init__.py``) and the
image codecs (what OpenCV's libjpeg-turbo, libtiff, libwebp and its own GIF,
PNM, PAM, PFM, Sun raster and Radiance HDR codecs do for the JAX package;
lossy WebP is not read yet).

``csrc/rnms.cpp`` (the port's own copy of the JAX package's source),
``csrc/jpeg.cpp``, ``csrc/tiff.cpp``, ``csrc/raster.cpp``, ``csrc/gif.cpp``
and ``csrc/webp.cpp`` are built with ``g++`` at first use
into one library, ``_build/native-<hash>.so`` inside the package, named by
a hash of the sources and the flags as ``utils/cuda_build.py`` names the
CUDA kernels, and loaded once a process. It links nothing but the C++
runtime (the TIFF reader carries its own inflater). The geometry serves the
host call sites, ``ops/nms.py:nms_rotated_np(device='cpu')`` above all:
``rbox_iou``, ``nms_rotated`` and ``nms_hbb``; the codecs serve
``utils/image_io.py``: ``jpeg_decode``, ``jpeg_encode``, ``tiff_decode``,
``tiff_encode``, ``raster_decode``, ``hdr_encode``, ``gif_decode``,
``gif_encode``, ``webp_decode`` and ``webp_encode``. Where the JAX
package falls back to its jnp path without a compiler, the port raises
RuntimeError: it never falls back quietly. ctypes releases the GIL during
a call, so threads decode in parallel.
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
JPEG_SOURCE = Path(__file__).resolve().parent / 'csrc' / 'jpeg.cpp'
TIFF_SOURCE = Path(__file__).resolve().parent / 'csrc' / 'tiff.cpp'
RASTER_SOURCE = Path(__file__).resolve().parent / 'csrc' / 'raster.cpp'
GIF_SOURCE = Path(__file__).resolve().parent / 'csrc' / 'gif.cpp'
WEBP_SOURCE = Path(__file__).resolve().parent / 'csrc' / 'webp.cpp'
BUILD_DIR = Path(__file__).resolve().parent / '_build'
# no fused multiply-adds: the TIFF reader's L*a*b* and SGILog conversions
# round as libtiff's do
FLAGS = ('-O3', '-shared', '-fPIC', '-std=c++17', '-ffp-contract=off')
_LOCK = threading.Lock()
_LIB = None


def sources() -> tuple:
    return (SOURCE, JPEG_SOURCE, TIFF_SOURCE, RASTER_SOURCE, GIF_SOURCE,
            WEBP_SOURCE)


def library_path() -> Path:
    digest = hashlib.sha256()
    for source in sources():
        digest.update(source.read_bytes())
    digest.update(' '.join(FLAGS).encode())
    return BUILD_DIR / f'native-{digest.hexdigest()[:16]}.so'


def _build(target: Path) -> None:
    names = ' '.join(source.name for source in sources())
    compiler = shutil.which(os.environ.get('CXX', 'g++'))
    if compiler is None:
        raise RuntimeError(f'the native host code needs a C++ compiler (g++, '
                           f'or $CXX) to build {names}')
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f'.{os.getpid()}.tmp')
    proc = subprocess.run([compiler, *FLAGS, '-o', str(tmp),
                           *(str(source) for source in sources())],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f'{compiler} failed on {names} (exit '
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
            u8p = np.ctypeslib.ndpointer(np.uint8, flags='C_CONTIGUOUS')
            buf = ctypes.c_char_p
            lib.oodt_jpeg_size.argtypes = [buf, i64, i64p, buf, i64]
            lib.oodt_jpeg_size.restype = ctypes.c_int
            lib.oodt_jpeg_decode.argtypes = [buf, i64, u8p, i64, i64, buf,
                                             i64]
            lib.oodt_jpeg_decode.restype = ctypes.c_int
            lib.oodt_jpeg_encode.argtypes = [u8p, i64, i64, i64, u8p, i64,
                                             buf, i64]
            lib.oodt_jpeg_encode.restype = i64
            lib.oodt_tiff_info.argtypes = [buf, i64, i64p, buf, i64]
            lib.oodt_tiff_info.restype = ctypes.c_int
            lib.oodt_tiff_decode.argtypes = [buf, i64, u8p, i64, i64, buf,
                                             i64]
            lib.oodt_tiff_decode.restype = ctypes.c_int
            lib.oodt_tiff_encode.argtypes = [u8p, i64, i64, i64, i64, i64,
                                             u8p, i64, buf, i64]
            lib.oodt_tiff_encode.restype = i64
            lib.oodt_raster_info.argtypes = [buf, i64, i64p, buf, i64]
            lib.oodt_raster_info.restype = ctypes.c_int
            lib.oodt_raster_decode.argtypes = [buf, i64, u8p, i64, i64, i64,
                                               buf, i64]
            lib.oodt_raster_decode.restype = ctypes.c_int
            f32p = np.ctypeslib.ndpointer(np.float32, flags='C_CONTIGUOUS')
            lib.oodt_hdr_encode.argtypes = [f32p, i64, i64, u8p, i64, buf,
                                            i64]
            lib.oodt_hdr_encode.restype = i64
            lib.oodt_gif_info.argtypes = [buf, i64, i64p, buf, i64]
            lib.oodt_gif_info.restype = ctypes.c_int
            lib.oodt_gif_decode.argtypes = [buf, i64, u8p, i64, i64, buf, i64]
            lib.oodt_gif_decode.restype = ctypes.c_int
            lib.oodt_gif_encode.argtypes = [u8p, i64, i64, i64, u8p, i64,
                                            buf, i64]
            lib.oodt_gif_encode.restype = i64
            lib.oodt_webp_info.argtypes = [buf, i64, i64p, buf, i64]
            lib.oodt_webp_info.restype = ctypes.c_int
            lib.oodt_webp_decode.argtypes = [buf, i64, u8p, i64, i64, i64p,
                                             buf, i64]
            lib.oodt_webp_decode.restype = ctypes.c_int
            lib.oodt_webp_encode.argtypes = [u8p, i64, i64, i64, u8p, i64,
                                             buf, i64]
            lib.oodt_webp_encode.restype = i64
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


_ERROR_BYTES = 256


def jpeg_decode(data: bytes) -> np.ndarray:
    """A JPEG file's bytes -> ``(H, W, 3)`` uint8 BGR, bit for bit what
    ``cv2.imdecode(data, cv2.IMREAD_COLOR)`` gives before it applies an
    EXIF orientation. Raises ValueError for a corrupt or truncated file and
    for the forms ``csrc/jpeg.cpp`` does not read (each named: those OpenCV
    does not read either, and ROADMAP A.4d's)."""
    lib = load()
    data = bytes(data)
    err = ctypes.create_string_buffer(_ERROR_BYTES)
    dims = np.zeros(3, np.int64)
    if lib.oodt_jpeg_size(data, len(data), dims, err, _ERROR_BYTES):
        raise ValueError(err.value.decode())
    out = np.empty((int(dims[0]), int(dims[1]), 3), np.uint8)
    if lib.oodt_jpeg_decode(data, len(data), out.reshape(-1), dims[0],
                            dims[1], err, _ERROR_BYTES):
        raise ValueError(err.value.decode())
    return out


def jpeg_encode(img: np.ndarray) -> bytes:
    """``(H, W, 3)`` uint8 BGR or ``(H, W)`` grey -> the bytes
    ``cv2.imencode('.jpg', img)`` gives with OpenCV's defaults (quality 95,
    4:2:0, baseline, JFIF)."""
    img = np.ascontiguousarray(img, np.uint8)
    channels = 1 if img.ndim == 2 else img.shape[2]
    return _encode('oodt_jpeg_encode', (img.reshape(-1), img.shape[0],
                                        img.shape[1], channels),
                   img.size + 4096)


def _encode(fn, args: tuple, cap: int) -> bytes:
    """``fn(*args, out, cap, err, errlen)``, called again with a buffer of
    the size it asks for until the file fits."""
    lib = load()
    err = ctypes.create_string_buffer(_ERROR_BYTES)
    while True:
        out = np.empty(cap, np.uint8)
        n = getattr(lib, fn)(*args, out, cap, err, _ERROR_BYTES)
        if n < 0:
            raise ValueError(err.value.decode())
        if n <= cap:
            return out[:n].tobytes()
        cap = n


def tiff_decode(data: bytes):
    """A TIFF file's bytes -> its first page as ``(H, W, 3)`` uint8 BGR in
    stored order, and its Orientation tag (1-8): bit for bit what
    ``cv2.imdecode(data, cv2.IMREAD_COLOR)`` gives before it applies the
    orientation. Raises ValueError for a corrupt or truncated file and for
    the forms ``csrc/tiff.cpp`` does not read (each named: those OpenCV does
    not read either, saying so)."""
    lib = load()
    data = bytes(data)
    err = ctypes.create_string_buffer(_ERROR_BYTES)
    dims = np.zeros(3, np.int64)
    if lib.oodt_tiff_info(data, len(data), dims, err, _ERROR_BYTES):
        raise ValueError(err.value.decode())
    out = np.empty((int(dims[0]), int(dims[1]), 3), np.uint8)
    if lib.oodt_tiff_decode(data, len(data), out.reshape(-1), dims[0],
                            dims[1], err, _ERROR_BYTES):
        raise ValueError(err.value.decode())
    return out, int(dims[2])


def tiff_encode(img: np.ndarray) -> bytes:
    """``(H, W)`` grey, ``(H, W, 3)`` BGR or ``(H, W, 4)`` BGRA samples of
    uint8, int8, uint16, int16, uint32, int32, float32 or float64 -> the
    bytes ``cv2.imencode('.tif', img)`` gives with OpenCV's defaults (LZW
    and Predictor 2 for integers, uncompressed floats, 8192 bytes a
    strip)."""
    img = np.asarray(img)
    if img.dtype.kind not in 'uif' or img.dtype.itemsize not in (1, 2, 4, 8):
        raise ValueError(f'tiff_encode takes integer or float samples, got '
                         f'{img.dtype}')
    raw = np.ascontiguousarray(img, img.dtype.newbyteorder('<'))
    raw = raw.view(np.uint8).reshape(-1)
    channels = 1 if img.ndim == 2 else img.shape[2]
    fmt = {'u': 1, 'i': 2, 'f': 3}[img.dtype.kind]
    return _encode('oodt_tiff_encode', (raw, img.shape[0], img.shape[1],
                                        channels, img.dtype.itemsize, fmt),
                   raw.size + raw.size // 2 + 4096)


def raster_decode(data: bytes) -> np.ndarray:
    """A PNM, PAM, PFM, Sun raster or Radiance HDR file's bytes -> what
    ``cv2.imdecode(data, cv2.IMREAD_COLOR)`` gives: ``(H, W, 3)`` uint8 BGR,
    or ``(H, W)`` uint8 for a grey PFM (``Pf``), which OpenCV returns so.
    Raises ValueError for a corrupt or truncated file and for the forms
    ``csrc/raster.cpp`` does not read (each named: those OpenCV does not
    read either, saying so)."""
    lib = load()
    data = bytes(data)
    err = ctypes.create_string_buffer(_ERROR_BYTES)
    dims = np.zeros(3, np.int64)
    if lib.oodt_raster_info(data, len(data), dims, err, _ERROR_BYTES):
        raise ValueError(err.value.decode())
    h, w, c = (int(v) for v in dims)
    out = np.empty((h, w, c), np.uint8)
    if lib.oodt_raster_decode(data, len(data), out.reshape(-1), h, w, c,
                              err, _ERROR_BYTES):
        raise ValueError(err.value.decode())
    return out if c == 3 else out[..., 0]


def hdr_encode(img: np.ndarray) -> bytes:
    """``(H, W, 3)`` float32 BGR -> the bytes ``cv2.imencode('.hdr', img)``
    gives (run-length encoded scanlines, flat below 8 or past 32767
    pixels a row)."""
    img = np.ascontiguousarray(img, np.float32)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f'hdr_encode takes (H, W, 3) float32, got '
                         f'{img.shape}')
    return _encode('oodt_hdr_encode', (img.reshape(-1), img.shape[0],
                                       img.shape[1]), img.size * 2 + 4096)


def gif_decode(data: bytes) -> np.ndarray:
    """A GIF file's bytes -> its first image on the logical screen as
    ``(H, W, 3)`` uint8 BGR, bit for bit what ``cv2.imdecode(data,
    cv2.IMREAD_COLOR)`` gives (OpenCV 5.0's own GIF codec). Raises
    ValueError for a corrupt or truncated file and for what OpenCV refuses
    (each named, "OpenCV does not read it either")."""
    lib = load()
    data = bytes(data)
    err = ctypes.create_string_buffer(_ERROR_BYTES)
    dims = np.zeros(2, np.int64)
    if lib.oodt_gif_info(data, len(data), dims, err, _ERROR_BYTES):
        raise ValueError(err.value.decode())
    out = np.empty((int(dims[0]), int(dims[1]), 3), np.uint8)
    if lib.oodt_gif_decode(data, len(data), out.reshape(-1), dims[0], dims[1],
                           err, _ERROR_BYTES):
        raise ValueError(err.value.decode())
    return out


def gif_encode(img: np.ndarray) -> bytes:
    """``(H, W, 3)`` uint8 BGR or ``(H, W, 4)`` BGRA -> the bytes
    ``cv2.imencode('.gif', img)`` gives with OpenCV's defaults (the fixed
    8 x 8 x 4 table, Floyd-Steinberg dithering, alpha 0 transparent).
    Raises ValueError, with OpenCV's reason, for what OpenCV refuses (a
    grey image)."""
    img = np.ascontiguousarray(img, np.uint8)
    channels = 1 if img.ndim == 2 else img.shape[2]
    return _encode('oodt_gif_encode', (img.reshape(-1), img.shape[0],
                                       img.shape[1], channels),
                   img.size + 4096)


WEBP_STATS = ('transforms', 'cache_bits', 'meta_bits', 'predictor_modes',
              'copies', 'cache_hits', 'plane_codes', 'palette_bits')


def webp_decode(data: bytes, stats: dict = None) -> np.ndarray:
    """A lossless WebP file's bytes -> ``(H, W, 3)`` uint8 BGR, bit for bit
    what ``cv2.imdecode(data, cv2.IMREAD_COLOR)`` gives before it applies an
    EXIF orientation: a VP8L still, or an animation's first frame on its
    canvas. Raises ValueError for a corrupt or truncated file, for a lossy
    one (naming ROADMAP A.4d) and for what OpenCV refuses. ``stats``, where
    given, gets what the bitstream used (``WEBP_STATS``: a bit a transform
    type and a bit a predictor mode, the colour cache's and the meta codes'
    bits, the counts of backward references, cache hits and plane codes,
    the colour-indexing bits + 1)."""
    lib = load()
    data = bytes(data)
    err = ctypes.create_string_buffer(_ERROR_BYTES)
    dims = np.zeros(2, np.int64)
    if lib.oodt_webp_info(data, len(data), dims, err, _ERROR_BYTES):
        raise ValueError(err.value.decode())
    out = np.empty((int(dims[0]), int(dims[1]), 3), np.uint8)
    used = np.zeros(len(WEBP_STATS), np.int64)
    if lib.oodt_webp_decode(data, len(data), out.reshape(-1), dims[0],
                            dims[1], used, err, _ERROR_BYTES):
        raise ValueError(err.value.decode())
    if stats is not None:
        stats.update(zip(WEBP_STATS, (int(v) for v in used)))
    return out


def webp_encode(img: np.ndarray) -> bytes:
    """``(H, W)`` grey, ``(H, W, 3)`` BGR or ``(H, W, 4)`` BGRA uint8 -> a
    lossless WebP (VP8L) that decodes to what ``cv2.imencode('.webp',
    img)``'s file decodes to (pixels of alpha 0 as transparent black, as
    libwebp writes them). The port's own coder: its bytes are not
    libwebp's."""
    img = np.ascontiguousarray(img, np.uint8)
    channels = 1 if img.ndim == 2 else img.shape[2]
    return _encode('oodt_webp_encode', (img.reshape(-1), img.shape[0],
                                        img.shape[1], channels),
                   img.size * 2 + 4096)
