"""A test-only builder of the PNM, PAM, PFM, Sun raster and Radiance HDR
files the tests hold the port's reader to OpenCV on, for the forms
``cv2.imencode`` does not write: ASCII PNM (``P1``-``P3``) and binary PNM of
any maxval, with comments and other whitespace in the header; PAM of any
DEPTH, MAXVAL and TUPLTYPE; PFM of either byte order and any scale; Sun
raster of each type and depth, with or without a colour map, its RLE
(:func:`sun_rle`) included; Radiance HDR flat, new-style RLE and old-style
RLE scanlines under any header.

It writes what it is told and nothing more: the tests decode the same
bytes with ``cv2.imdecode`` and with the port and want equal arrays, or
both to refuse.
"""

from __future__ import annotations

import struct

import numpy as np

SUN_MAGIC = 0x59A66A95
RT_OLD, RT_STANDARD, RT_BYTE_ENCODED, RT_FORMAT_RGB = 0, 1, 2, 3
RMT_NONE, RMT_EQUAL_RGB = 0, 1


def pnm(kind: int, samples: np.ndarray, maxval: int = 255,
        header: bytes = None, sep: bytes = b' ') -> bytes:
    """``P<kind>`` of ``samples`` ((H, W) or (H, W, 3) integers, RGB order
    as the file stores it): ASCII (kinds 1-3, ``sep`` between samples; a
    P1 sample is 1 for black) or binary (4-6: P4 bits packed MSB first,
    1 black; big-endian words past maxval 255). ``header`` replaces the
    text between the kind and the samples (comments, other whitespace)."""
    h, w = samples.shape[:2]
    if header is None:
        header = (b'\n%d %d\n' % (w, h) if kind in (1, 4) else
                  b'\n%d %d\n%d\n' % (w, h, maxval))
    head = b'P%d' % kind + header
    flat = np.asarray(samples).reshape(h, -1)
    if kind <= 3:
        return head + b'\n'.join(sep.join(b'%d' % v for v in row)
                                 for row in flat) + b'\n'
    if kind == 4:
        return head + np.packbits(flat.astype(bool), axis=1).tobytes()
    dtype = '>u2' if maxval > 255 else np.uint8
    return head + flat.astype(dtype).tobytes()


def pam(samples: np.ndarray, depth: int, maxval: int, tupltype=None,
        lines=None) -> bytes:
    """``P7`` of ``samples`` (H, W, depth) as stored, big-endian past
    MAXVAL 255 (MAXVAL 1: each row's bytes packed bits, as OpenCV's reader
    takes them); ``lines`` replaces the header lines between ``P7`` and
    ``ENDHDR``."""
    h, w = samples.shape[:2]
    if lines is None:
        lines = [b'WIDTH %d' % w, b'HEIGHT %d' % h, b'DEPTH %d' % depth,
                 b'MAXVAL %d' % maxval]
        if tupltype:
            lines.append(b'TUPLTYPE ' + tupltype)
    head = b'P7\n' + b''.join(line + b'\n' for line in lines) + b'ENDHDR\n'
    flat = np.asarray(samples).reshape(h, -1)
    if maxval == 1:
        body = np.packbits(flat.astype(bool), axis=1)
        body = np.pad(body, ((0, 0), (0, flat.shape[1] - body.shape[1])))
        return head + body.tobytes()
    return head + flat.astype('>u2' if maxval > 255 else np.uint8).tobytes()


def pfm(samples: np.ndarray, scale: float = -1.0) -> bytes:
    """``PF`` (H, W, 3, RGB order) or ``Pf`` (H, W) float32, rows
    bottom-up, little-endian for a negative ``scale``."""
    h, w = samples.shape[:2]
    kind = b'PF' if samples.ndim == 3 else b'Pf'
    order = '<f4' if scale < 0 else '>f4'
    return (kind + b'\n%d %d\n' % (w, h) + repr(float(scale)).encode() +
            b'\n' + np.ascontiguousarray(samples[::-1], order).tobytes())


def sun(data: bytes, w: int, h: int, depth: int, kind=RT_STANDARD,
        maptype=RMT_NONE, colormap: bytes = b'', length=None) -> bytes:
    """A Sun raster: its 32-byte header, the colour map (R, G then B
    planes) and ``data`` as given; ``length`` the header's data length
    (``len(data)`` by default)."""
    return struct.pack('>8I', SUN_MAGIC, w, h, depth,
                       len(data) if length is None else length, kind,
                       maptype, len(colormap)) + colormap + data


def sun_rows(pixels: np.ndarray, depth: int) -> bytes:
    """Sun raster rows of ``pixels`` ((H, W) indexes or bits, (H, W, 3)
    BGR, (H, W, 4) XBGR as stored), each padded to 16 bits."""
    h = pixels.shape[0]
    flat = np.asarray(pixels, np.uint8).reshape(h, -1)
    if depth == 1:
        flat = np.packbits(flat.astype(bool), axis=1)
    if flat.shape[1] % 2:
        flat = np.pad(flat, ((0, 0), (0, 1)))
    return flat.tobytes()


def sun_rle(data: bytes) -> bytes:
    """RT_BYTE_ENCODED: runs of 3 or more as ``0x80, count - 1, value``,
    a literal 0x80 as ``0x80, 0``, other bytes as they are."""
    out, i = bytearray(), 0
    while i < len(data):
        j = i
        while j < len(data) and data[j] == data[i] and j - i < 256:
            j += 1
        n = j - i
        if n >= 3 or data[i] == 0x80:
            out += (bytes([0x80, n - 1, data[i]]) if n > 1 or data[i] != 0x80
                    else b'\x80\x00')
            i = j if n > 1 or data[i] != 0x80 else i + 1
        else:
            out.append(data[i])
            i += 1
    return bytes(out)


def rgbe(floats: np.ndarray) -> np.ndarray:
    """(H, W, 3) RGB floats -> (H, W, 4) RGBE bytes (frexp, mantissas
    times 256 / max, truncated)."""
    v = floats.max(-1)
    mant, exp = np.frexp(v)
    out = np.zeros(floats.shape[:2] + (4,), np.uint8)
    live = v >= 1e-32
    scale = np.where(live, mant * 256.0 / np.where(live, v, 1), 0)
    out[..., :3] = (floats * scale[..., None]).astype(np.int64).clip(0, 255)
    out[..., 3] = np.where(live, exp + 128, 0)
    return out


def hdr(pixels: np.ndarray, mode: str = 'rle', header: bytes = None,
        size: bytes = None) -> bytes:
    """A Radiance HDR of ``pixels`` ((H, W, 4) RGBE bytes): ``mode``
    'flat' (4 bytes a pixel), 'rle' (new-style scanlines: ``2, 2, w``,
    each of the four planes in runs and literals) or 'old' (old-style
    RLE: ``1, 1, 1, n`` repeats the pixel before ``n`` times).
    ``header`` replaces the lines before the size line; ``size`` the size
    line."""
    h, w = pixels.shape[:2]
    if header is None:
        header = b'#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n'
    if size is None:
        size = b'-Y %d +X %d\n' % (h, w)
    out = bytearray(header + size)
    for row in pixels:
        if mode == 'flat':
            out += row.tobytes()
        elif mode == 'old':
            x = 0
            while x < w:
                n = 1
                while x + n < w and n < 255 and (row[x + n] == row[x]).all():
                    n += 1
                out += row[x].tobytes()
                if n > 2:
                    out += bytes([1, 1, 1, n - 1])
                else:
                    out += row[x + 1:x + n].tobytes()
                x += n
        else:
            out += bytes([2, 2, w >> 8, w & 0xFF])
            for c in range(4):
                out += _plane_rle(row[:, c].tobytes())
    return bytes(out)


def _plane_rle(data: bytes) -> bytes:
    """One plane of a new-style scanline: runs of 3-127 as ``128 + n,
    value``, literals of up to 128 as ``n, bytes``."""
    out, i, lit = bytearray(), 0, bytearray()
    while i < len(data):
        j = i
        while j < len(data) and data[j] == data[i] and j - i < 127:
            j += 1
        if j - i >= 3:
            if lit:
                out += bytes([len(lit)]) + lit
                lit = bytearray()
            out += bytes([128 + j - i, data[i]])
            i = j
        else:
            lit.append(data[i])
            i += 1
            if len(lit) == 128:
                out += bytes([128]) + lit
                lit = bytearray()
    if lit:
        out += bytes([len(lit)]) + lit
    return bytes(out)
