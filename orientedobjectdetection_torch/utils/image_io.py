"""Image reading, writing, resizing and drawing in numpy, the standard
library and the port's host C++ (a port-only module: the JAX package's data
path uses OpenCV, and the port depends on neither OpenCV nor PIL).

- :func:`imread` / :func:`imdecode`: PNG, JPEG, BMP, TIFF, PNM, PAM, PFM,
  Sun raster, Radiance HDR, GIF and lossless WebP as ``(H, W, 3)`` uint8
  BGR, as ``cv2.imread(path, cv2.IMREAD_COLOR)`` and ``cv2.imdecode``
  return them (a grey PFM as ``(H, W)``, as OpenCV 5.0 returns it), an
  orientation applied (a JPEG's first APP1 segment, a PNG's ``eXIf`` chunk,
  a TIFF's Orientation tag, a WebP's EXIF chunk where its VP8X flag says
  so; values 1-8, as OpenCV 5 applies them).

  - PNG: grey (1, 2, 4, 8 and 16 bits; low depths scaled to 8 bits as
    libpng expands them), grey + alpha, RGB and RGBA (8 or 16 bits) and
    palette images (1, 2, 4 and 8 bits), alpha and ``tRNS`` dropped, 16-bit
    samples cut to their high byte as OpenCV's ``png_set_strip_16`` does,
    plain or Adam7-interlaced, any of the five row filters. OpenCV writes
    every row with the Sub filter: rows of None, Sub and Up decode as
    whole-row numpy operations; a pass with any Average or Paeth row decodes
    along the image's anti-diagonals, an order of magnitude slower.
  - JPEG: ``native.jpeg_decode`` (``csrc/jpeg.cpp``, host C++ built with
    g++ at first use): baseline, extended and progressive files, Huffman-
    or arithmetic-coded, with 8-bit samples, and lossless files (predictors
    1-7, a point transform) of up to 8 bits; grey, YCbCr, RGB, CMYK and
    YCCK; bit for bit what libjpeg-turbo's default path gives (islow IDCT,
    fancy upsampling) and OpenCV makes of it (CMYK to BGR by its
    ``icvCvt_CMYK2BGR_8u_C4C3R``).
  - BMP: 24- and 32-bit (bottom-up or top-down rows, the fourth byte
    dropped), 1-, 4- and 8-bit palette images, RLE8 and RLE4 (runs,
    absolute runs, end of line, delta and end of bitmap; pixels a file
    skips take palette entry 0, as OpenCV's reader fills them), and 16-bit
    as 555 ``BI_RGB`` or 555 / 565 ``BI_BITFIELDS`` (OpenCV's 5- and 6-bit
    expansions, no bit replication).

  - TIFF: ``native.tiff_decode`` (``csrc/tiff.cpp``): the first page of a
    classic or BigTIFF file in either byte order, strips or tiles, planar
    or not, FillOrder 1 or 2, uncompressed, LZW (old-style LSB-first LZW
    too), PackBits, deflate, JPEG, CCITT RLE, RLEW, T.4 (1-D and 2-D) or
    T.6, or SGILog, Predictor 2; unsigned and signed samples by their bits;
    grey and MinIsWhite (1-16 bits), RGB (8 and 16), palette (1-8), CMYK,
    YCbCr, CIE L*a*b* (8 and 16), LogL and LogLuv, alpha premultiplied
    where it is unassociated: what libtiff's RGBA interface gives OpenCV.

  - PNM, PAM, PFM, Sun raster and Radiance HDR:
    ``native.raster_decode`` (``csrc/raster.cpp``): ``P1``-``P6`` (ASCII
    samples scaled by maxval to 8 bits, binary ones taken as stored, 16-bit
    ones by their high byte), ``P7`` of DEPTH 1 or 3, ``PF`` / ``Pf``
    (rounded and saturated, unscaled), Sun raster RT_OLD and RT_STANDARD
    at 1, 8, 24 and 32 bits with or without an RMT_EQUAL_RGB map, and
    Radiance HDR flat and RLE scanlines (times 255, saturated).
  - GIF: ``native.gif_decode`` (``csrc/gif.cpp``, after OpenCV 5.0's own
    GIF codec): the first image of a GIF87a or GIF89a file on its logical
    screen (the global table's background colour, black without one),
    transparent pixels keeping the screen's colour, local and global
    tables, offsets, interlaced rows, LZW of minimum code sizes 2-11.
  - WebP: ``native.webp_decode`` (``csrc/webp.cpp``): lossless (VP8L)
    stills, simple or in VP8X, and an animation's first frame on its
    transparent black canvas; every VP8L transform, colour caches, LZ77,
    meta prefix codes; alpha dropped, as ``IMREAD_COLOR`` drops it.

  The forms OpenCV reads and the port does not yet (lossy WebP, JPEG 2000,
  AVIF, known by their signatures or chunks) raise ``ValueError`` naming
  the form and ROADMAP A.4d; the forms OpenCV does not read either raise
  saying so:
  hierarchical, 12-bit, lossless arithmetic or over 8 bits JPEGs; float,
  complex or 32-bit signed TIFF samples, the floating-point predictor, ICC
  or ITU L*a*b*, old-style JPEG, LZMA, ZSTD, WebP, LERC and JPEG XL TIFFs,
  12-bit JPEG strips; PAM of DEPTH 2 or 4 (OpenCV 5.0 leaves most of its
  pixels unset), Sun raster RT_BYTE_ENCODED and RT_FORMAT_RGB (OpenCV
  5.0's reader takes neither), an HDR not ``-Y <h> +X <w>``; GIFs of
  disposal methods 4-7, a graphic control extension not 4 bytes long, a
  colour index past the tables, an image past the screen or a block other
  than an extension or an image before the trailer. Anything else that
  does not decode (truncated or corrupt data) raises ``ValueError`` too.
- :func:`imwrite` / :func:`imencode`: the bytes ``cv2.imwrite`` writes
  for the path's extension with OpenCV's defaults, of the arrays it
  takes: grey, BGR or BGRA of any integer, float or bool type, each writer
  keeping the types OpenCV's keeps and saturating the rest to uint8 as
  OpenCV does. ``.jpg``
  / ``.jpeg`` / ``.jpe`` a JPEG (``native.jpeg_encode``: quality 95, 4:2:0,
  baseline, alpha dropped), ``.tif`` / ``.tiff`` a TIFF
  (``native.tiff_encode``: LZW and Predictor 2 for integers of 8-32 bits,
  uncompressed floats, 8192 bytes a strip), ``.bmp`` / ``.dib`` a BMP
  (8-bit grey with its palette, 24-bit, or 32-bit BGRA behind a
  BITMAPV5HEADER), ``.png`` a PNG of 8 or 16 bits with every row
  Sub-filtered (as OpenCV filters them), ``.pbm`` / ``.pgm`` / ``.ppm`` /
  ``.pnm`` binary PNM (16 bits for uint16), ``.pam`` PAM, ``.pfm`` PFM
  (float32), ``.sr`` / ``.ras`` Sun raster, ``.hdr`` / ``.pic`` RLE
  Radiance HDR (``native.hdr_encode``), ``.gif`` OpenCV's GIF byte for byte
  (``native.gif_encode``: its fixed 8 x 8 x 4 table, Floyd-Steinberg
  dithering, alpha 0 transparent; a grey image refused as OpenCV refuses
  it) and ``.webp`` a lossless WebP (``native.webp_encode``) that decodes
  to what OpenCV's file decodes to, in the port's own bytes. An extension
  OpenCV writes in a form the port does not have yet raises ``ValueError``
  naming ROADMAP A.4d; one OpenCV has no writer for, and an array OpenCV
  refuses, raise as ``cv2.imwrite`` does.
- :func:`resize_bilinear`: ``cv2.resize(img, (w, h),
  interpolation=cv2.INTER_LINEAR)`` on uint8, in OpenCV's fixed-point
  arithmetic (11-bit weights, a horizontal pass into integers, a vertical
  pass rounded as its vector code rounds). It agrees with OpenCV within 1,
  in under 1% of the elements (``tests/test_torch_image_io.py``); the size
  the synthetic and DOTA configs resize to is the images' own, which is an
  exact copy.
- :func:`get_rotation_matrix_2d` and :func:`warp_affine`:
  ``cv2.getRotationMatrix2D`` and ``cv2.warpAffine(img, m, (w, h))`` with
  its defaults (``INTER_LINEAR``, ``BORDER_CONSTANT`` 0) on uint8, as
  OpenCV 5 computes it: the inverted map in float32, each source
  coordinate one fused multiply-add along the row, the four taps blended
  in float32 and rounded to nearest (a tap outside the image reads 0).
  Within 1 of OpenCV 5.0 in about 1e-5 of the elements
  (``tests/test_torch_augment.py``). OpenCV 4's fixed-point warp (source
  coordinates rounded to 1/32 of a pixel, 15-bit tap weights) differs from
  both by up to ~7 near half-pixels.
- :func:`fill_poly`, :func:`line`, :func:`circle`,
  :func:`gaussian_blur_3x3` and :func:`hsv2bgr`: what the synthetic-data
  generator draws with (``tools/generate_synth.py``), after OpenCV's
  ``fillPoly``, ``line``, ``circle``, ``GaussianBlur(img, (3, 3), 0)`` and
  ``cvtColor(..., COLOR_HSV2BGR)`` on uint8 images.
"""

from __future__ import annotations

import math
import os
import struct
import zlib
from typing import Tuple

import numpy as np

_SIGNATURE = b'\x89PNG\r\n\x1a\n'
_JPEG_SIGNATURE = b'\xff\xd8'
_TIFF_SIGNATURES = (b'II*\x00', b'MM\x00*', b'II+\x00', b'MM\x00+')
_GIF_SIGNATURES = (b'GIF87a', b'GIF89a')
# the forms cv2.imwrite writes (OpenCV 5.0's build) that the port does not
# yet, by extension
_LATER_WRITERS = {'.jp2': 'JPEG 2000', '.avif': 'AVIF'}
# and their signatures, the forms OpenCV's readers take that the port does
# not yet (lossy WebP is known by its chunk: csrc/webp.cpp names it)
_LATER_SIGNATURES = (
    (b'\x00\x00\x00\x0cjP  \r\n\x87\n', 'JPEG 2000'),
    (b'\xff\x4f\xff\x51', 'JPEG 2000'))
# csrc/raster.cpp's forms, known by OpenCV's signatures: 'P', the kind,
# whitespace (PNM 1-6, PAM 7, PFM F / f); Sun raster's magic; "#?RGBE" or
# "#?RADIANCE"
_SUN_SIGNATURE = b'\x59\xa6\x6a\x95'
_HDR_SIGNATURES = (b'#?RGBE', b'#?RADIANCE')


def _later_form(data: bytes):
    """The name of a form OpenCV reads and the port does not yet, or
    None."""
    for signature, name in _LATER_SIGNATURES:
        if data.startswith(signature):
            return name
    if data[4:8] == b'ftyp' and data[8:12] in (b'avif', b'avis'):
        return 'AVIF'
    return None


def _raster_form(data: bytes):
    """The name of a form ``csrc/raster.cpp`` reads, or None."""
    if data.startswith(_SUN_SIGNATURE):
        return 'Sun raster'
    if data.startswith(_HDR_SIGNATURES):
        return 'Radiance HDR'
    if len(data) > 2 and data[:1] == b'P' and data[2:3].isspace():
        return {b'7': 'PAM', b'F': 'PFM', b'f': 'PFM'}.get(
            data[1:2], 'PNM' if data[1:2] in b'123456' else None)
    return None


_MAX_PIXELS = 1 << 30           # OpenCV's limit (CV_IO_MAX_IMAGE_PIXELS)
# PNG colour type -> channels (grey, RGB, palette, grey + alpha, RGBA), and
# the bit depths each allows
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# Adam7 passes: first column and row, column and row steps
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError('truncated PNG chunk')
        if zlib.crc32(kind + body) != struct.unpack('>I', crc)[0]:
            raise ValueError(f'bad CRC in PNG chunk {kind!r}')
        yield kind, body
        pos += 12 + length


def _paeth(a, b, c):
    """The Paeth predictor on int16 arrays."""
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, filters: np.ndarray, bpp: int) -> np.ndarray:
    """(H, W * bpp) filtered bytes and each row's filter type -> the image
    bytes (PNG specification, section 9)."""
    h, stride = raw.shape
    if filters.max(initial=0) > 4:
        raise ValueError(f'unknown PNG row filter {int(filters.max())}')
    out = raw.copy()
    if not (filters >= 3).any():
        # None, Sub and Up only: each row is a whole-row operation
        for y in range(h):
            f = filters[y]
            if f == 1:
                row = out[y].reshape(-1, bpp)
                np.cumsum(row, axis=0, dtype=np.uint8, out=row)
            elif f == 2 and y > 0:
                out[y] += out[y - 1]
        return out
    # Average or Paeth rows: pixel (y, x) needs (y, x - 1), (y - 1, x) and
    # (y - 1, x - 1) first, so go along the anti-diagonals y + x = t
    w = stride // bpp
    pix = np.zeros((h + 1, w + 1, bpp), np.int16)      # a zero row and column
    filt = raw.reshape(h, w, bpp).astype(np.int16)
    for t in range(h + w - 1):
        y = np.arange(max(0, t - w + 1), min(h, t + 1))
        x = t - y
        a = pix[y + 1, x]
        b = pix[y, x + 1]
        c = pix[y, x]
        f = filters[y][:, None]
        pred = np.select([f == 1, f == 2, f == 3, f == 4],
                         [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
        pix[y + 1, x + 1] = (filt[y, x] + pred) & 0xFF
    return pix[1:, 1:].astype(np.uint8).reshape(h, stride)


def imread(path: str) -> np.ndarray:
    """Read a PNG, JPEG, BMP, TIFF (its first page), PNM, PAM, PFM, Sun
    raster, Radiance HDR, GIF (its first image) or lossless WebP file as
    ``cv2.imread(path, cv2.IMREAD_COLOR)`` reads it: ``(H, W, 3)`` uint8
    BGR (``(H, W)`` for a grey PFM)."""
    with open(path, 'rb') as f:
        return imdecode(f.read(), path)


def imdecode(data: bytes, path: str = '<bytes>') -> np.ndarray:
    """Decode the bytes of a PNG, JPEG, BMP, TIFF (its first page), PNM,
    PAM, PFM, Sun raster, Radiance HDR, GIF (its first image) or lossless
    WebP file as ``cv2.imdecode(data, cv2.IMREAD_COLOR)`` does: ``(H, W, 3)`` uint8 BGR, with its orientation
    applied (``(H, W)`` uint8 for a grey PFM, which OpenCV returns so);
    ``path`` names the source in errors. Raises ValueError for anything
    else (the forms ROADMAP A.4d lists, by name, and those OpenCV does not
    read either, saying so)."""
    data = bytes(data)
    if data.startswith(_BMP_SIGNATURE):
        return _read_bmp(path, data)
    if data.startswith(_JPEG_SIGNATURE):
        from .. import native
        try:
            img = native.jpeg_decode(data)
        except ValueError as e:
            raise ValueError(f'{path}: JPEG: {e}') from None
        return _orient(img, _exif_orientation(_jpeg_exif(data)))
    if data.startswith(_TIFF_SIGNATURES):
        from .. import native
        try:
            img, orientation = native.tiff_decode(data)
        except ValueError as e:
            raise ValueError(f'{path}: TIFF: {e}') from None
        return _orient(img, orientation)
    if data.startswith(_GIF_SIGNATURES):
        from .. import native
        try:
            return native.gif_decode(data)
        except ValueError as e:
            raise ValueError(f'{path}: GIF: {e}') from None
    if data[:4] == b'RIFF' and data[8:12] == b'WEBP':
        from .. import native
        try:
            img = native.webp_decode(data)
        except ValueError as e:
            raise ValueError(f'{path}: WebP: {e}') from None
        return _orient(img, _exif_orientation(_webp_exif(data)))
    raster = _raster_form(data)
    if raster:
        from .. import native
        try:
            return native.raster_decode(data)
        except ValueError as e:
            raise ValueError(f'{path}: {raster}: {e}') from None
    if not data.startswith(_SIGNATURE):
        later = _later_form(data)
        if later:
            raise ValueError(f'{path}: reading {later} images is not ported '
                             f'yet (ROADMAP A.4d)')
        raise ValueError(f'{path}: not a PNG, JPEG, BMP, TIFF, PNM, PAM, '
                         f'PFM, Sun raster, Radiance HDR, GIF or WebP file')
    return _read_png(path, data)


# ---- EXIF orientation ----------------------------------------------------
def _jpeg_exif(data: bytes) -> bytes:
    """The TIFF block of a JPEG's first APP1 segment (the one OpenCV
    reads, whatever it holds), or b''."""
    pos = 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker == 0xFF:                                 # a fill byte
            pos += 1
            continue
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        if marker in (0xDA, 0xD9):                         # SOS, EOI
            break
        length = struct.unpack('>H', data[pos + 2:pos + 4])[0]
        if marker == 0xE1:
            return data[pos + 4 + 6:pos + 2 + length]
        pos += 2 + length
    return b''


def _webp_exif(data: bytes) -> bytes:
    """The payload of a WebP's first EXIF chunk where its VP8X chunk's
    EXIF flag is set (the one OpenCV applies), or b''."""
    if data[12:16] != b'VP8X' or len(data) < 21 or not data[20] & 0x08:
        return b''
    pos, end = 12, min(len(data), 8 + struct.unpack_from('<I', data, 4)[0])
    while pos + 8 <= end:
        size = struct.unpack_from('<I', data, pos + 4)[0]
        if data[pos:pos + 4] == b'EXIF':
            return data[pos + 8:pos + 8 + size]
        pos += 8 + size + (size & 1)
    return b''


def _exif_orientation(tiff: bytes) -> int:
    """The orientation tag (0x0112) of IFD0 in a TIFF-structured EXIF
    block: 1-8, or 1 where there is none or the block does not parse."""
    if len(tiff) < 8 or tiff[:2] not in (b'II', b'MM'):
        return 1
    order = '<' if tiff[:2] == b'II' else '>'
    try:
        if struct.unpack_from(order + 'H', tiff, 2)[0] != 42:
            return 1
        ifd = struct.unpack_from(order + 'I', tiff, 4)[0]
        count = struct.unpack_from(order + 'H', tiff, ifd)[0]
        for i in range(count):
            tag = struct.unpack_from(order + 'H', tiff, ifd + 2 + 12 * i)[0]
            if tag == 0x0112:
                value = struct.unpack_from(order + 'H', tiff,
                                           ifd + 2 + 12 * i + 8)[0]
                return value if 1 <= value <= 8 else 1
    except struct.error:
        return 1
    return 1


def _orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """OpenCV's ``ApplyExifOrientation``: 2-4 flip, 5-8 transpose and
    then flip."""
    if orientation == 1:
        return img
    if orientation >= 5:
        img = img.transpose(1, 0, 2)
    flips = {2: (1,), 3: (0, 1), 4: (0,), 5: (), 6: (1,), 7: (0, 1),
             8: (0,)}[orientation]
    for axis in flips:
        img = np.flip(img, axis)
    return np.ascontiguousarray(img)


# ---- PNG ------------------------------------------------------------------
def _png_samples(raw: np.ndarray, h: int, w: int, depth: int,
                 channels: int) -> np.ndarray:
    """One (sub)image's filtered bytes -> (h, w, channels) samples, 8-bit
    (16-bit cut to the high byte; low depths as indices, unscaled)."""
    bits = depth * channels
    stride = (w * bits + 7) // 8
    rows = raw.reshape(h, stride + 1)
    data = _unfilter(rows[:, 1:], rows[:, 0], max(1, bits // 8))
    if depth == 16:
        return data.reshape(h, w, channels, 2)[..., 0]
    if depth == 8:
        return data.reshape(h, w, channels)
    unpacked = np.unpackbits(data, axis=1)[:, :w * depth].reshape(h, w,
                                                                   depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (unpacked * weights).sum(-1, dtype=np.uint8)[..., None]


def _read_png(path: str, data: bytes) -> np.ndarray:
    header, idat, palette, exif = None, [], None, b''
    for kind, body in _chunks(data):
        if kind == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif kind == b'PLTE':
            palette = body
        elif kind == b'eXIf' and not idat:
            exif = body
        elif kind == b'IDAT':
            idat.append(body)
        elif kind == b'IEND':
            break
    if header is None or not idat:
        raise ValueError(f'{path}: PNG without IHDR or IDAT')
    width, height, depth, colour, _, _, interlace = header
    if not width or not height or width * height > _MAX_PIXELS:
        raise ValueError(f'{path}: PNG of {width} x {height} pixels')
    if colour not in _CHANNELS or depth not in _DEPTHS[colour]:
        raise ValueError(f'{path}: PNG of colour type {colour} and bit depth '
                         f'{depth} is not valid')
    if interlace > 1:
        raise ValueError(f'{path}: unknown PNG interlace method {interlace}')
    if colour == 3 and palette is None:
        raise ValueError(f'{path}: palette PNG without PLTE')
    channels = _CHANNELS[colour]
    try:
        raw = np.frombuffer(zlib.decompress(b''.join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f'{path}: PNG image data does not inflate: {e}') \
            from None
    passes = (_ADAM7 if interlace else ((0, 0, 1, 1),))
    sizes = [((height - y0 + dy - 1) // dy, (width - x0 + dx - 1) // dx)
             for x0, y0, dx, dy in passes]
    need = sum(ph * ((pw * depth * channels + 7) // 8 + 1)
               for ph, pw in sizes if ph and pw)
    if raw.size != need:
        raise ValueError(f'{path}: image data of {raw.size} bytes, '
                         f'expected {need}')
    img = np.empty((height, width, channels), np.uint8)
    at = 0
    for (x0, y0, dx, dy), (ph, pw) in zip(passes, sizes):
        if not ph or not pw:
            continue
        n = ph * ((pw * depth * channels + 7) // 8 + 1)
        img[y0::dy, x0::dx] = _png_samples(raw[at:at + n], ph, pw, depth,
                                           channels)
        at += n
    if colour == 3:
        lut = np.zeros((256, 3), np.uint8)        # indices past PLTE: black
        entries = np.frombuffer(palette, np.uint8)[:len(palette) // 3 * 3]
        lut[:len(entries) // 3] = entries.reshape(-1, 3)[:256]
        out = lut[img[..., 0]][..., ::-1]
    elif colour in (0, 4):
        grey = img[..., 0]
        if depth < 8:                     # libpng's 1/2/4 -> 8-bit expansion
            grey = grey * np.uint8(255 // ((1 << depth) - 1))
        out = np.repeat(grey[..., None], 3, axis=-1)
    else:
        out = img[..., 2::-1]                              # RGB(A) -> BGR
    return _orient(np.ascontiguousarray(out), _exif_orientation(exif))


# ---- BMP ------------------------------------------------------------------
# compression types, and the channel masks of the BI_BITFIELDS forms read
_BMP_SIGNATURE = b'BM'
_BI_RGB, _BI_RLE8, _BI_RLE4, _BI_BITFIELDS = 0, 1, 2, 3
_BGRX_MASKS = (0x00FF0000, 0x0000FF00, 0x000000FF)
_MASKS_555 = (0x7C00, 0x03E0, 0x001F)
_MASKS_565 = (0xF800, 0x07E0, 0x001F)


def _bmp_palette(path, data, header_size, bits, colours) -> np.ndarray:
    """The palette as a (256, 3) BGR table, entries past it black."""
    entry = 3 if header_size == 12 else 4
    count = min(colours or (1 << bits), 256)
    start = 14 + header_size
    if start + count * entry > len(data):
        raise ValueError(f'{path}: BMP palette is truncated')
    table = np.frombuffer(data, np.uint8, count=count * entry, offset=start)
    lut = np.zeros((256, 3), np.uint8)
    lut[:len(table) // entry] = table.reshape(-1, entry)[:, :3]
    return lut


def _bmp_rle(path, data, offset, width, height, bits) -> np.ndarray:
    """RLE8 / RLE4 data -> (height, width) palette indices in file row
    order, as OpenCV's reader walks it: an RLE8 run that fills its line
    moves to the next one (and an end of line just after it does nothing);
    end of line, delta and end of bitmap skip pixels in raster order,
    leaving them index 0 (OpenCV 5's RLE4 delta moves along the line
    alone, its rows ignored)."""
    out = np.zeros((height, width), np.uint8)
    pos, y, x, wrapped = offset, 0, 0, False

    def take(n):
        nonlocal pos
        if pos + n > len(data):
            raise ValueError(f'{path}: RLE data is truncated')
        chunk = data[pos:pos + n]
        pos += n
        return chunk

    def skip(n):                    # OpenCV's FillUniColor with entry 0
        nonlocal y, x
        while True:
            step = min(n, width - x)
            x += step
            n -= step
            if x >= width:
                x, y = 0, y + 1
                if y >= height:
                    return
            if n <= 0:
                return

    while y < height:
        count, code = take(2)
        if count:                                          # encoded run
            if x + count > width:
                raise ValueError(f'{path}: RLE run past the end of a line')
            pair = [code] if bits == 8 else [code >> 4, code & 15]
            out[y, x:x + count] = np.resize(np.array(pair, np.uint8), count)
            x += count
            wrapped = bits == 8 and x == width
            if wrapped:
                x, y = 0, y + 1
        elif code > 2:                                     # absolute run
            if x + code > width:
                raise ValueError(f'{path}: RLE run past the end of a line')
            if bits == 8:
                run = np.frombuffer(take((code + 1) & ~1), np.uint8)
            else:
                packed = np.frombuffer(take((((code + 1) >> 1) + 1) & ~1),
                                       np.uint8)
                run = np.stack([packed >> 4, packed & 15], -1).reshape(-1)
            out[y, x:x + code] = run[:code]
            x += code
            wrapped = False
        else:                       # end of line (0), of bitmap (1), delta
            if code == 0 and wrapped:
                wrapped = False
                continue
            if code == 2:
                dx, dy = take(2)
                n = dx + dy * width if bits == 8 else dx
            else:
                n = width - x + (0 if code == 0 else (height - y) * width)
            skip(n)
            wrapped = False
    return out


def _read_bmp(path: str, data: bytes) -> np.ndarray:
    if len(data) < 26:
        raise ValueError(f'{path}: truncated BMP header')
    offset, header_size = struct.unpack_from('<II', data, 10)
    colours = 0
    if header_size == 12:                              # BITMAPCOREHEADER
        width, height, _, bits = struct.unpack_from('<HHHH', data, 18)
        compression = _BI_RGB
    elif header_size >= 40 and len(data) >= 14 + 40:
        width, height, _, bits, compression = struct.unpack_from(
            '<iiHHI', data, 18)
        colours = struct.unpack_from('<I', data, 46)[0]
    else:
        raise ValueError(f'{path}: BMP header of {header_size} bytes')
    top_down = height < 0
    height = abs(height)
    if width <= 0 or height == 0 or width * height > _MAX_PIXELS:
        raise ValueError(f'{path}: BMP of {width} x {height} pixels')
    if compression in (_BI_RLE8, _BI_RLE4):
        if (compression, bits) not in ((_BI_RLE8, 8), (_BI_RLE4, 4)):
            raise ValueError(f'{path}: RLE{bits} is not a valid BMP form')
        lut = _bmp_palette(path, data, header_size, bits, colours)
        idx = _bmp_rle(path, data, offset, width, height, bits)
        img = lut[idx]
        return np.ascontiguousarray(img if top_down else img[::-1])
    masks = None
    if compression == _BI_BITFIELDS:
        if len(data) < 14 + 40 + 12:
            raise ValueError(f'{path}: truncated BMP header')
        masks = struct.unpack_from('<III', data, 14 + 40)
    elif compression != _BI_RGB:
        raise ValueError(f'{path}: BMP compression {compression} is not '
                         'read')
    if bits not in (1, 4, 8, 16, 24, 32):
        raise ValueError(f'{path}: {bits}-bit BMP is not read')
    if bits == 16 and masks not in (None, _MASKS_555, _MASKS_565):
        raise ValueError(f'{path}: 16-bit BMP channel masks '
                         f'{[hex(m) for m in masks]} are not read')
    if bits == 32 and masks not in (None, _BGRX_MASKS):
        raise ValueError(f'{path}: BMP channel masks '
                         f'{[hex(m) for m in masks]} are not read')
    if bits in (1, 4, 8) and masks is not None:
        raise ValueError(f'{path}: {bits}-bit BMP with channel masks')
    stride = ((width * bits + 31) // 32) * 4
    if offset + stride * height > len(data):
        raise ValueError(f'{path}: BMP pixel data is truncated')
    rows = np.frombuffer(data, np.uint8, count=stride * height,
                         offset=offset).reshape(height, stride)
    if bits <= 8:
        lut = _bmp_palette(path, data, header_size, bits, colours)
        if bits == 8:
            idx = rows[:, :width]
        else:
            unpacked = np.unpackbits(rows, axis=1).reshape(height, -1, bits)
            weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint8)
            idx = (unpacked * weights).sum(-1, dtype=np.uint8)[:, :width]
        img = lut[idx]
    elif bits == 16:
        v = rows[:, :width * 2].view('<u2').astype(np.uint16)
        if masks == _MASKS_565:
            img = np.stack([v << 3, (v >> 3) & 0xFC, (v >> 8) & 0xF8], -1)
        else:
            img = np.stack([v << 3, (v >> 2) & 0xF8, (v >> 7) & 0xF8], -1)
        img = (img & 0xFF).astype(np.uint8)
    else:
        pixel = bits // 8
        img = rows[:, :width * pixel].reshape(height, width, pixel)[..., :3]
    return np.ascontiguousarray(img if top_down else img[::-1])


# ---- writers ----------------------------------------------------------------
def _bmp_bytes(img: np.ndarray) -> bytes:
    """uint8 grey, BGR or BGRA -> the bytes ``cv2.imwrite`` gives a
    ``.bmp``: bottom-up rows padded to 4 bytes after a 40-byte header (grey
    after a palette of the 256 greys too), or for BGRA after a 124-byte
    BITMAPV5HEADER of ``BI_BITFIELDS`` masks and the sRGB colour space."""
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    stride = (w * c + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * c] = img[::-1].reshape(h, w * c)
    extra = b''
    if c == 1:
        extra = np.repeat(np.arange(256, dtype=np.uint8), 4).reshape(256, 4)
        extra[:, 3] = 0
        extra = extra.tobytes()
    if c == 4:
        header = struct.pack('<IiiHHIIiiII4I4s', 124, w, h, 1, 32,
                             _BI_BITFIELDS, 0, 0, 0, 0, 0, *_BGRX_MASKS,
                             0xFF000000, b'BGRs') + bytes(64)
    else:
        header = struct.pack('<IiiHHIIiiII', 40, w, h, 1, 8 * c, _BI_RGB, 0,
                             0, 0, 0, 0)
    offset = 14 + len(header) + len(extra)
    return (struct.pack('<2sIHHI', _BMP_SIGNATURE, offset + rows.size, 0, 0,
                        offset) + header + extra + rows.tobytes())


def _png_bytes(img: np.ndarray, level: int) -> bytes:
    """uint8 or uint16 grey, BGR or BGRA -> a PNG of colour type 0, 2 or 6
    at 8 or 16 bits (big-endian samples), every row with the Sub filter as
    OpenCV filters them (None where it is one pixel wide), compressed at
    zlib ``level``."""
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    if c > 1:
        img = img[..., (2, 1, 0, 3)[:c]]                  # BGR(A) -> RGB(A)
    samples = img.astype('>u2') if img.dtype == np.uint16 else img
    raw = np.ascontiguousarray(samples).view(np.uint8).reshape(h, -1)
    bpp = c * samples.itemsize
    sub = raw.copy()
    sub[:, bpp:] -= raw[:, :-bpp]                          # wraps mod 256
    # libpng gives a one-pixel row the None filter
    rows = np.concatenate([np.full((h, 1), int(w > 1), np.uint8), sub],
                          axis=1)

    def chunk(kind, body):
        return (struct.pack('>I', len(body)) + kind + body +
                struct.pack('>I', zlib.crc32(kind + body)))

    ihdr = struct.pack('>IIBBBBB', w, h, 8 * samples.itemsize,
                       {1: 0, 3: 2, 4: 6}[c], 0, 0, 0)
    return (_SIGNATURE + chunk(b'IHDR', ihdr) +
            chunk(b'IDAT', zlib.compress(rows.tobytes(), level)) +
            chunk(b'IEND', b''))


def _jpeg_bytes(img: np.ndarray) -> bytes:
    """``native.jpeg_encode``; OpenCV drops a BGRA image's alpha."""
    from .. import native
    return native.jpeg_encode(img[..., :3] if img.ndim == 3 else img)


def _tiff_bytes(img: np.ndarray) -> bytes:
    """``native.tiff_encode``; 64-bit integers are written as 32-bit signed
    ones, wrapped (OpenCV 5.0's TIFF writer has no 64-bit integer
    form)."""
    from .. import native
    if img.dtype.kind in 'iu' and img.dtype.itemsize == 8:
        img = img.astype(np.int32)
    return native.tiff_encode(img)


def _pnm_bytes(img: np.ndarray) -> bytes:
    """Binary PGM (``P5``) or PPM (``P6``, RGB order), maxval 255 or, for
    uint16, 65535 with big-endian samples."""
    h, w = img.shape[:2]
    kind = b'P5' if img.ndim == 2 else b'P6'
    if img.ndim == 3:
        img = img[..., ::-1]
    wide = img.dtype == np.uint16
    samples = img.astype('>u2') if wide else img
    return (b'%s\n%d %d\n%d\n' % (kind, w, h, 65535 if wide else 255) +
            np.ascontiguousarray(samples).tobytes())


def _pbm_bytes(img: np.ndarray) -> bytes:
    """Binary PBM (``P4``): a pixel of 0 is a set (black) bit."""
    h, w = img.shape
    return b'P4\n%d %d\n' % (w, h) + np.packbits(img == 0, axis=1).tobytes()


def _pam_bytes(img: np.ndarray) -> bytes:
    """PAM (``P7``) of DEPTH 1, 3 or 4, no TUPLTYPE line, the samples in
    stored (BGR) order, big-endian at 16 bits."""
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    wide = img.dtype == np.uint16
    samples = img.astype('>u2') if wide else img
    return (b'P7\nWIDTH %d\nHEIGHT %d\nDEPTH %d\nMAXVAL %d\nENDHDR\n'
            % (w, h, c, 65535 if wide else 255) +
            np.ascontiguousarray(samples).tobytes())


def _pfm_bytes(img: np.ndarray) -> bytes:
    """PFM: ``Pf`` (grey) or ``PF`` (RGB order), scale -1 (little-endian),
    rows bottom-up; the samples converted to float32, unscaled."""
    h, w = img.shape[:2]
    kind = b'Pf' if img.ndim == 2 else b'PF'
    if img.ndim == 3:
        img = img[..., ::-1]
    return (b'%s\n%d %d\n-1\n' % (kind, w, h) +
            np.ascontiguousarray(img[::-1], '<f4').tobytes())


def _sun_bytes(img: np.ndarray) -> bytes:
    """Sun raster, RT_STANDARD and no colour map, at 8, 24 or 32 bits, the
    samples in stored (BGR) order. OpenCV writes each row's padded length
    (an even number of bytes) from the row's start, so an odd row's pad
    byte is the next row's first; the last row's is 0 here (OpenCV's
    reads past its buffer)."""
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    step = (w * c + 1) & ~1
    rows = np.zeros((h, step), np.uint8)
    rows[:, :w * c] = img.reshape(h, w * c)
    if step > w * c:
        rows[:-1, -1] = rows[1:, 0]
    return struct.pack('>8I', int.from_bytes(_SUN_SIGNATURE, 'big'), w, h,
                       8 * c, step * h, 1, 0, 0) + rows.tobytes()


def _gif_bytes(img: np.ndarray) -> bytes:
    """``native.gif_encode``; OpenCV's GIF writer refuses a grey image."""
    from .. import native
    if img.ndim == 2:
        raise ValueError("cv2.imwrite refuses a grey image too "
                         "((-215:Assertion failed) false in function "
                         "'ditheringKernel')")
    return native.gif_encode(img)


def _webp_bytes(img: np.ndarray) -> bytes:
    """``native.webp_encode``: lossless, as OpenCV writes with its
    defaults."""
    from .. import native
    return native.webp_encode(img)


def _hdr_bytes(img: np.ndarray) -> bytes:
    """``native.hdr_encode`` of float32 BGR: a grey image as three equal
    channels, another sample type converted to float32 times 1 / 255 as
    OpenCV's HDR writer converts it."""
    from .. import native
    if img.dtype != np.float32:
        img = img.astype(np.float32) * np.float32(1 / 255)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    return native.hdr_encode(img)


# cv2.imwrite's writers by extension (OpenCV 5.0's build): the form's name,
# the channels it takes, the numpy type kinds and sizes it writes as they
# are (every other array is saturated to uint8 first, as OpenCV's
# convertTo(CV_8U) saturates it: floats rounded half to even, NaN and those
# past int32 giving 0), and its encoder
_U8 = ('u1',)
_U16 = ('u1', 'u2')
_ALL = ('u1', 'u2', 'u4', 'u8', 'i1', 'i2', 'i4', 'i8', 'f2', 'f4', 'f8')
_NOT_F2 = tuple(k for k in _ALL if k != 'f2')
_NOT_F8 = _ALL[:-1]
_WRITERS = {
    '.png': ('PNG', (1, 3, 4), _U16, None),
    '.bmp': ('BMP', (1, 3, 4), _U8, _bmp_bytes),
    '.dib': ('BMP', (1, 3, 4), _U8, _bmp_bytes),
    '.jpg': ('JPEG', (1, 3, 4), _U8, _jpeg_bytes),
    '.jpeg': ('JPEG', (1, 3, 4), _U8, _jpeg_bytes),
    '.jpe': ('JPEG', (1, 3, 4), _U8, _jpeg_bytes),
    '.tif': ('TIFF', (1, 3, 4), _NOT_F2, _tiff_bytes),
    '.tiff': ('TIFF', (1, 3, 4), _NOT_F2, _tiff_bytes),
    '.pbm': ('PBM', (1,), _U8, _pbm_bytes),
    '.pgm': ('PGM', (1,), _U16, _pnm_bytes),
    '.ppm': ('PPM', (3,), _U16, _pnm_bytes),
    '.pnm': ('PNM', (1, 3), _U16, _pnm_bytes),
    '.pam': ('PAM', (1, 3, 4), _U16, _pam_bytes),
    '.pfm': ('PFM', (1, 3), _ALL, _pfm_bytes),
    '.sr': ('Sun raster', (1, 3, 4), _U8, _sun_bytes),
    '.ras': ('Sun raster', (1, 3, 4), _U8, _sun_bytes),
    '.hdr': ('Radiance HDR', (1, 3), _NOT_F8, _hdr_bytes),
    '.pic': ('Radiance HDR', (1, 3), _NOT_F8, _hdr_bytes),
    '.gif': ('GIF', (1, 3, 4), _U8, _gif_bytes),
    '.webp': ('WebP', (1, 3, 4), _U8, _webp_bytes),
}


def _saturate_u8(img: np.ndarray) -> np.ndarray:
    """OpenCV's ``convertTo(CV_8U)``: integers clipped to 0-255; floats
    rounded half to even, then clipped, NaN and values whose rounding
    leaves int32 giving 0 (``cvRound``'s overflow); bool 0 / 1."""
    if img.dtype.kind == 'f':
        r = np.rint(img.astype(np.float64))
        inside = (r >= -2.0 ** 31) & (r < 2.0 ** 31)
        return np.clip(np.where(inside, r, 0), 0, 255).astype(np.uint8)
    if img.dtype == np.uint64:
        return np.minimum(img, 255).astype(np.uint8)
    return np.clip(img.astype(np.int64), 0, 255).astype(np.uint8)


def _imwrite_array(path: str, img) -> np.ndarray:
    """The array as ``cv2.imwrite`` takes it: 0-d and 1-d arrays as one
    row, ``(H, W, 1)`` as grey, native byte order. Raises ValueError, with
    OpenCV's reason, where it refuses the array."""
    img = np.asarray(img)
    if img.dtype.kind not in 'biuf' or img.dtype.itemsize > 8:
        raise ValueError(f'{path}: cv2.imwrite refuses {img.dtype} samples '
                         f'too (img data type = {img.dtype} is not '
                         f'supported)')
    if img.size == 0:
        raise ValueError(f'{path}: an empty array, {img.shape}: '
                         f'cv2.imwrite refuses it too (!_img.empty())')
    if img.ndim > 3:
        raise ValueError(f'{path}: an array of {img.ndim} dimensions: '
                         f'cv2.imwrite writes none (it returns False)')
    img = img.reshape((1, -1) if img.ndim < 2 else img.shape)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 3 and img.shape[2] not in (3, 4):
        raise ValueError(f'{path}: imwrite takes 1, 3 or 4 channels, got '
                         f'{img.shape}: cv2.imwrite refuses it too '
                         f'(channels == 1 || channels == 3 || channels == 4)')
    return img.astype(img.dtype.newbyteorder('='), copy=False)


def imencode(ext: str, img: np.ndarray, level: int = 1,
             name: str = None) -> bytes:
    """The bytes ``cv2.imencode(ext, img)`` gives with OpenCV's defaults
    (the module docstring lists the writers; ``_WRITERS`` the channels each
    takes and the types it keeps, every other saturated to uint8 as OpenCV
    converts it). A PNG is compressed at zlib ``level``: OpenCV's zlib
    compresses the same rows to other bytes. Raises ValueError, its message
    led by ``name`` (the extension unless given), for another extension
    (naming ROADMAP A.4d where OpenCV writes it, as ``cv2.imencode`` raises
    where it has no writer) and for an array OpenCV refuses, with its
    reason."""
    ext = ext.lower()
    name = name or ext
    if ext in _LATER_WRITERS:
        raise ValueError(f'{name}: writing {_LATER_WRITERS[ext]} images is '
                         f'not ported yet (ROADMAP A.4d)')
    if ext not in _WRITERS:
        raise ValueError(f'{name}: could not find a writer for the '
                         f'extension {ext!r}')
    form, channels, keeps, encode = _WRITERS[ext]
    img = _imwrite_array(name, img)
    c = 1 if img.ndim == 2 else img.shape[2]
    if c not in channels:
        raise ValueError(f'{name}: OpenCV writes no {form} of {c} '
                         f'channel{"s" * (c > 1)} (cv2.imwrite returns '
                         f'False): it takes {" or ".join(map(str, channels))}')
    if img.dtype.str[1:] not in keeps:
        img = _saturate_u8(img)
    if not encode:
        return _png_bytes(img, level)
    try:
        return encode(img)
    except ValueError as e:
        raise ValueError(f'{name}: {form}: {e}') from None


def imwrite(path: str, img: np.ndarray, level: int = 1) -> None:
    """Write ``img`` as ``cv2.imwrite`` writes the path's extension: the
    bytes of :func:`imencode`, which raises (writing nothing) where OpenCV
    refuses the extension or the array."""
    _write_atomic(path, imencode(os.path.splitext(path)[1], img, level,
                                 name=path))


def _write_atomic(path: str, data: bytes) -> None:
    tmp = path + '.tmp'
    with open(tmp, 'wb') as f:
        f.write(data)
    os.replace(tmp, path)


# ---- resize --------------------------------------------------------------
_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS


def _linear_taps(dst: int, src: int):
    """OpenCV's source index and 11-bit weights of each output position
    (``resize.cpp``, INTER_LINEAR): the centre-aligned coordinate, clamped
    to the first and last source pixel there."""
    scale = src / dst
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s
    low = s < 0
    f[low], s[low] = 0, 0
    high = s >= src - 1
    f[high], s[high] = 0, src - 1
    w1 = np.round(f * _COEF_SCALE).astype(np.int64)
    w0 = np.round((1 - f) * _COEF_SCALE).astype(np.int64)
    return s, np.minimum(s + 1, src - 1), w0, w1


def resize_bilinear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize of a uint8 ``(H, W[, C])`` image to
    ``size = (new_w, new_h)`` (OpenCV's argument order), within 1 of
    ``cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)``."""
    new_w, new_h = int(size[0]), int(size[1])
    h, w = img.shape[:2]
    if (new_w, new_h) == (w, h):
        return img.copy()
    x0, x1, a0, a1 = _linear_taps(new_w, w)
    y0, y1, b0, b1 = _linear_taps(new_h, h)
    src = img.astype(np.int64)
    shape = (1, -1) + (1,) * (img.ndim - 2)
    rows = (src[:, x0] * a0.reshape(shape) +
            src[:, x1] * a1.reshape(shape))               # 11 fractional bits
    shape = (-1,) + (1,) * (img.ndim - 1)
    # OpenCV's vector rounding: ((S0 >> 4) * b0 >> 16) + ((S1 >> 4) * b1
    # >> 16), then + 2 >> 2
    top = ((rows[y0] >> 4) * b0.reshape(shape)) >> 16
    bottom = ((rows[y1] >> 4) * b1.reshape(shape)) >> 16
    return np.clip((top + bottom + 2) >> 2, 0, 255).astype(np.uint8)


# ---- rotation ---------------------------------------------------------------
def get_rotation_matrix_2d(center, angle: float, scale: float = 1.0
                           ) -> np.ndarray:
    """``cv2.getRotationMatrix2D(center, angle, scale)``: the ``(2, 3)``
    float64 map of a rotation by ``angle`` degrees counter-clockwise (the
    image's y axis points down) about ``center = (x, y)``, a float32
    point as OpenCV takes it."""
    cx, cy = (float(np.float32(v)) for v in center)
    angle = angle * (math.pi / 180)
    alpha = math.cos(angle) * scale
    beta = math.sin(angle) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]],
                    np.float64)


def _invert_affine(m: np.ndarray) -> np.ndarray:
    """OpenCV's inversion of the forward map (``warpAffine`` without
    ``WARP_INVERSE_MAP``), operation for operation in float64."""
    m = [float(v) for v in np.asarray(m, np.float64).reshape(6)]
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[4] = a11, a22
    m[1] *= -d
    m[3] *= -d
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return np.asarray(m, np.float64)


def _fma32(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once: the float64 product of two
    float32 values is exact."""
    return (np.float64(a) * np.asarray(b, np.float64) +
            np.asarray(c, np.float64)).astype(np.float32)


def warp_affine(img: np.ndarray, m: np.ndarray, dsize) -> np.ndarray:
    """``cv2.warpAffine(img, m, dsize)`` on a uint8 ``(H, W[, C])`` image:
    bilinear, the border constant 0, ``dsize = (width, height)``.

    Output pixel ``(x, y)`` reads the source at ``sx = fma(x, a0, y * a1 +
    a2)`` (likewise ``sy``) with ``a`` the inverted map in float32; the taps
    around ``(sx, sy)`` blend as ``v0 + beta * (v1 - v0)`` of the row blends
    ``p0 + alpha * (p1 - p0)``, in float32, rounded half to even."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f'warp_affine takes uint8 images, got {img.dtype}')
    w_dst, h_dst = int(dsize[0]), int(dsize[1])
    h_src, w_src = img.shape[:2]
    a = _invert_affine(m).astype(np.float32)
    xs = np.arange(w_dst, dtype=np.float32)[None, :]
    ys = np.arange(h_dst, dtype=np.float32)[:, None]
    sx = _fma32(a[0], xs, ys * a[1] + a[2])
    sy = _fma32(a[3], xs, ys * a[4] + a[5])
    ix, iy = np.floor(sx), np.floor(sy)
    alpha = (sx - ix)[..., None]
    beta = (sy - iy)[..., None]
    ix, iy = ix.astype(np.int64), iy.astype(np.int64)
    src = img.reshape(h_src, w_src, -1)

    def tap(dy, dx):
        ty, tx = iy + dy, ix + dx
        inside = (tx >= 0) & (tx < w_src) & (ty >= 0) & (ty < h_src)
        v = src[np.clip(ty, 0, h_src - 1), np.clip(tx, 0, w_src - 1)]
        return np.where(inside[..., None], v.astype(np.float32),
                        np.float32(0))

    p00, p01, p10, p11 = tap(0, 0), tap(0, 1), tap(1, 0), tap(1, 1)
    v0 = p00 + alpha * (p01 - p00)
    v1 = p10 + alpha * (p11 - p10)
    out = np.clip(np.rint(v0 + beta * (v1 - v0)), 0, 255).astype(np.uint8)
    return out.reshape((h_dst, w_dst) + img.shape[2:])


# ---- drawing (the synthetic-data generator) --------------------------------
_XY_SHIFT = 16


def _hline(img, y, x1, x2, color):
    h, w = img.shape[:2]
    if 0 <= y < h and x1 < w and x2 >= 0:
        img[y, max(x1, 0):min(x2, w - 1) + 1] = color


def _line_points(p0, p1):
    """The pixels OpenCV's 8-connected line iterator visits from ``p0`` to
    ``p1``, left to right (``LineIterator``)."""
    (x0, y0), (x1, y1) = p0, p1
    if x1 < x0:
        (x0, y0), (x1, y1) = (x1, y1), (x0, y0)
    dx, dy = x1 - x0, y1 - y0
    sy = 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = x0, y0
    pts = []
    for _ in range(dx + 1):
        pts.append((x, y))
        minor = err < 0
        err += -2 * dy + (2 * dx if minor else 0)
        if vert:
            y += sy
            x += 1 if minor else 0
        else:
            x += 1
            y += sy if minor else 0
    return pts


def _cdiv(a: int, b: int) -> int:
    """C's integer division, truncating toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _clip_line(size, p1, p2):
    """OpenCV's ``clipLine`` on a (width, height) in the points' units:
    the segment clipped to the rectangle, or None outside it."""
    right, bottom = size[0] - 1, size[1] - 1
    (x1, y1), (x2, y2) = p1, p2

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return (x1, y1), (x2, y2)


def _line_fixed(img, p1, p2, color) -> None:
    """OpenCV's ``Line2``: an 8-connected line between points in 16-bit
    fixed point, clipped to the image."""
    h, w = img.shape[:2]
    one = 1 << _XY_SHIFT
    clipped = _clip_line((w << _XY_SHIFT, h << _XY_SHIFT), p1, p2)
    if clipped is None:
        return
    (x1, y1), (x2, y2) = clipped
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step, y_step = one, _cdiv(dy << _XY_SHIFT, ax | 1)
        count = (x2 - x1) >> _XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step, y_step = _cdiv(dx << _XY_SHIFT, ay | 1), one
        count = (y2 - y1) >> _XY_SHIFT
    x1 += one >> 1
    y1 += one >> 1

    def put(x, y):
        if 0 <= x < w and 0 <= y < h:
            img[y, x] = color

    put((x2 + (one >> 1)) >> _XY_SHIFT, (y2 + (one >> 1)) >> _XY_SHIFT)
    if ax > ay:
        x1 >>= _XY_SHIFT
        for _ in range(count + 1):
            put(x1, y1 >> _XY_SHIFT)
            x1 += 1
            y1 += y_step
    else:
        y1 >>= _XY_SHIFT
        for _ in range(count + 1):
            put(x1 >> _XY_SHIFT, y1)
            x1 += x_step
            y1 += 1


def _fill_convex(img, pts, color) -> None:
    """OpenCV's ``FillConvexPoly`` (8-connected) of vertices in 16-bit
    fixed point: the outline with :func:`_line_fixed`, then each scan line
    between the two edges that OpenCV walks down from the top vertex, in
    its integer steps."""
    h, w = img.shape[:2]
    n = len(pts)
    half = 1 << (_XY_SHIFT - 1)
    p0 = pts[-1]
    for p in pts:
        _line_fixed(img, p0, p, color)
        p0 = p
    xs = [p[0] for p in pts]
    ys = [p[1] for p in pts]
    imin = min(range(n), key=lambda i: (ys[i], i))
    xmin, xmax = (min(xs) + half) >> _XY_SHIFT, (max(xs) + half) >> _XY_SHIFT
    ymin, ymax = (min(ys) + half) >> _XY_SHIFT, (max(ys) + half) >> _XY_SHIFT
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edges = n
    idx = [imin, imin]
    di = [1, n - 1]
    ye = [ymin, ymin]
    ex = [-(1 << _XY_SHIFT), -(1 << _XY_SHIFT)]
    edx = [0, 0]
    y = ymin
    while True:
        for i in range(2):
            if y >= ye[i]:
                idx0 = idx[i]
                j = (idx0 + di[i]) % n
                while edges > 0:
                    edges -= 1
                    ty = (ys[j] + half) >> _XY_SHIFT
                    if ty > y:
                        ye[i] = ty
                        edx[i] = _cdiv((xs[j] - xs[idx0]) * 2 + (ty - y),
                                       2 * (ty - y))
                        ex[i] = xs[idx0]
                        idx[i] = j
                        break
                    idx0 = j
                    j = (j + di[i]) % n
                else:
                    edges -= 1
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if ex[0] > ex[1] else (0, 1)
            _hline(img, y, (ex[left] + half) >> _XY_SHIFT,
                   (ex[right] + half) >> _XY_SHIFT, color)
        ex[0] += edx[0]
        ex[1] += edx[1]
        y += 1
        if y > ymax:
            break


def line(img: np.ndarray, p0, p1, color, thickness: int = 1) -> None:
    """``cv2.line`` with the default 8-connected type, pixel for pixel:
    thickness 1 is OpenCV's line iterator; a thicker line is OpenCV's
    ``ThickLine``, a convex quad offset by half the thickness across the
    segment (its vertices in OpenCV's order, which ``FillConvexPoly``'s
    edge walk depends on), then filled round caps; both after OpenCV 5's
    clip of the segment to the image (grown by the thickness for a thick
    line)."""
    h, w = img.shape[:2]
    p0 = (int(p0[0]), int(p0[1]))
    p1 = (int(p1[0]), int(p1[1]))
    # OpenCV 5 first clips the segment (integer clipLine): a thin line to
    # the image, a thick one to the image grown by the thickness
    t = thickness if thickness > 1 else 0
    clipped = _clip_line((w + 2 * t, h + 2 * t), (p0[0] + t, p0[1] + t),
                         (p1[0] + t, p1[1] + t))
    if clipped is None:
        return
    p0, p1 = ((x - t, y - t) for x, y in clipped)
    if thickness <= 1:
        for x, y in _line_points(p0, p1):
            if 0 <= x < w and 0 <= y < h:
                img[y, x] = color
        return
    one = 1 << _XY_SHIFT
    dx, dy = p0[0] - p1[0], p1[1] - p0[1]          # OpenCV's signs
    r2 = dx * dx + dy * dy
    half = (thickness << (_XY_SHIFT - 1)) + (thickness & 1) * one * 0.5
    radius = ((thickness << (_XY_SHIFT - 1)) + (one >> 1)) >> _XY_SHIFT
    if r2:
        r = half / np.sqrt(r2)
        ox, oy = int(np.rint(dy * r)), int(np.rint(dx * r))
        a = (p0[0] * one, p0[1] * one)
        b = (p1[0] * one, p1[1] * one)
        _fill_convex(img, [(a[0] + ox, a[1] + oy), (a[0] - ox, a[1] - oy),
                           (b[0] - ox, b[1] - oy), (b[0] + ox, b[1] + oy)],
                     color)
    for c in (p0, p1):
        circle(img, c, radius, color)


def circle(img: np.ndarray, center, radius: int, color) -> None:
    """Filled ``cv2.circle(img, center, radius, color, -1)``: OpenCV's
    midpoint circle with its spans filled (``Circle`` in ``drawing.cpp``)."""
    cx, cy = int(center[0]), int(center[1])
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        _hline(img, cy - dy, cx - dx, cx + dx, color)
        _hline(img, cy + dy, cx - dx, cx + dx, color)
        _hline(img, cy - dx, cx - dy, cx + dy, color)
        _hline(img, cy + dx, cx - dy, cx + dy, color)
        dy += 1
        err += plus
        plus += 2
        mask = 0 if err <= 0 else -1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def fill_poly(img: np.ndarray, pts: np.ndarray, color) -> None:
    """``cv2.fillPoly(img, [pts], color)`` for one polygon of integer
    vertices: the outline drawn with :func:`line`, and each scan line filled
    between its edges' crossings in OpenCV's 16-bit fixed point
    (``CollectPolyEdges`` / ``FillEdgeCollection``)."""
    pts = np.asarray(pts, np.int64).reshape(-1, 2)
    n = len(pts)
    edges = []
    for i in range(n):
        p0, p1 = pts[i - 1], pts[i]
        line(img, p0, p1, color)
        if p0[1] == p1[1]:
            continue
        if p0[1] > p1[1]:
            p0, p1 = p1, p0
        x0, x1 = int(p0[0]) << _XY_SHIFT, int(p1[0]) << _XY_SHIFT
        dy = int(p1[1] - p0[1])
        step = abs(x1 - x0) // dy * (1 if x1 >= x0 else -1)  # C division
        edges.append((int(p0[1]), int(p1[1]), x0, step))
    if len(edges) < 2:
        return
    h = img.shape[0]
    y_min = max(min(e[0] for e in edges), 0)
    y_max = min(max(e[1] for e in edges), h)
    for y in range(y_min, y_max):
        xs = sorted(x0 + (y - y0) * step for y0, y1, x0, step in edges
                    if y0 <= y < y1)
        for left, right in zip(xs[::2], xs[1::2]):
            _hline(img, y, (left + (1 << _XY_SHIFT) - 1) >> _XY_SHIFT,
                   right >> _XY_SHIFT, color)


def gaussian_blur_3x3(img: np.ndarray) -> np.ndarray:
    """``cv2.GaussianBlur(img, (3, 3), 0)`` on uint8: the [1, 2, 1] / 4
    kernel both ways, reflect-101 borders, one rounding at the end (OpenCV's
    bit-exact 8-bit path)."""
    src = img.astype(np.int32)
    pad = np.pad(src, ((1, 1), (1, 1)) + ((0, 0),) * (img.ndim - 2),
                 mode='reflect')
    rows = pad[:, :-2] + 2 * pad[:, 1:-1] + pad[:, 2:]
    total = rows[:-2] + 2 * rows[1:-1] + rows[2:]
    return ((total + 8) >> 4).astype(np.uint8)


def hsv2bgr(hsv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)`` on uint8 (H in [0, 180)),
    in OpenCV's float32 arithmetic."""
    hsv = np.asarray(hsv, np.uint8)
    one = np.float32(1)
    h = hsv[..., 0].astype(np.float32) * np.float32(6 / 180)
    s = hsv[..., 1].astype(np.float32) * np.float32(1 / 255)
    v = hsv[..., 2].astype(np.float32) * np.float32(1 / 255)
    h = np.where(h >= 6, h - 6, h)
    sector = np.floor(h).astype(np.int64)
    frac = h - sector
    tab = np.stack([v, v * (one - s), v * (one - s * frac),
                    v * (one - s * (one - frac))], -1)
    order = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1],
                      [0, 2, 1], [0, 1, 3], [2, 1, 0]])[sector % 6]
    bgr = np.take_along_axis(tab, order, -1)
    bgr = np.where((s == 0)[..., None], v[..., None], bgr)
    return np.clip(np.rint(bgr * np.float32(255)), 0, 255).astype(np.uint8)



# ---- colour maps and blending (the feature heatmaps) -----------------------
# OpenCV's COLORMAP_JET, the 256 BGR entries of ``cv2.applyColorMap``'s
# table (``tests/test_torch_image_io.py`` holds it against OpenCV).
_JET = np.frombuffer(bytes.fromhex(
    '8000008400008800008c00009000009400009800009c0000a00000a40000a80000ac0000'
    'b00000b40000b80000bc0000c00000c40000c80000cc0000d00000d40000d80000dc0000'
    'e00000e40000e80000ec0000f00000f40000f80000fc0000ff0000ff0400ff0800ff0c00'
    'ff1000ff1400ff1800ff1c00ff2000ff2400ff2800ff2c00ff3000ff3400ff3800ff3c00'
    'ff4000ff4400ff4800ff4c00ff5000ff5400ff5800ff5c00ff6000ff6400ff6800ff6c00'
    'ff7000ff7400ff7800ff7c00ff8000ff8400ff8800ff8c00ff9000ff9400ff9800ff9c00'
    'ffa000ffa400ffa800ffac00ffb000ffb400ffb800ffbc00ffc000ffc400ffc800ffcc00'
    'ffd000ffd400ffd800ffdc00ffe000ffe400ffe800ffec00fff000fff400fff800fffc00'
    'feff02faff06f6ff0af2ff0eeeff12eaff16e6ff1ae2ff1edeff22daff26d6ff2ad2ff2e'
    'ceff32caff36c6ff3ac2ff3ebeff42baff46b6ff4ab2ff4eaeff52aaff56a6ff5aa2ff5e'
    '9eff629aff6696ff6a92ff6e8eff728aff7686ff7a82ff7e7eff827aff8676ff8a72ff8e'
    '6eff926aff9666ff9a62ff9e5effa25affa656ffaa52ffae4effb24affb646ffba42ffbe'
    '3effc23affc636ffca32ffce2effd22affd626ffda22ffde1effe21affe616ffea12ffee'
    '0efff20afff606fffa01fffe00fcff00f8ff00f4ff00f0ff00ecff00e8ff00e4ff00e0ff'
    '00dcff00d8ff00d4ff00d0ff00ccff00c8ff00c4ff00c0ff00bcff00b8ff00b4ff00b0ff'
    '00acff00a8ff00a4ff00a0ff009cff0098ff0094ff0090ff008cff0088ff0084ff0080ff'
    '007cff0078ff0074ff0070ff006cff0068ff0064ff0060ff005cff0058ff0054ff0050ff'
    '004cff0048ff0044ff0040ff003cff0038ff0034ff0030ff002cff0028ff0024ff0020ff'
    '001cff0018ff0014ff0010ff000cff0008ff0004ff0000ff0000fc0000f80000f40000f0'
    '0000ec0000e80000e40000e00000dc0000d80000d40000d00000cc0000c80000c40000c0'
    '0000bc0000b80000b40000b00000ac0000a80000a40000a000009c000098000094000090'
    '00008c000088000084000080'), np.uint8).reshape(256, 3)


def apply_colormap_jet(gray: np.ndarray) -> np.ndarray:
    """``cv2.applyColorMap(gray, cv2.COLORMAP_JET)``: ``(H, W)`` uint8 ->
    ``(H, W, 3)`` uint8 BGR."""
    gray = np.asarray(gray)
    if gray.dtype != np.uint8 or gray.ndim != 2:
        raise ValueError(f'apply_colormap_jet takes (H, W) uint8, got '
                         f'{gray.dtype} {gray.shape}')
    return _JET[gray]


def add_weighted(a: np.ndarray, alpha: float, b: np.ndarray, beta: float,
                 gamma: float = 0.0) -> np.ndarray:
    """``cv2.addWeighted(a, alpha, b, beta, gamma)`` for uint8 images:
    OpenCV's float32 ``fma(a, alpha, fma(b, beta, gamma))`` (each fused
    multiply-add exact in float64, then rounded to float32), rounded to
    the nearest (ties to even) and saturated to [0, 255]."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or a.dtype != np.uint8 or b.dtype != np.uint8:
        raise ValueError('add_weighted takes two uint8 images of one shape')
    f32 = np.float32
    inner = (b.astype(np.float64) * f32(beta) + f32(gamma)).astype(f32)
    out = (a.astype(np.float64) * f32(alpha) + inner).astype(f32)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)
