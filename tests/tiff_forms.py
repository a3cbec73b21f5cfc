"""A test-only TIFF builder for the forms the tests hold the port's reader
to OpenCV on: any sample depth and photometric interpretation, strips or
tiles, PlanarConfiguration 1 or 2, compression none, LZW, PackBits or
deflate, Predictor 2, either byte order, classic TIFF or BigTIFF, more pages
after the first, and any extra tags (Orientation, ExtraSamples, ColorMap,
YCbCrSubSampling, ReferenceBlackWhite, InkSet, SampleFormat, ...).

It writes valid files and nothing more: the tests decode the same bytes
with ``cv2.imdecode`` and with the port and want equal arrays.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SHORT, LONG, RATIONAL, UNDEFINED, LONG8 = 3, 4, 5, 7, 16
_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 7: 1, 16: 8}
_FORMATS = {1: 'B', 2: 'B', 3: 'H', 4: 'I', 7: 'B', 16: 'Q'}


def lzw(data: bytes) -> bytes:
    """TIFF LZW (MSB-first codes, the code width raised one code early)."""
    out, acc, nacc = bytearray(), 0, 0
    nbits = 9

    def put(code):
        nonlocal acc, nacc
        acc = acc << nbits | code
        nacc += nbits
        while nacc >= 8:
            nacc -= 8
            out.append(acc >> nacc & 0xFF)

    def fresh():
        return {bytes([i]): i for i in range(256)}

    table, nxt = fresh(), 258
    put(256)
    w = b''
    for b in data:
        wc = w + bytes([b])
        if wc in table:
            w = wc
            continue
        put(table[w])
        table[wc] = nxt
        nxt += 1
        if nxt == 4094:
            put(256)
            table, nxt, nbits = fresh(), 258, 9
        elif nxt > (1 << nbits) - 1:
            nbits += 1
        w = bytes([b])
    if w:
        put(table[w])
        nxt += 1
        if nxt > (1 << nbits) - 1 and nbits < 12:
            nbits += 1
    put(257)
    if nacc:
        out.append(acc << (8 - nacc) & 0xFF)
    return bytes(out)


def packbits(data: bytes) -> bytes:
    """PackBits: runs of 3 or more repeated, the rest literal, <= 128."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out += bytes([(257 - (j - i)) & 0xFF, data[i]])
            i = j
            continue
        j = i
        while j < n and j - i < 128 and not (
                j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def pack_rows(samples: np.ndarray, bps: int, order: str) -> bytes:
    """(rows, width * lanes) integer samples -> rows of bps bits each, every
    row starting on a byte."""
    samples = np.asarray(samples, np.int64)
    if bps == 8:
        return samples.astype(np.uint8).tobytes()
    if bps == 16:
        return samples.astype(order + 'u2').tobytes()
    rows = []
    per = 8 // bps
    for row in samples:
        row = list(row) + [0] * (-len(row) % per)
        packed = bytes(sum(int(v) << (8 - bps * (k + 1))
                           for k, v in enumerate(row[i:i + per]))
                       for i in range(0, len(row), per))
        rows.append(packed)
    return b''.join(rows)


def predict(samples: np.ndarray, lanes: int, bps: int) -> np.ndarray:
    """Predictor 2 on (rows, width * lanes) samples."""
    s = np.asarray(samples, np.int64)
    out = s.copy()
    out[:, lanes:] = s[:, lanes:] - s[:, :-lanes]
    return out % (1 << bps)


def compress(raw: bytes, compression: int) -> bytes:
    if compression == 1:
        return raw
    if compression == 5:
        return lzw(raw)
    if compression == 32773:
        return packbits(raw)
    if compression in (8, 32946):
        return zlib.compress(raw, 6)
    return raw          # another scheme's tag on raw bytes: refusal tests


def encode_blocks(samples, bps, *, planar=1, tile=None, rows_per_strip=None,
                  compression=1, predictor=1, order='<'):
    """(H, W, spp) samples -> the strips' or tiles' bytes, planes after
    one another when planar is 2."""
    samples = np.asarray(samples, np.int64)
    h, w, spp = samples.shape
    planes = [samples] if planar == 1 else [samples[..., c:c + 1]
                                            for c in range(spp)]
    blocks = []
    for plane in planes:
        lanes = plane.shape[2]
        if tile:
            tw, th = tile
            for ty in range(0, h, th):
                for tx in range(0, w, tw):
                    block = np.zeros((th, tw, lanes), np.int64)
                    part = plane[ty:ty + th, tx:tx + tw]
                    block[:part.shape[0], :part.shape[1]] = part
                    blocks.append(block)
        else:
            rps = rows_per_strip or h
            for y in range(0, h, rps):
                blocks.append(plane[y:y + rps])
    out = []
    for block in blocks:
        rows = block.reshape(block.shape[0], -1)
        if predictor == 2:
            rows = predict(rows, block.shape[2], bps)
        out.append(compress(pack_rows(rows, bps, order), compression))
    return out


def build(blocks, h, w, bps, spp, photometric, *, tile=None,
          rows_per_strip=None, planar=1, compression=1, predictor=1,
          order='<', big=False, tags=None, pages=1):
    """A TIFF of ``blocks`` (the strips' or tiles' bytes) and the tags;
    ``tags`` maps a tag to (type, values) and adds or replaces. ``pages``
    repeats the page (each later page's IFD chained after the first)."""
    entries = {256: (LONG, [w]), 257: (LONG, [h]),
               258: (SHORT, [bps] * spp), 259: (SHORT, [compression]),
               262: (SHORT, [photometric]), 277: (SHORT, [spp]),
               284: (SHORT, [planar])}
    if predictor != 1:
        entries[317] = (SHORT, [predictor])
    if tile:
        entries[322] = (LONG, [tile[0]])
        entries[323] = (LONG, [tile[1]])
    else:
        entries[278] = (LONG, [rows_per_strip or h])
    entries.update(tags or {})
    head = 16 if big else 8
    data = bytearray()
    offsets, counts = [], []
    for block in blocks:
        offsets.append(head + len(data))
        counts.append(len(block))
        data += block
        if len(data) % 2:
            data += b'\x00'
    off_type = LONG8 if big else LONG
    entries[324 if tile else 273] = (off_type, offsets)
    entries[325 if tile else 279] = (off_type, counts)
    if big:
        magic = struct.pack(order + '2sHHHQ', b'II' if order == '<' else b'MM',
                            43, 8, 0, 0)
    else:
        magic = struct.pack(order + '2sHI', b'II' if order == '<' else b'MM',
                            42, 0)
    out = bytearray(magic) + data
    ifds = []
    for _ in range(pages):
        ifds.append(len(out))
        out += _ifd(entries, order, big, len(out))
    # chain the pages: each IFD's next pointer
    for i, at in enumerate(ifds):
        nxt = ifds[i + 1] if i + 1 < len(ifds) else 0
        n = len(entries)
        pointer = at + (8 + 20 * n if big else 2 + 12 * n)
        struct.pack_into(order + ('Q' if big else 'I'), out, pointer, nxt)
    struct.pack_into(order + ('Q' if big else 'I'), out, 8 if big else 4,
                     ifds[0])
    return bytes(out)


def _ifd(entries, order, big, at):
    n = len(entries)
    inline = 8 if big else 4
    size = (8 + 20 * n + 8) if big else (2 + 12 * n + 4)
    extra = bytearray()
    body = bytearray(struct.pack(order + ('Q' if big else 'H'), n))
    for tag in sorted(entries):
        typ, values = entries[tag]
        if typ == RATIONAL:
            raw = b''.join(struct.pack(order + 'II', *v) for v in values)
            count = len(values)
        elif typ == UNDEFINED:
            raw = bytes(values)
            count = len(raw)
        else:
            raw = struct.pack(order + _FORMATS[typ] * len(values), *values)
            count = len(values)
        body += struct.pack(order + ('HHQ' if big else 'HHI'), tag, typ,
                            count)
        if len(raw) <= inline:
            body += raw + b'\x00' * (inline - len(raw))
        else:
            body += struct.pack(order + ('Q' if big else 'I'),
                                at + size + len(extra))
            extra += raw
            if len(extra) % 2:
                extra += b'\x00'
    body += b'\x00' * (8 if big else 4)              # the next IFD
    return bytes(body + extra)


def tiff(samples, bps, photometric, **kwargs):
    """(H, W, spp) samples -> a TIFF (see :func:`encode_blocks` and
    :func:`build`)."""
    samples = np.asarray(samples, np.int64)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, spp = samples.shape
    block_args = {k: kwargs[k] for k in ('planar', 'tile', 'rows_per_strip',
                                         'compression', 'predictor', 'order')
                  if k in kwargs}
    blocks = encode_blocks(samples, bps, **block_args)
    return build(blocks, h, w, bps, spp, photometric, **kwargs)


def ycbcr_units(y, cb, cr, sub_h, sub_v):
    """Y (H, W) and Cb, Cr (ceil(H / sub_v), ceil(W / sub_h)) -> the
    uncompressed YCbCr data units of one strip, as bytes."""
    h, w = y.shape
    ud, ua = -(-h // sub_v), -(-w // sub_h)
    yp = np.zeros((ud * sub_v, ua * sub_h), np.int64)
    yp[:h, :w] = y
    out = bytearray()
    for uy in range(ud):
        for ux in range(ua):
            out += bytes(int(v) for v in yp[uy * sub_v:(uy + 1) * sub_v,
                                            ux * sub_h:(ux + 1) * sub_h]
                         .reshape(-1))
            out += bytes([int(cb[uy, ux]), int(cr[uy, ux])])
    return bytes(out)
