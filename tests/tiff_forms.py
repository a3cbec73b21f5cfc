"""A test-only TIFF builder for the forms the tests hold the port's reader
to OpenCV on: any sample depth and photometric interpretation, strips or
tiles, PlanarConfiguration 1 or 2, compression none, LZW (and old-style,
LSB-first LZW), PackBits or deflate, Predictor 2, FillOrder 2, either byte
order, classic TIFF or BigTIFF, more pages after the first, and any extra
tags (Orientation, ExtraSamples, ColorMap, YCbCrSubSampling,
ReferenceBlackWhite, InkSet, SampleFormat, ...); and the strip or tile
data of CCITT RLE, RLEW, T.4 and T.6 (:func:`ccitt`) and of SGILog LogL /
LogLuv (:func:`logl`, :func:`logluv32`, :func:`logluv24`), and a copy of
another writer's file with tags changed (:func:`retag`).

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


def compress(raw: bytes, compression: int, old_lzw=False) -> bytes:
    if compression == 1:
        return raw
    if compression == 5:
        return lzw_lsb(raw) if old_lzw else lzw(raw)
    if compression == 32773:
        return packbits(raw)
    if compression in (8, 32946):
        return zlib.compress(raw, 6)
    return raw          # another scheme's tag on raw bytes: refusal tests


def encode_blocks(samples, bps, *, planar=1, tile=None, rows_per_strip=None,
                  compression=1, predictor=1, order='<', old_lzw=False,
                  fill_order=1):
    """(H, W, spp) samples -> the strips' or tiles' bytes, planes after
    one another when planar is 2 (``old_lzw``: :func:`lzw_lsb` for LZW;
    ``fill_order`` 2: each byte's bits reversed)."""
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
        data = compress(pack_rows(rows, bps, order), compression, old_lzw)
        out.append(reverse_bits(data) if fill_order == 2 else data)
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
    old_lzw = kwargs.pop('old_lzw', False)
    fill_order = kwargs.pop('fill_order', 1)
    blocks = encode_blocks(samples, bps, old_lzw=old_lzw,
                           fill_order=fill_order, **block_args)
    if fill_order != 1:
        kwargs['tags'] = {266: (SHORT, [fill_order]), **kwargs.get('tags',
                                                                   {})}
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


# ---- FillOrder 2, old-style LZW ---------------------------------------------
_REVERSED = bytes(int(f'{b:08b}'[::-1], 2) for b in range(256))


def reverse_bits(data: bytes) -> bytes:
    """Each byte's bits reversed: what FillOrder 2 stores."""
    return bytes(data).translate(_REVERSED)


def lzw_lsb(data: bytes) -> bytes:
    """Old-style TIFF LZW: LSB-first codes, the code width raised one code
    later than in :func:`lzw` (what readers built with ``LZW_COMPAT``
    decode)."""
    out, acc, nacc = bytearray(), 0, 0
    nbits = 9

    def put(code):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += nbits
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8

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
        elif nxt > (1 << nbits) and nbits < 12:
            nbits += 1
        w = bytes([b])
    if w:
        put(table[w])
        nxt += 1
        if nxt > (1 << nbits) and nbits < 12:
            nbits += 1
    put(257)
    if nacc:
        out.append(acc & 0xFF)
    return bytes(out)


# ---- CCITT (T.4 / T.6) ------------------------------------------------------
def _codes(text):
    """'run:bits run:bits ...' -> {run: bits}."""
    return {int(r): c for r, c in (p.split(':') for p in text.split())}


_WHITE = _codes("""
0:00110101 1:000111 2:0111 3:1000 4:1011 5:1100 6:1110 7:1111 8:10011
9:10100 10:00111 11:01000 12:001000 13:000011 14:110100 15:110101
16:101010 17:101011 18:0100111 19:0001100 20:0001000 21:0010111
22:0000011 23:0000100 24:0101000 25:0101011 26:0010011 27:0100100
28:0011000 29:00000010 30:00000011 31:00011010 32:00011011 33:00010010
34:00010011 35:00010100 36:00010101 37:00010110 38:00010111 39:00101000
40:00101001 41:00101010 42:00101011 43:00101100 44:00101101 45:00000100
46:00000101 47:00001010 48:00001011 49:01010010 50:01010011 51:01010100
52:01010101 53:00100100 54:00100101 55:01011000 56:01011001 57:01011010
58:01011011 59:01001010 60:01001011 61:00110010 62:00110011 63:00110100
64:11011 128:10010 192:010111 256:0110111 320:00110110 384:00110111
448:01100100 512:01100101 576:01101000 640:01100111 704:011001100
768:011001101 832:011010010 896:011010011 960:011010100 1024:011010101
1088:011010110 1152:011010111 1216:011011000 1280:011011001
1344:011011010 1408:011011011 1472:010011000 1536:010011001
1600:010011010 1664:011000 1728:010011011""")
_BLACK = _codes("""
0:0000110111 1:010 2:11 3:10 4:011 5:0011 6:0010 7:00011 8:000101
9:000100 10:0000100 11:0000101 12:0000111 13:00000100 14:00000111
15:000011000 16:0000010111 17:0000011000 18:0000001000 19:00001100111
20:00001101000 21:00001101100 22:00000110111 23:00000101000
24:00000010111 25:00000011000 26:000011001010 27:000011001011
28:000011001100 29:000011001101 30:000001101000 31:000001101001
32:000001101010 33:000001101011 34:000011010010 35:000011010011
36:000011010100 37:000011010101 38:000011010110 39:000011010111
40:000001101100 41:000001101101 42:000011011010 43:000011011011
44:000001010100 45:000001010101 46:000001010110 47:000001010111
48:000001100100 49:000001100101 50:000001010010 51:000001010011
52:000000100100 53:000000110111 54:000000111000 55:000000100111
56:000000101000 57:000001011000 58:000001011001 59:000000101011
60:000000101100 61:000001011010 62:000001100110 63:000001100111
64:0000001111 128:000011001000 192:000011001001 256:000001011011
320:000000110011 384:000000110100 448:000000110101 512:0000001101100
576:0000001101101 640:0000001001010 704:0000001001011 768:0000001001100
832:0000001001101 896:0000001110010 960:0000001110011
1024:0000001110100 1088:0000001110101 1152:0000001110110
1216:0000001110111 1280:0000001010010 1344:0000001010011
1408:0000001010100 1472:0000001010101 1536:0000001011010
1600:0000001011011 1664:0000001100100 1728:0000001100101""")
_EXTENDED = _codes("""
1792:00000001000 1856:00000001100 1920:00000001101 1984:000000010010
2048:000000010011 2112:000000010100 2176:000000010101 2240:000000010110
2304:000000010111 2368:000000011100 2432:000000011101 2496:000000011110
2560:000000011111""")
_WHITE.update(_EXTENDED)
_BLACK.update(_EXTENDED)
_EOL = '000000000001'
_PASS, _HORIZ = '0001', '001'
_VERTICAL = {-3: '0000011', -2: '000011', -1: '011', 0: '1', 1: '010',
             2: '000010', 3: '0000010'}          # key: b1 - a1


class _Bits:
    def __init__(self):
        self.bits = []

    def put(self, code):
        self.bits.extend(int(c) for c in code)

    def align(self, unit):
        self.bits.extend([0] * (-len(self.bits) % unit))

    def span(self, run, black):
        table = _BLACK if black else _WHITE
        while run >= 2624:
            self.put(table[2560])
            run -= 2560
        if run >= 64:
            self.put(table[run // 64 * 64])
            run -= run // 64 * 64
        self.put(table[run])

    def tobytes(self):
        self.align(8)
        return bytes(int(''.join(map(str, self.bits[i:i + 8])), 2)
                     for i in range(0, len(self.bits), 8))


def _diff(row, start, color):
    """The first x >= start where row[x] != color, or the width."""
    x = start
    while x < len(row) and row[x] == color:
        x += 1
    return x


def _row_1d(out, row):
    x, black = 0, False
    while x < len(row):
        end = _diff(row, x, int(black))
        out.span(end - x, black)
        x, black = end, not black


def _row_2d(out, row, ref):
    """tif_fax3.c's Fax3Encode2DRow."""
    w = len(row)
    px = lambda r, x: r[x] if x < w else 0        # noqa: E731
    a0 = 0
    a1 = 0 if row[0] else _diff(row, 0, 0)
    b1 = 0 if ref[0] else _diff(ref, 0, 0)
    while True:
        b2 = _diff(ref, b1, px(ref, b1)) if b1 < w else w
        if b2 >= a1:
            d = b1 - a1
            if -3 <= d <= 3:
                out.put(_VERTICAL[d])
                a0 = a1
            else:
                a2 = _diff(row, a1, px(row, a1)) if a1 < w else w
                out.put(_HORIZ)
                first_black = not (a0 + a1 == 0 or px(row, a0) == 0)
                out.span(a1 - a0, first_black)
                out.span(a2 - a1, not first_black)
                a0 = a2
        else:
            out.put(_PASS)
            a0 = b2
        if a0 >= w:
            break
        a1 = _diff(row, a0, px(row, a0))
        b1 = _diff(ref, a0, 1 - px(row, a0))
        b1 = _diff(ref, b1, px(row, a0))


def ccitt(bits, compression, *, two_d=False, fill_bits=False, k=3):
    """(rows, width) 0 / 1 pixels (1 = black: the codes' black runs) -> one
    strip's or tile's CCITT data: RLE (2: Modified Huffman, rows byte
    aligned), RLEW (32771: rows 16-bit aligned), T.4 (3: an EOL before
    each row, 1-D or, with ``two_d``, every ``k``-th row 1-D and the others
    2-D with a tag bit; ``fill_bits`` ends each EOL on a byte) or T.6 (4:
    2-D, EOFB at the end)."""
    bits = np.asarray(bits, np.int64)
    out = _Bits()
    ref = [0] * bits.shape[1]
    for y, row in enumerate(bits.tolist()):
        if compression == 3:
            if fill_bits:
                out.bits.extend([0] * ((4 - len(out.bits)) % 8))
            out.put(_EOL)
            if two_d:
                out.put('1' if y % k == 0 else '0')
            if two_d and y % k:
                _row_2d(out, row, ref)
            else:
                _row_1d(out, row)
        elif compression == 4:
            _row_2d(out, row, ref)
        else:
            _row_1d(out, row)
            out.align(8 if compression == 2 else 16)
        ref = row
    if compression == 3:
        for _ in range(6):                                   # RTC
            out.put(_EOL + ('1' if two_d else ''))
    elif compression == 4:
        out.put(_EOL + _EOL)                                 # EOFB
    return out.tobytes()


# ---- SGILog (LogL and LogLuv, tif_luv.c) ------------------------------------
# 34676 run-length codes each row's byte planes, the high plane first (two
# planes for LogL16, four for LogLuv32); 34677 stores LogLuv24's 3 bytes a
# pixel.
def _rle_plane(values) -> bytes:
    """One byte plane of a row: runs of 2-129 equal bytes as 126 + run,
    value; the rest as literals of at most 127."""
    out, i, n = bytearray(), 0, len(values)
    lit = []

    def flush():
        while lit:
            part = lit[:127]
            del lit[:127]
            out.append(len(part))
            out.extend(part)

    while i < n:
        j = i
        while j < n and j - i < 129 and values[j] == values[i]:
            j += 1
        if j - i >= 3:
            flush()
            out += bytes([126 + j - i, values[i]])
            i = j
        else:
            lit.append(values[i])
            i += 1
    flush()
    return bytes(out)


def logluv24(samples) -> bytes:
    """(rows, width) LogLuv24 pixels -> 34677 data (3 bytes a pixel, the
    high byte first)."""
    return b''.join(bytes([(v >> 16) & 255, (v >> 8) & 255, v & 255])
                    for v in np.asarray(samples, np.int64).reshape(-1)
                    .tolist())


def _sgilog_rows(samples, planes):
    out = bytearray()
    for row in samples.tolist():
        for k in range(planes - 1, -1, -1):
            out += _rle_plane([(v >> (8 * k)) & 255 for v in row])
    return bytes(out)


def logl(samples) -> bytes:
    """(rows, width) LogL16 pixels -> 34676 data (two byte planes)."""
    return _sgilog_rows(np.asarray(samples, np.int64), 2)


def logluv32(samples) -> bytes:
    """(rows, width) LogLuv32 pixels -> 34676 data (four byte planes)."""
    return _sgilog_rows(np.asarray(samples, np.int64), 4)


def retag(data: bytes, tags: dict, transform=None) -> bytes:
    """A classic TIFF's first page written again by :func:`build` with
    ``tags`` added or replaced, each strip or tile passed through
    ``transform`` (bytes -> bytes) when given."""
    order = '<' if data[:2] == b'II' else '>'
    at = struct.unpack_from(order + 'I', data, 4)[0]
    n = struct.unpack_from(order + 'H', data, at)[0]
    entries = {}
    for i in range(n):
        tag, typ, count = struct.unpack_from(order + 'HHI', data,
                                             at + 2 + 12 * i)
        size = _SIZES[typ] * count
        vat = at + 10 + 12 * i
        if size > 4:
            vat = struct.unpack_from(order + 'I', data, vat)[0]
        if typ == RATIONAL:
            values = [struct.unpack_from(order + 'II', data, vat + 8 * k)
                      for k in range(count)]
        elif typ == UNDEFINED:
            values = list(data[vat:vat + count])
        else:
            values = list(struct.unpack_from(
                order + _FORMATS[typ] * count, data, vat))
        entries[tag] = (typ, values)
    tiled = 324 in entries
    offsets = entries.pop(324 if tiled else 273)[1]
    counts = entries.pop(325 if tiled else 279)[1]
    blocks = [data[o:o + c] for o, c in zip(offsets, counts)]
    if transform:
        blocks = [transform(b) for b in blocks]
    w, h = entries[256][1][0], entries[257][1][0]
    spp = entries.get(277, (SHORT, [1]))[1][0]
    bps = entries.get(258, (SHORT, [1]))[1][0]
    entries.update(tags)
    tile = (entries[322][1][0], entries[323][1][0]) if tiled else None
    return build(blocks, h, w, bps, spp, entries[262][1][0], tile=tile,
                 rows_per_strip=None if tiled else entries[278][1][0],
                 order=order, tags=entries)
