"""A test-only builder of the GIF files the tests hold the port's reader to
OpenCV on, for the forms neither PIL nor ``cv2.imencode`` writes: any
logical screen, global and local colour tables of any size, frames smaller
than the screen or offset within it, interlaced rows, graphic control,
comment, plain text and application extensions in any order, and LZW code
streams of every minimum code size (2-8) with or without the leading clear
code, with clears at chosen places, with a full table left uncleared (the
"deferred clear") and with or without the end code.

It writes what it is told and nothing more: the tests decode the same
bytes with ``cv2.imdecode`` and with the port and want equal arrays, or
both to refuse.
"""

from __future__ import annotations

import struct

import numpy as np

INTERLACE = ((0, 8), (4, 8), (2, 4), (1, 2))     # first row, row step


def lzw(indices, min_code_size: int = 8, clear_first: bool = True,
        clears=(), deferred: bool = False, end: bool = True) -> bytes:
    """The LZW code stream of ``indices`` (any shape, values below
    ``2 ** min_code_size``), LSB first. A clear code leads it with
    ``clear_first``, follows the ``clears``-th data code (counted from 0),
    and follows the entry that fills the table (4095) unless ``deferred``:
    then the coder goes on at 12 bits and adds no entries. The end code
    closes it with ``end``."""
    clear = 1 << min_code_size
    codes = []
    width, nxt, table = min_code_size + 1, clear + 2, {}

    def reset():
        nonlocal width, nxt, table
        width, nxt, table = min_code_size + 1, clear + 2, {}

    if clear_first:
        codes.append((clear, width))
    clears = set(clears)
    pixels = [int(v) for v in np.asarray(indices).reshape(-1)]
    s, emitted = None, 0
    for px in pixels:
        if s is None:
            s = px
            continue
        if (s, px) in table:
            s = table[(s, px)]
            continue
        codes.append((s, width))
        if emitted in clears:
            codes.append((clear, width))
            reset()
        elif nxt < 4096:
            table[(s, px)] = nxt
            nxt += 1
            if nxt == 4096 and not deferred:
                codes.append((clear, width))
                reset()
            elif nxt > (1 << width) and width < 12:
                width += 1
        emitted += 1
        s = px
    if s is not None:
        codes.append((s, width))
    if end:
        codes.append((clear + 1, width))
    acc = n = 0
    for code, bits in codes:
        acc |= code << n
        n += bits
    return acc.to_bytes((n + 7) // 8, 'little')


def sub_blocks(data: bytes, size: int = 255, terminator: bool = True) -> bytes:
    """``data`` as data sub-blocks of ``size`` bytes (the last shorter),
    then the block terminator."""
    out = b''.join(bytes([len(data[i:i + size])]) + data[i:i + size]
                   for i in range(0, len(data), size))
    return out + (b'\0' if terminator else b'')


def table(colours: np.ndarray) -> bytes:
    """A colour table of ``colours`` ((N, 3) RGB), padded with black to the
    next power of two of at least 2 entries."""
    colours = np.asarray(colours, np.uint8).reshape(-1, 3)
    size = max(2, 1 << max(0, int(len(colours) - 1).bit_length()))
    pad = np.zeros((size, 3), np.uint8)
    pad[:len(colours)] = colours
    return pad.tobytes()


def table_bits(colours) -> int:
    """The 3-bit size field of a table of ``colours``."""
    return (len(table(colours)) // 3).bit_length() - 2


def gce(disposal: int = 0, delay: int = 0, transparent=None) -> bytes:
    """A graphic control extension."""
    flags = disposal << 2 | (transparent is not None)
    return b'\x21\xf9\x04' + struct.pack('<BHB', flags, delay,
                                         transparent or 0) + b'\0'


def comment(text: bytes) -> bytes:
    return b'\x21\xfe' + sub_blocks(text)


def plain_text(text: bytes = b'hi') -> bytes:
    return (b'\x21\x01\x0c' + struct.pack('<4H4B', 0, 0, 16, 8, 8, 8, 1, 0) +
            sub_blocks(text))


def application(ident: bytes = b'NETSCAPE2.0', data: bytes = b'\x01\0\0'
                ) -> bytes:
    return b'\x21\xff' + bytes([len(ident)]) + ident + sub_blocks(data)


def frame(indices: np.ndarray, left: int = 0, top: int = 0, local=None,
          interlace: bool = False, min_code_size: int = 8, data=None,
          flags=None, **lzw_options) -> bytes:
    """An image descriptor, its local table (``local``, (N, 3) RGB) and its
    data: ``indices`` ((h, w)) coded by :func:`lzw`, rows in the four
    interlaced passes with ``interlace``; ``data`` replaces the sub-blocks
    after the minimum code size, ``flags`` the descriptor's packed byte."""
    indices = np.asarray(indices)
    h, w = indices.shape
    if flags is None:
        flags = (0x80 | table_bits(local) if local is not None else 0) | \
            (0x40 if interlace else 0)
    rows = indices
    if interlace:
        rows = np.concatenate([indices[y0::dy] for y0, dy in INTERLACE])
    if data is None:
        data = sub_blocks(lzw(rows, min_code_size, **lzw_options))
    return (b'\x2c' + struct.pack('<4HB', left, top, w, h, flags) +
            (table(local) if local is not None else b'') +
            bytes([min_code_size]) + data)


def gif(width: int, height: int, body: bytes, colours=None,
        background: int = 0, version: bytes = b'89a',
        trailer: bool = True, flags=None) -> bytes:
    """The header, logical screen, global table (``colours``, (N, 3) RGB)
    and ``body`` (frames and extensions, in order), then the trailer."""
    if flags is None:
        flags = 0x70 | (0x80 | table_bits(colours) if colours is not None
                        else 0)
    return (b'GIF' + version + struct.pack('<2H3B', width, height, flags,
                                            background, 0) +
            (table(colours) if colours is not None else b'') + body +
            (b'\x3b' if trailer else b''))


def palette(n: int, seed: int = 0) -> np.ndarray:
    """``n`` seeded RGB colours."""
    return np.random.default_rng(seed).integers(0, 256, (n, 3), np.uint8)
