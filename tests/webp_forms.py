"""A test-only builder of the WebP containers the tests hold the port's
reader to OpenCV on, for the layouts PIL and ``cv2.imencode`` do not
write: a VP8L bitstream (taken from a simple file either writes) wrapped
in VP8X with ICCP, EXIF, XMP or unknown chunks around it, and animations
whose first frame is offset on its canvas.

It writes what it is told and nothing more: the tests decode the same
bytes with ``cv2.imdecode`` and with the port and want equal arrays, or
both to refuse.
"""

from __future__ import annotations

import struct

ICCP, ANIMATION, EXIF, XMP, ALPHA = 0x20, 0x02, 0x08, 0x04, 0x10


def chunk(tag: bytes, data: bytes) -> bytes:
    """A RIFF chunk, padded to an even size."""
    return tag + struct.pack('<I', len(data)) + data + b'\0' * (len(data) & 1)


def riff(chunks) -> bytes:
    body = b'WEBP' + b''.join(chunks)
    return b'RIFF' + struct.pack('<I', len(body)) + body


def vp8x(flags: int, width: int, height: int) -> bytes:
    return chunk(b'VP8X', struct.pack('<I', flags) +
                 (width - 1).to_bytes(3, 'little') +
                 (height - 1).to_bytes(3, 'little'))


def image_chunk(simple: bytes) -> bytes:
    """The image chunk (VP8L or VP8) of a simple WebP file."""
    size = struct.unpack_from('<I', simple, 16)[0]
    return chunk(simple[12:16], simple[20:20 + size])


def anim(background: int = 0xff3366cc, loops: int = 0) -> bytes:
    return chunk(b'ANIM', struct.pack('<IH', background, loops))


def anmf(x: int, y: int, width: int, height: int, frame_chunks,
         duration: int = 100, flags: int = 0) -> bytes:
    """A frame at (x, y) (even numbers), of the given size."""
    return chunk(b'ANMF', (x // 2).to_bytes(3, 'little') +
                 (y // 2).to_bytes(3, 'little') +
                 (width - 1).to_bytes(3, 'little') +
                 (height - 1).to_bytes(3, 'little') +
                 duration.to_bytes(3, 'little') + bytes([flags]) +
                 b''.join(frame_chunks))


def exif(orientation: int, order: str = '<') -> bytes:
    """An EXIF chunk: a TIFF header and IFD0 of one Orientation tag."""
    mark = b'II' if order == '<' else b'MM'
    body = (mark + struct.pack(order + 'HI', 42, 8) +
            struct.pack(order + 'HHHIHH', 1, 0x0112, 3, 1, orientation, 0) +
            struct.pack(order + 'I', 0))
    return chunk(b'EXIF', body)
