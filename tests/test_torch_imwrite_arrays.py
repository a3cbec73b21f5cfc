"""``utils/image_io.imwrite`` on every array ``cv2.imwrite`` takes, against
OpenCV 5.0's ``cv2.imencode``:

- for each extension the port writes, grey ``(H, W)``, BGR and BGRA arrays
  of every integer, float and bool type: the same bytes (a PNG's IHDR and
  filtered rows, whose zlib stream OpenCV's zlib writes otherwise; a Sun
  raster's last pad byte aside; a lossless WebP's decode, the port's coder
  being its own), the same types kept (16-bit PNG, PNM and
  PAM; TIFF's integers and floats; PFM's and HDR's float conversions) and
  the rest saturated to uint8 as OpenCV saturates them; the same arrays
  refused;
- the probes of OpenCV's behaviour: uint16 to JPEG, BMP, Sun raster and
  HDR read back saturated, to PNG and PPM at 16 bits and read by the high
  byte; BGRA to BMP behind a BITMAPV5HEADER; float32 to TIFF written and
  not read back; 0-d, 1-d and ``(H, W, 1)`` arrays as OpenCV takes them,
  and the shapes and types it refuses, with its reason.
"""

import struct
import zlib

import cv2
import numpy as np
import pytest

from orientedobjectdetection_torch.utils import image_io

TYPES = [np.uint8, np.int8, np.uint16, np.int16, np.int32, np.uint32,
         np.int64, np.uint64, np.float16, np.float32, np.float64, bool]
EXTS = ['.png', '.bmp', '.dib', '.jpg', '.jpeg', '.jpe', '.tif', '.tiff',
        '.pbm', '.pgm', '.ppm', '.pnm', '.pam', '.pfm', '.sr', '.ras',
        '.hdr', '.pic', '.gif', '.webp']


def seeded(shape, dtype, rng):
    """Samples across each type's range and past uint8's: negatives,
    values over 255 and 65535, floats with fractions of a half."""
    if dtype == bool:
        return rng.integers(0, 2, shape).astype(bool)
    if np.dtype(dtype).kind == 'f':
        img = rng.normal(100, 150, shape)
        flat = img.reshape(-1)
        flat[:3] = [0.5, 2.5, 254.5][:flat.size]
        return img.astype(dtype)
    info = np.iinfo(dtype)
    top = min(int(info.max), 70000)
    return rng.integers(max(int(info.min), -300), top + 1, shape
                        ).astype(dtype)


def opencv(data):
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)


def encoded(ext, img):
    try:
        ok, buf = cv2.imencode(ext, img)
    except cv2.error:
        return None
    return buf.tobytes() if ok else None


def png_rows(data):
    """A PNG's IHDR and its decompressed, filtered rows."""
    pos, ihdr, idat = 8, None, b''
    while pos < len(data):
        n, kind = struct.unpack('>I4s', data[pos:pos + 8])
        if kind == b'IHDR':
            ihdr = data[pos + 8:pos + 8 + n]
        if kind == b'IDAT':
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    return ihdr, zlib.decompress(idat)


def same_file(ext, got, want, row_bytes):
    if ext == '.webp':
        unchanged = [cv2.imdecode(np.frombuffer(d, np.uint8),
                                  cv2.IMREAD_UNCHANGED) for d in (got, want)]
        return (unchanged[0].shape == unchanged[1].shape and
                np.array_equal(*unchanged))
    if ext == '.png':
        return png_rows(got) == png_rows(want)
    if ext in ('.sr', '.ras') and row_bytes % 2:
        return len(got) == len(want) and got[:-1] == want[:-1]
    return got == want


@pytest.mark.parametrize('ext', EXTS)
def test_every_array_as_opencv_writes_it(tmp_path, ext):
    rng = np.random.default_rng(len(ext) * 31 + ord(ext[1]))
    path = str(tmp_path / f'x{ext}')
    for h, w in ((1, 1), (3, 5), (8, 9)):
        for channels in (1, 3, 4):
            for dtype in TYPES:
                shape = (h, w) if channels == 1 else (h, w, channels)
                img = seeded(shape, dtype, rng)
                want = encoded(ext, img)
                if want is None:
                    with pytest.raises(ValueError):
                        image_io.imwrite(path, img)
                    continue
                image_io.imwrite(path, img)
                with open(path, 'rb') as f:
                    got = f.read()
                assert same_file(ext, got, want, w * channels), \
                    (shape, np.dtype(dtype).name)


@pytest.mark.parametrize('ext', ['.jpg', '.bmp', '.ras', '.hdr'])
def test_uint16_saturates_to_8_bits(tmp_path, ext):
    """256 reads back as 255: JPEG, BMP and Sun raster saturate to uint8,
    HDR divides by 255 and its reader saturates."""
    img = np.array([[0, 100, 255, 256, 1000, 65535] * 2] * 2, np.uint16)
    img = np.repeat(img[..., None], 3, -1)
    image_io.imwrite(str(tmp_path / f'x{ext}'), img)
    got = image_io.imread(str(tmp_path / f'x{ext}'))
    np.testing.assert_array_equal(got, opencv(encoded(ext, img)))
    if ext != '.jpg':
        assert got[0, :6, 0].tolist() == [0, 100, 255, 255, 255, 255]


@pytest.mark.parametrize('ext', ['.png', '.ppm'])
def test_uint16_keeps_16_bits(tmp_path, ext):
    """A 16-bit file, read by the high byte."""
    img = np.array([[[0, 255, 256], [511, 4660, 65535]]], np.uint16)
    path = str(tmp_path / f'x{ext}')
    image_io.imwrite(path, img)
    with open(path, 'rb') as f:
        data = f.read()
    if ext == '.png':
        assert png_rows(data)[0] == struct.pack('>IIBBBBB', 2, 1, 16, 2, 0,
                                                0, 0)
    else:
        assert data.startswith(b'P6\n2 1\n65535\n')
    got = image_io.imread(path)
    np.testing.assert_array_equal(got, opencv(encoded(ext, img)))
    assert got.reshape(-1).tolist() == [0, 0, 1, 1, 18, 255]


def test_bgra_bmp_has_a_v5_header(tmp_path):
    img = np.random.default_rng(1).integers(0, 256, (2, 3, 4), np.uint8)
    image_io.imwrite(str(tmp_path / 'x.bmp'), img)
    data = (tmp_path / 'x.bmp').read_bytes()
    assert len(data) == 162 and data == encoded('.bmp', img)
    assert struct.unpack('<I', data[14:18])[0] == 124
    np.testing.assert_array_equal(image_io.imdecode(data), opencv(data))


@pytest.mark.parametrize('channels', [1, 3, 4])
def test_grey_and_bgra_png_colour_types(tmp_path, channels):
    """Colour types 0, 2 and 6; the port's reader reads them back as
    OpenCV does (alpha dropped)."""
    shape = (4, 6) if channels == 1 else (4, 6, channels)
    img = np.random.default_rng(channels).integers(0, 256, shape, np.uint8)
    path = str(tmp_path / 'x.png')
    image_io.imwrite(path, img)
    data = (tmp_path / 'x.png').read_bytes()
    assert png_rows(data) == png_rows(encoded('.png', img))
    assert data[25] == {1: 0, 3: 2, 4: 6}[channels]
    np.testing.assert_array_equal(image_io.imread(path), cv2.imread(path))


def test_float32_tiff_is_written_and_not_read(tmp_path):
    """OpenCV writes float32 as SampleFormat 3, uncompressed, and
    ``imdecode`` gives no image for it: the port writes the same bytes and
    its reader raises."""
    img = np.random.default_rng(2).normal(0, 1, (5, 7, 3)).astype(np.float32)
    image_io.imwrite(str(tmp_path / 'x.tif'), img)
    data = (tmp_path / 'x.tif').read_bytes()
    assert data == encoded('.tif', img)
    assert opencv(data) is None
    with pytest.raises(ValueError, match='floating-point samples: OpenCV '
                       'does not read them either'):
        image_io.imdecode(data)


@pytest.mark.parametrize('shape,as_written', [
    ((), (1, 1)), ((5,), (1, 5)), ((2, 3, 1), (2, 3))])
def test_shapes_opencv_takes(tmp_path, shape, as_written):
    img = (np.arange(int(np.prod(shape))) * 9).astype(np.uint8).reshape(
        shape)
    image_io.imwrite(str(tmp_path / 'x.png'), img)
    data = (tmp_path / 'x.png').read_bytes()
    assert png_rows(data) == png_rows(encoded('.png', img))
    assert image_io.imdecode(data).shape == as_written + (3,)


@pytest.mark.parametrize('img,reason', [
    (np.zeros((2, 3, 2), np.uint8), 'channels == 1 .. channels == 3'),
    (np.zeros((2, 3, 5), np.uint8), 'channels == 1 .. channels == 3'),
    (np.zeros((0, 3), np.uint8), 'empty'),
    (np.zeros((2, 3, 3, 1), np.uint8), 'returns False'),
    (np.zeros((2, 3), np.complex64), 'not supported')])
def test_arrays_opencv_refuses(tmp_path, img, reason):
    """``imwrite takes ...`` stays only where ``cv2.imwrite`` refuses too,
    and says what OpenCV says."""
    assert encoded('.png', img) is None
    path = tmp_path / 'x.png'
    with pytest.raises(ValueError, match=reason.replace('..', r'\|\|')):
        image_io.imwrite(str(path), img)
    assert not path.exists()
