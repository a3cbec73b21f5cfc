"""The port's Sun raster and Radiance HDR codecs (``csrc/raster.cpp`` and
``utils/image_io.py``) against OpenCV 5.0:

- the Sun raster reader against ``cv2.imdecode(..., cv2.IMREAD_COLOR)`` on
  files of ``tests/raster_forms.py``: RT_OLD and RT_STANDARD at 1, 8, 24
  and 32 bits, without a colour map or with an RMT_EQUAL_RGB one (short
  maps included), rows padded to 16 bits; RT_BYTE_ENCODED (the RLE) and
  RT_FORMAT_RGB, which OpenCV 5.0's reader takes neither of, raise saying
  so;
- the HDR reader on ``#?RADIANCE`` / ``#?RGBE`` files of flat, new-style
  RLE and old-style RLE scanlines (OpenCV reads the last as flat pixels),
  and its refusals (no FORMAT line, another orientation, a bad scanline);
- ``imwrite``'s ``.ras`` / ``.sr`` and ``.hdr`` / ``.pic`` bytes against
  ``cv2.imencode``'s (a Sun raster's last pad byte aside: OpenCV writes
  whatever lies past its buffer there);
- cut and corrupt files decode to OpenCV's array or raise ``ValueError``,
  and never crash.
"""

import cv2
import numpy as np
import pytest

import raster_forms as rf
from orientedobjectdetection_torch.utils import image_io


def opencv(data):
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)


def same_as_opencv(data):
    want = opencv(data)
    assert want is not None
    got = image_io.imdecode(data)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


def encoded(ext, img):
    ok, buf = cv2.imencode(ext, img)
    return buf.tobytes() if ok else None


# ---- Sun raster: the reader -------------------------------------------------
@pytest.mark.parametrize('kind', [rf.RT_OLD, rf.RT_STANDARD])
@pytest.mark.parametrize('depth', [1, 8, 24, 32])
@pytest.mark.parametrize('w', [1, 6, 7, 13])
def test_sun_raster_reads_as_opencv(kind, depth, w):
    rng = np.random.default_rng(depth * 100 + w)
    h = 3
    shape = {1: (h, w), 8: (h, w), 24: (h, w, 3), 32: (h, w, 4)}[depth]
    pixels = rng.integers(0, 2 if depth == 1 else 256, shape)
    data = rf.sun_rows(pixels, depth)
    same_as_opencv(rf.sun(data, w, h, depth, kind))


@pytest.mark.parametrize('depth,entries', [(1, 2), (8, 256), (8, 5),
                                           (8, 1), (1, 1)])
def test_sun_raster_colour_maps(depth, entries):
    """An RMT_EQUAL_RGB map of R, G and B planes; indexes past a short map
    are black."""
    rng = np.random.default_rng(entries)
    colormap = rng.integers(0, 256, 3 * entries, np.uint8).tobytes()
    pixels = rng.integers(0, 2 if depth == 1 else 256, (4, 9))
    data = rf.sun_rows(pixels, depth)
    same_as_opencv(rf.sun(data, 9, 4, depth, maptype=rf.RMT_EQUAL_RGB,
                          colormap=colormap))


@pytest.mark.parametrize('kind,name', [
    (rf.RT_BYTE_ENCODED, 'RT_BYTE_ENCODED'),
    (rf.RT_FORMAT_RGB, 'RT_FORMAT_RGB'), (5, 'type 5')])
@pytest.mark.parametrize('depth', [8, 24])
def test_sun_raster_types_opencv_does_not_read(kind, name, depth):
    """OpenCV 5.0 reads RT_OLD and RT_STANDARD alone: its check of the RLE
    and RGB types reads a field its constructor never set."""
    rng = np.random.default_rng(depth)
    pixels = rng.integers(0, 4, (3, 8) if depth == 8 else (3, 8, 3))
    data = rf.sun_rows(pixels, depth)
    if kind == rf.RT_BYTE_ENCODED:
        data = rf.sun_rle(data)
    data = rf.sun(data, 8, 3, depth, kind)
    assert opencv(data) is None
    with pytest.raises(ValueError, match=name + '.*OpenCV does not read it '
                       'either'):
        image_io.imdecode(data)


@pytest.mark.parametrize('depth,maptype,entries', [
    (24, rf.RMT_EQUAL_RGB, 2), (8, rf.RMT_EQUAL_RGB, 0), (8, 2, 2),
    (8, rf.RMT_EQUAL_RGB, 257)])
def test_sun_raster_maps_opencv_does_not_read(depth, maptype, entries):
    colormap = bytes(3 * entries)
    data = rf.sun(bytes(64), 4, 2, depth, maptype=maptype, colormap=colormap)
    assert opencv(data) is None
    with pytest.raises(ValueError, match='OpenCV does not read it either'):
        image_io.imdecode(data)


def test_sun_raster_of_another_depth_is_refused():
    data = rf.sun(bytes(64), 4, 2, 16)
    assert opencv(data) is None
    with pytest.raises(ValueError, match='depth 16.*OpenCV does not read'):
        image_io.imdecode(data)


# ---- Sun raster: the writer -------------------------------------------------
@pytest.mark.parametrize('ext', ['.ras', '.sr'])
@pytest.mark.parametrize('channels', [1, 3, 4])
def test_sun_raster_writer_equals_opencv(tmp_path, ext, channels):
    """RT_STANDARD, no map, rows padded to 16 bits: bytes equal to
    OpenCV's but for the last row's pad byte, which OpenCV reads from past
    its buffer."""
    rng = np.random.default_rng(channels)
    path = str(tmp_path / f'x{ext}')
    for h, w in ((1, 1), (2, 3), (5, 8), (7, 13)):
        shape = (h, w) if channels == 1 else (h, w, channels)
        img = rng.integers(0, 256, shape, np.uint8)
        want = encoded(ext, img)
        image_io.imwrite(path, img)
        with open(path, 'rb') as f:
            got = f.read()
        padded = (w * channels) % 2
        assert len(got) == len(want)
        assert got[:len(got) - padded] == want[:len(want) - padded]
        header = np.frombuffer(got[:32], '>u4').tolist()
        assert header == [rf.SUN_MAGIC, w, h, 8 * channels,
                          h * (w * channels + padded), 1, 0, 0]
        np.testing.assert_array_equal(image_io.imread(path), opencv(want))


# ---- Radiance HDR: the reader -----------------------------------------------
def hdr_pixels(h, w, seed):
    """RGBE pixels of runs and noise, some black."""
    rng = np.random.default_rng(seed)
    floats = np.repeat(rng.gamma(1.0, 0.4, (h, (w + 3) // 4, 3)), 4,
                       axis=1)[:, :w]
    floats[:, ::5] = rng.gamma(1.0, 0.4, floats[:, ::5].shape)
    floats[0, :2] = 0
    return rf.rgbe(floats.astype(np.float32))


@pytest.mark.parametrize('mode', ['flat', 'rle', 'old'])
@pytest.mark.parametrize('w', [1, 7, 8, 37, 300])
def test_hdr_reads_as_opencv(mode, w):
    """New-style RLE scanlines (widths 8-32767; a narrower file is flat),
    flat pixels and old-style RLE, which OpenCV reads as flat pixels."""
    if mode == 'rle' and w < 8:
        mode = 'flat'
    data = rf.hdr(hdr_pixels(5, w, w), mode)
    want = opencv(data)
    if want is None:        # old-style runs: fewer bytes than flat pixels
        with pytest.raises(ValueError, match='ends early'):
            image_io.imdecode(data)
        return
    same_as_opencv(data)


@pytest.mark.parametrize('header', [
    b'#?RGBE\nFORMAT=32-bit_rle_rgbe\n\n',
    b'#?RADIANCE\n# made by hand\nEXPOSURE=1.0\nFORMAT=32-bit_rle_rgbe\n\n',
    b'#?RADIANCEXYZ\nGAMMA=2.2\nFORMAT=32-bit_rle_rgbe\n\n'])
def test_hdr_header_lines(header):
    same_as_opencv(rf.hdr(hdr_pixels(3, 9, 1), 'rle', header=header))


@pytest.mark.parametrize('header,size', [
    (b'#?RADIANCE\n\n', None),
    (b'#?RADIANCE\nFORMAT=32-bit_rle_xyze\n\n', None),
    (b'#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n', None),
    (None, b'+Y 3 +X 9\n'), (None, b'-Y 3 -X 9\n'), (None, b'+X 9 -Y 3\n')])
def test_hdr_refusals(header, size):
    data = rf.hdr(hdr_pixels(3, 9, 2), 'rle', header=header, size=size)
    assert opencv(data) is None
    with pytest.raises(ValueError, match='OpenCV does not read it either'):
        image_io.imdecode(data)


def test_hdr_bad_scanlines_are_refused():
    good = rf.hdr(hdr_pixels(2, 16, 3), 'rle')
    at = good.index(b'-Y 2 +X 16\n') + len(b'-Y 2 +X 16\n')
    wide = good[:at] + b'\x02\x02\x00\x11' + good[at + 4:]   # width 17
    zero = good[:at + 4] + b'\x00' + good[at + 5:]           # a 0 count
    for data in (wide, zero):
        assert opencv(data) is None
        with pytest.raises(ValueError, match='OpenCV does not read it '
                           'either'):
            image_io.imdecode(data)


# ---- Radiance HDR: the writer -----------------------------------------------
@pytest.mark.parametrize('ext', ['.hdr', '.pic'])
@pytest.mark.parametrize('w', [1, 7, 8, 9, 130, 300])
def test_hdr_writer_equals_opencv(tmp_path, ext, w):
    """RGBE_WritePixels_RLE's bytes (flat under 8 pixels a row): float32
    BGR and grey, values over 1, black and runs included."""
    rng = np.random.default_rng(w)
    path = str(tmp_path / f'x{ext}')
    floats = np.repeat(rng.gamma(1.0, 0.5, (4, (w + 5) // 6, 3)), 6,
                       axis=1)[:, :w].astype(np.float32)
    floats[0, 0] = 0
    floats[1, :3] = [5.0, 0.25, 1e-20]
    for img in (floats, floats[..., 1].copy()):
        want = encoded(ext, img)
        image_io.imwrite(path, img)
        with open(path, 'rb') as f:
            assert f.read() == want
        np.testing.assert_array_equal(image_io.imread(path), opencv(want))


def test_hdr_writer_past_32767_pixels_a_row(tmp_path):
    img = np.random.default_rng(0).uniform(0, 2, (2, 32768, 3)).astype(
        np.float32)
    image_io.imwrite(str(tmp_path / 'x.hdr'), img)
    assert (tmp_path / 'x.hdr').read_bytes() == encoded('.hdr', img)


def test_hdr_round_trip_scales_by_255(tmp_path):
    """Floats read back times 255, saturated: (0, .5, 1), (2, -1, .004)
    give 0 128 255 / 255 255 0 as BGR (a negative's exponent is the
    largest channel's)."""
    img = np.array([[[0, .5, 1], [2, -1, .004]]], np.float32)
    image_io.imwrite(str(tmp_path / 'x.hdr'), img)
    data = (tmp_path / 'x.hdr').read_bytes()
    assert data == encoded('.hdr', img)
    assert data.startswith(b'#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n'
                           b'-Y 1 +X 2\n')
    assert same_as_opencv(data).reshape(-1).tolist() == [0, 128, 255, 255,
                                                          255, 0]


@pytest.mark.parametrize('img', [np.zeros((2, 3, 4), np.float32),
                                 np.zeros((2, 3, 2), np.float32)])
def test_hdr_writer_refuses_as_opencv(tmp_path, img):
    try:
        refused = encoded('.hdr', img) is None
    except cv2.error:
        refused = True
    assert refused
    with pytest.raises(ValueError):
        image_io.imwrite(str(tmp_path / 'x.hdr'), img)
    assert not (tmp_path / 'x.hdr').exists()


# ---- robustness -------------------------------------------------------------
def test_cut_and_corrupt_files_raise_and_never_crash():
    rng = np.random.default_rng(7)
    pixels = rng.integers(0, 256, (5, 12, 3))
    files = [rf.sun(rf.sun_rows(pixels, 24), 12, 5, 24),
             rf.sun(rf.sun_rows(pixels[..., 0], 8), 12, 5, 8,
                    maptype=rf.RMT_EQUAL_RGB, colormap=bytes(range(60))),
             rf.hdr(hdr_pixels(5, 12, 4), 'rle'),
             rf.hdr(hdr_pixels(5, 12, 4), 'flat'),
             rf.hdr(hdr_pixels(3, 5, 4), 'flat')]
    raised = 0
    for data in files:
        for trial in range(40):
            bad = bytearray(data[:rng.integers(1, len(data))] if trial < 15
                            else data)
            if trial >= 15:
                for at in rng.integers(0, len(bad), rng.integers(1, 6)):
                    bad[at] = rng.integers(0, 256)
            try:
                got = image_io.imdecode(bytes(bad))
            except ValueError:
                raised += 1
                continue
            want = opencv(bytes(bad))
            assert want is not None
            np.testing.assert_array_equal(got, want)
    assert raised > 60
