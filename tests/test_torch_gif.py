"""The port's GIF codec (``csrc/gif.cpp`` through ``native.py`` and
``utils/image_io.py``) against OpenCV 5.0's own GIF codec on the CPU:

- the reader on seeded sweeps of built files (``tests/gif_forms.py``):
  logical screens larger than the image, offsets, global and local tables
  of every size, interlaced rows, graphic control extensions of every
  disposal with and without a transparent index, comments, plain text and
  application extensions, LZW of minimum code sizes 2-11 with and
  without clear and end codes, a full table left uncleared, GIF87a; PIL's
  files (animated, transparent, interlaced); and each named form and
  refusal: every decode equal to ``cv2.imdecode(IMREAD_COLOR)``'s array, or
  both refusing;
- the reader on files cut short and bytes overwritten: the same, and
  never a crash;
- the writer: ``cv2.imencode('.gif')``'s bytes for BGR and BGRA arrays of
  seeded sizes from 1 x 1 to 1024^2, transparent pixels among them, and
  for the other types OpenCV saturates to uint8; its refusals with
  OpenCV's reason.
"""

import io

import cv2
import numpy as np
import pytest
from PIL import Image

import gif_forms as gf
from orientedobjectdetection_torch import native
from orientedobjectdetection_torch.utils import image_io

cv2.utils.logging.setLogLevel(cv2.utils.logging.LOG_LEVEL_SILENT)


def opencv(data):
    """``cv2.imdecode(IMREAD_COLOR)``, None where it gives no image."""
    try:
        return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    except cv2.error:
        return None


def port(data):
    try:
        return image_io.imdecode(data)
    except ValueError:
        return None


def same_as_opencv(data) -> bool:
    """The port decodes ``data`` to OpenCV's array, or both refuse."""
    want, got = opencv(data), port(data)
    if want is None or got is None:
        return want is None and got is None
    return np.array_equal(want, got)


def seeded_gif(seed) -> bytes:
    """A seeded GIF of the forms OpenCV reads: screen, offset, tables,
    extensions, interlacing and LZW options drawn at random."""
    rng = np.random.default_rng(seed)
    sw, sh = (int(v) for v in rng.integers(1, 40, 2))
    fw, fh = int(rng.integers(1, sw + 1)), int(rng.integers(1, sh + 1))
    left = int(rng.integers(0, sw - fw + 1))
    top = int(rng.integers(0, sh - fh + 1))
    mcs = int(rng.integers(2, 9))
    colours = gf.palette(1 << int(rng.integers(1, 9)), seed) \
        if rng.random() < 0.8 else None
    local = gf.palette(1 << int(rng.integers(1, 9)), seed + 1) \
        if rng.random() < 0.4 else None
    tables = [len(t) for t in (colours, local) if t is not None]
    limit = min(max(tables, default=256), 1 << mcs)
    idx = rng.integers(0, limit, (fh, fw))
    if rng.random() < 0.2:
        idx = np.minimum(idx, 2)                    # long runs, KwKwK codes
    body = b''
    if rng.random() < 0.3:
        body += gf.comment(b'c' * int(rng.integers(0, 300)))
    if rng.random() < 0.3:
        body += gf.application()
    if rng.random() < 0.2:
        body += gf.plain_text()
    if rng.random() < 0.7:
        transparent = int(rng.integers(0, limit)) if rng.random() < 0.5 \
            else None
        body += gf.gce(int(rng.integers(0, 4)), int(rng.integers(0, 100)),
                       transparent)
    options = dict(clear_first=rng.random() < 0.8, end=rng.random() < 0.8,
                   deferred=rng.random() < 0.3)
    if rng.random() < 0.3:
        options['clears'] = tuple(int(v) for v in rng.integers(0, 50, 3))
    body += gf.frame(idx, left, top, local=local,
                     interlace=rng.random() < 0.3, min_code_size=mcs,
                     **options)
    if rng.random() < 0.3:
        body += gf.frame(idx[::-1], left, top, min_code_size=mcs)
    background = int(rng.integers(0, len(colours))) \
        if colours is not None and rng.random() < 0.9 else \
        int(rng.integers(0, 256))
    return gf.gif(sw, sh, body, colours, background=background,
                  version=b'87a' if rng.random() < 0.2 else b'89a')


@pytest.mark.parametrize('chunk', range(8))
def test_reader_equals_opencv_on_seeded_gifs(chunk):
    decoded = 0
    for seed in range(40 * chunk, 40 * chunk + 40):
        data = seeded_gif(seed)
        assert same_as_opencv(data), seed
        decoded += opencv(data) is not None
    assert decoded >= 30


@pytest.mark.parametrize('chunk', range(4))
def test_reader_on_cut_and_overwritten_files(chunk):
    """Files cut short, with bytes overwritten or inserted: OpenCV's array
    or a ValueError where OpenCV gives none, never a crash."""
    rng = np.random.default_rng(100 + chunk)
    for i in range(300):
        data = bytearray(seeded_gif(int(rng.integers(0, 320))))
        kind = rng.random()
        if kind < 0.3:
            data = data[:int(rng.integers(0, len(data)))]
        elif kind < 0.8:
            for _ in range(int(rng.integers(1, 4))):
                data[int(rng.integers(0, len(data)))] = int(
                    rng.integers(0, 256))
        else:
            at = int(rng.integers(13, len(data)))
            data[at:at] = bytes(rng.integers(0, 256, int(rng.integers(1, 5)),
                                             np.uint8))
        assert same_as_opencv(bytes(data)), (chunk, i)


PAL = gf.palette(16, 1)
IDX = np.random.default_rng(0).integers(0, 16, (6, 7))
IDX[0, :3] = 3


def frame(**kwargs):
    kwargs.setdefault('min_code_size', 4)
    return gf.frame(kwargs.pop('idx', IDX), **kwargs)


NAMED = {
    'interlaced 1-9 rows': [gf.gif(3, h, gf.frame(
        np.random.default_rng(h).integers(0, 16, (h, 3)), interlace=True,
        min_code_size=4), PAL) for h in range(1, 10)],
    'transparent, background 5, disposal 0-3': [gf.gif(
        7, 6, gf.gce(d, transparent=3) + frame(), PAL, background=5)
        for d in range(4)],
    'offset on a larger screen': [gf.gif(12, 10, frame(left=2, top=3), PAL,
                                         background=5)],
    'local table over the global one': [gf.gif(
        7, 6, frame(local=gf.palette(16, 2)), PAL)],
    'local table shorter than the indices': [gf.gif(
        7, 6, frame(idx=IDX % 8, local=gf.palette(4, 2), min_code_size=3),
        PAL)],
    'no table (OpenCV\'s grey one)': [gf.gif(16, 16, gf.frame(
        np.arange(256).reshape(16, 16), min_code_size=8), None)],
    'no table, transparent, offset': [gf.gif(
        12, 10, gf.gce(transparent=3) + frame(left=2, top=3,
                                              local=PAL), None)],
    'GIF87a': [gf.gif(7, 6, frame(), PAL, version=b'87a')],
    'minimum code sizes 2-11': [gf.gif(7, 6, frame(
        idx=IDX % (1 << min(m, 4)), min_code_size=m), PAL)
        for m in range(2, 12)],
    'codes past 255 (code size 9)': [gf.gif(30, 10, gf.frame(
        np.arange(300).reshape(10, 30), min_code_size=9), None)],
    'a full table left uncleared': [gf.gif(300, 200, gf.frame(
        np.random.default_rng(5).integers(0, 4, (200, 300)),
        min_code_size=2, deferred=True), PAL)],
    'tables cleared when full': [gf.gif(400, 300, gf.frame(
        np.random.default_rng(6).integers(0, 256, (300, 400)),
        min_code_size=8), gf.palette(256, 3))],
    'extensions': [gf.gif(7, 6, gf.comment(b'x' * 300) + gf.application() +
                          gf.plain_text() + gf.application(
                              b'XMP DataXMP', b'x' * 300) +
                          b'\x21\x99' + gf.sub_blocks(b'abc') +
                          gf.gce(delay=7) + frame(), PAL)],
    'the last graphic control extension': [
        gf.gif(7, 6, gf.gce(transparent=3) + gf.gce() + frame(), PAL, 5),
        gf.gif(7, 6, gf.gce() + gf.gce(transparent=3) + frame(), PAL, 5)],
    'one-byte sub-blocks, no end code, no leading clear': [
        gf.gif(7, 6, frame(data=gf.sub_blocks(gf.lzw(IDX, 4), 1)), PAL),
        gf.gif(7, 6, frame(end=False), PAL),
        gf.gif(7, 6, frame(clear_first=False), PAL)],
    'bytes after the trailer, frames after the first': [
        gf.gif(7, 6, frame(), PAL) + b'junk',
        gf.gif(7, 6, frame() + gf.gce(disposal=5) + frame(idx=IDX[::-1]),
               PAL)],
}
REFUSED = {
    'disposal 4': gf.gif(7, 6, gf.gce(4) + frame(), PAL),
    'a graphic control extension of 5 bytes': gf.gif(
        7, 6, b'\x21\xf9\x05\x01\x00\x00\x03\x00\x00' + frame(), PAL),
    'a background index past the global table': gf.gif(7, 6, frame(), PAL,
                                                       background=16),
    'an index past the tables': gf.gif(7, 6, frame(), PAL[:8]),
    'an image past the screen': gf.gif(7, 6, frame(left=1), PAL),
    'no trailer': gf.gif(7, 6, frame(), PAL, trailer=False),
    'a block of another type': gf.gif(7, 6, frame() + b'\x55', PAL),
    'no image': gf.gif(7, 6, b'', PAL),
    'a screen of no pixels': gf.gif(0, 0, frame(), PAL),
    'an application extension not NETSCAPE2.0': gf.gif(
        7, 6, gf.application(b'NETSCAPE2.1') + frame(), PAL),
    'minimum code size 1': gf.gif(7, 6, frame(idx=IDX % 2,
                                              min_code_size=1), PAL),
    'minimum code size 12': gf.gif(7, 6, frame(min_code_size=12), PAL),
    'data past the last pixel': gf.gif(7, 6, frame(data=gf.sub_blocks(
        gf.lzw(np.concatenate([IDX, IDX]), 4))), PAL),
    'data short of the last pixel': gf.gif(7, 6, frame(data=gf.sub_blocks(
        gf.lzw(IDX[:4], 4))), PAL),
    'GIF88a': b'GIF88a' + gf.gif(7, 6, frame(), PAL)[6:],
}


@pytest.mark.parametrize('name', sorted(NAMED))
def test_named_forms_equal_opencv(name):
    for data in NAMED[name]:
        want = opencv(data)
        assert want is not None
        np.testing.assert_array_equal(image_io.imdecode(data), want)


def test_transparent_pixels_take_the_background_colour():
    """OpenCV's rule, found here: a transparent pixel keeps the screen's
    colour, the global table's background entry (not entry 0), black
    without a global table."""
    data = gf.gif(7, 6, gf.gce(transparent=3) + frame(), PAL, background=5)
    img = image_io.imdecode(data)
    np.testing.assert_array_equal(img[IDX == 3], np.tile(PAL[5, ::-1],
                                                         ((IDX == 3).sum(), 1)))
    assert not np.array_equal(PAL[5], PAL[0])
    data = gf.gif(7, 6, gf.gce(transparent=3) + frame(local=PAL), None)
    assert (image_io.imdecode(data)[IDX == 3] == 0).all()


@pytest.mark.parametrize('name', sorted(REFUSED))
def test_refusals_equal_opencv(name):
    data = REFUSED[name]
    assert opencv(data) is None
    with pytest.raises(ValueError, match='GIF: |not a PNG'):
        image_io.imdecode(data)


def pil_gif(seed, **kwargs) -> bytes:
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 256, (int(rng.integers(1, 50)),
                                int(rng.integers(1, 50)), 3), np.uint8)
    im = Image.fromarray(arr).quantize(int(rng.integers(2, 256)))
    buf = io.BytesIO()
    if kwargs.pop('animated', False):
        other = Image.fromarray(rng.integers(0, 256, arr.shape, np.uint8))
        im.save(buf, 'GIF', save_all=True, append_images=[other.quantize(7)],
                **kwargs)
    else:
        im.save(buf, 'GIF', **kwargs)
    return buf.getvalue()


@pytest.mark.parametrize('kwargs', [{}, {'interlace': True},
                                    {'transparency': 1},
                                    {'animated': True, 'transparency': 0,
                                     'duration': 40},
                                    {'animated': True, 'disposal': 2}])
def test_pil_gifs_equal_opencv(kwargs):
    for seed in range(6):
        data = pil_gif(seed, **dict(kwargs))
        want = opencv(data)
        assert want is not None
        np.testing.assert_array_equal(image_io.imdecode(data), want)


# ---- the writer -------------------------------------------------------------
WRITER_SIZES = [(1, 1), (1, 2), (3, 1), (7, 13), (16, 300), (97, 131),
                (255, 257), (512, 512), (1024, 1024)]


def writer_image(h, w, kind):
    rng = np.random.default_rng(h * 31 + w)
    img = rng.integers(0, 256, (h, w, 3), np.uint8)
    if kind == 'smooth' and h > 4 and w > 4:
        img = cv2.GaussianBlur(img, (9, 9), 3)
    if kind.startswith('bgra'):
        alpha = rng.integers(0, 256, (h, w), np.uint8)
        if kind == 'bgra-transparent':
            alpha[alpha < 40] = 0
        else:
            alpha[alpha == 0] = 1                       # opaque to OpenCV
        img = np.dstack([img, alpha])
    return img


@pytest.mark.parametrize('kind', ['noise', 'smooth', 'bgra-transparent',
                                  'bgra-opaque'])
@pytest.mark.parametrize('h,w', WRITER_SIZES)
def test_writer_bytes_equal_opencv(h, w, kind):
    """The fixed table, the float32 Floyd-Steinberg diffusion, the
    transparent index 146 (and 142 standing in for it), the LZW codes and
    sub-blocks: all OpenCV's."""
    img = writer_image(h, w, kind)
    data = image_io.imencode('.gif', img)
    assert data == cv2.imencode('.gif', img)[1].tobytes()
    np.testing.assert_array_equal(native.gif_decode(data), opencv(data))


def test_writer_transparent_entry_is_the_last_transparent_pixel():
    img = np.dstack([writer_image(9, 11, 'noise'),
                     np.full((9, 11), 255, np.uint8)])
    img[2, 3, 3] = img[7, 1, 3] = 0
    data = image_io.imencode('.gif', img)
    assert data == cv2.imencode('.gif', img)[1].tobytes()
    assert data[13 + 3 * 146:13 + 3 * 147] == img[7, 1, 2::-1].tobytes()
    assert b'\x21\xf9\x04\x0d\x64\x00\x92\x00' in data


@pytest.mark.parametrize('dtype', [np.uint16, np.int8, np.int32, np.float32,
                                   np.float64, bool])
def test_writer_saturates_other_types(dtype):
    rng = np.random.default_rng(3)
    img = (rng.integers(-100, 400, (13, 17, 3)) * 1.3).astype(dtype)
    assert image_io.imencode('.gif', img) == \
        cv2.imencode('.gif', img)[1].tobytes()


@pytest.mark.parametrize('shape,dtype', [((5, 6), np.uint8),
                                         ((5, 6, 1), np.uint8),
                                         ((5, 6), np.uint16)])
def test_writer_refuses_grey_as_opencv_does(shape, dtype):
    img = np.zeros(shape, dtype)
    assert not cv2.imencode('.gif', img)[0]
    with pytest.raises(ValueError, match="ditheringKernel"):
        image_io.imencode('.gif', img)


def test_writer_refuses_sides_past_65535():
    img = np.zeros((1, 65536, 3), np.uint8)
    assert not cv2.imencode('.gif', img)[0]
    with pytest.raises(ValueError, match='65535'):
        image_io.imencode('.gif', img)
    assert cv2.imencode('.gif', img[:, :65535])[1].tobytes() == \
        image_io.imencode('.gif', img[:, :65535])


def test_imwrite_and_imread_are_opencv_s(tmp_path):
    img = writer_image(40, 53, 'smooth')
    port_path, ref_path = str(tmp_path / 'p.gif'), str(tmp_path / 'r.gif')
    image_io.imwrite(port_path, img)
    assert cv2.imwrite(ref_path, img)
    assert (tmp_path / 'p.gif').read_bytes() == \
        (tmp_path / 'r.gif').read_bytes()
    np.testing.assert_array_equal(image_io.imread(port_path),
                                  cv2.imread(ref_path))
