"""The port's JPEG codec (``csrc/jpeg.cpp`` through ``native.py`` and
``utils/image_io.py``) against OpenCV, bit for bit:

- the decoder against ``cv2.imdecode(..., cv2.IMREAD_COLOR)`` on files
  that OpenCV writes at sizes 1 x 1 to 255 x 257: qualities 50 to 100,
  4:4:4, 4:2:2, 4:2:0 and 4:4:0 sampling, grey, restart intervals,
  progressive and optimized Huffman coding; on PIL's Adobe-RGB files; and
  ``imread`` against ``cv2.imread`` under EXIF orientations 1-8;
- the encoder's bytes against ``cv2.imencode('.jpg')`` (and ``imwrite`` on
  ``.jpg`` / ``.jpeg`` / ``.jpe`` paths) on seeded BGR and grey images;
- truncated and corrupt files raise ``ValueError`` and never crash the
  process; the forms ROADMAP A.4c lists raise by name;
- threads decode at once (ctypes releases the GIL) to the serial result.
"""

import io
import struct
import threading
from concurrent.futures import ThreadPoolExecutor

import cv2
import numpy as np
import pytest
from PIL import Image

from orientedobjectdetection_torch import native
from orientedobjectdetection_torch.utils import image_io

SIZES = [(1, 1), (7, 13), (97, 131), (255, 257)]
FORMS = {
    'q50': [cv2.IMWRITE_JPEG_QUALITY, 50],
    'q75': [cv2.IMWRITE_JPEG_QUALITY, 75],
    'q95': [],
    'q100': [cv2.IMWRITE_JPEG_QUALITY, 100],
    '444': [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444],
    '422': [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422],
    '420': [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420],
    '440': [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440],
    'grey': [],
    'restart': [cv2.IMWRITE_JPEG_RST_INTERVAL, 3],
    'progressive': [cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
    'optimize': [cv2.IMWRITE_JPEG_OPTIMIZE, 1],
    'progressive-restart': [cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                            cv2.IMWRITE_JPEG_RST_INTERVAL, 2,
                            cv2.IMWRITE_JPEG_QUALITY, 100],
}


def seeded_image(seed, h, w, grey=False):
    """Noise blurred into structure, and a gradient: smooth areas (long
    zero runs) beside busy ones (every Huffman length)."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 3)).astype(np.float32)
    if h > 2 and w > 2:
        img = cv2.GaussianBlur(img, (0, 0), 1.5).reshape(h, w, 3)
    img += np.linspace(0, 96, w, dtype=np.float32)[None, :, None]
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[..., 1].copy() if grey else img


def decode_equal(data):
    got = image_io.imdecode(data)
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize('form', list(FORMS))
@pytest.mark.parametrize('h,w', SIZES)
def test_decoder_equals_opencv(h, w, form):
    img = seeded_image(h * 1000 + w, h, w, grey=form == 'grey')
    ok, data = cv2.imencode('.jpg', img, FORMS[form])
    assert ok
    decode_equal(data.tobytes())


@pytest.mark.parametrize('h,w', SIZES)
def test_decoder_reads_adobe_rgb(h, w):
    """PIL's ``keep_rgb`` files: an Adobe APP14 marker with transform 0,
    components 'R', 'G', 'B', no JFIF marker; libjpeg reads RGB."""
    buf = io.BytesIO()
    Image.fromarray(seeded_image(w, h, w)[..., ::-1]).save(
        buf, 'JPEG', keep_rgb=True, quality=90)
    data = buf.getvalue()
    assert b'Adobe' in data and b'JFIF' not in data
    decode_equal(data)


@pytest.mark.parametrize('orientation', range(1, 9))
def test_imread_applies_the_exif_orientation(tmp_path, orientation):
    img = seeded_image(orientation, 97, 131)
    exif = Image.Exif()
    exif[0x0112] = orientation
    path = str(tmp_path / 'o.jpg')
    Image.fromarray(img[..., ::-1]).save(path, exif=exif.tobytes(),
                                         quality=92)
    got = image_io.imread(path)
    np.testing.assert_array_equal(got, cv2.imread(path, cv2.IMREAD_COLOR))
    assert got.shape[:2] == ((131, 97) if orientation >= 5 else (97, 131))
    with open(path, 'rb') as f:
        decode_equal(f.read())


@pytest.mark.parametrize('grey', [False, True])
@pytest.mark.parametrize('h,w', SIZES + [(16, 16), (17, 33), (40, 8)])
def test_encoder_bytes_equal_opencv(h, w, grey):
    img = seeded_image(h + 7 * w, h, w, grey=grey)
    want = cv2.imencode('.jpg', img)[1].tobytes()
    assert native.jpeg_encode(img) == want


@pytest.mark.parametrize('suffix', ['.jpg', '.jpeg', '.JPE'])
def test_imwrite_writes_what_opencv_writes(tmp_path, suffix):
    """``imwrite`` on a JPEG path writes a JPEG (it used to write PNG bytes
    under any name but ``.bmp``), grey images too."""
    for grey in (False, True):
        img = seeded_image(5, 61, 47, grey=grey)
        path = str(tmp_path / f'x{suffix}')
        image_io.imwrite(path, img)
        with open(path, 'rb') as f:
            data = f.read()
        assert data == cv2.imencode('.jpg', img)[1].tobytes()
        back = image_io.imread(path)
        np.testing.assert_array_equal(back, cv2.imread(path))


def a_jpeg():
    return cv2.imencode('.jpg', seeded_image(1, 97, 131),
                        [cv2.IMWRITE_JPEG_RST_INTERVAL, 4])[1].tobytes()


@pytest.mark.parametrize('keep', [2, 3, 20, 200, 0.3, 0.7, -3, -2, -1])
def test_truncated_files_raise(keep):
    data = a_jpeg()
    cut = keep if isinstance(keep, int) and keep > 0 else \
        int(len(data) * keep) if isinstance(keep, float) else len(data) + keep
    with pytest.raises(ValueError, match='JPEG'):
        image_io.imdecode(data[:cut])


def test_corrupt_files_raise_and_never_crash():
    """Random bytes overwritten anywhere in a baseline and a progressive
    file: each decode returns an image or raises ValueError."""
    rng = np.random.default_rng(0)
    raised = 0
    for params in ([cv2.IMWRITE_JPEG_RST_INTERVAL, 4],
                   [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]):
        data = cv2.imencode('.jpg', seeded_image(2, 64, 80),
                            params)[1].tobytes()
        for _ in range(300):
            bad = bytearray(data)
            for at in rng.integers(0, len(bad), rng.integers(1, 6)):
                bad[at] = rng.integers(0, 256)
            try:
                img = image_io.imdecode(bytes(bad))
                assert img.dtype == np.uint8 and img.shape[2] == 3
            except ValueError:
                raised += 1
    assert raised > 0


def test_oversized_frames_raise_before_any_allocation():
    """A frame header past OpenCV's 2^30-pixel limit is refused by the
    header parse, before the output is allocated."""
    data = bytearray(a_jpeg())
    sof = data.index(b'\xff\xc0')
    data[sof + 5:sof + 9] = struct.pack('>HH', 65535, 65535)
    with pytest.raises(ValueError, match='exceeds 2\\^30'):
        image_io.imdecode(bytes(data))


def patched(data, offset, value):
    out = bytearray(data)
    out[offset] = value
    return bytes(out)


def refused_forms():
    data = cv2.imencode('.jpg', seeded_image(3, 16, 16))[1].tobytes()
    sof = data.index(b'\xff\xc0')
    buf = io.BytesIO()
    Image.fromarray(seeded_image(3, 16, 16)).convert('CMYK').save(buf, 'JPEG')
    tiff = io.BytesIO()
    Image.fromarray(seeded_image(3, 16, 16)).save(tiff, 'TIFF')
    return {
        'TIFF': tiff.getvalue(),
        'CMYK': buf.getvalue(),
        'arithmetic-coded JPEG \\(SOF9\\)': patched(data, sof + 1, 0xC9),
        'arithmetic-coded JPEG \\(SOF10\\)': patched(data, sof + 1, 0xCA),
        '12-bit JPEG': patched(data, sof + 4, 12),
        'lossless JPEG \\(SOF3\\)': patched(data, sof + 1, 0xC3),
        'hierarchical JPEG \\(SOF5\\)': patched(data, sof + 1, 0xC5),
        'hierarchical JPEG \\(DHP\\)': data[:2] + b'\xff\xde\x00\x02' +
        data[2:],
    }


@pytest.mark.parametrize('form', [
    'TIFF', 'CMYK', 'arithmetic-coded JPEG \\(SOF9\\)',
    'arithmetic-coded JPEG \\(SOF10\\)', '12-bit JPEG',
    'lossless JPEG \\(SOF3\\)', 'hierarchical JPEG \\(SOF5\\)',
    'hierarchical JPEG \\(DHP\\)'])
def test_refused_forms_are_named(form):
    with pytest.raises(ValueError, match=form + '.*ROADMAP A.4c'):
        image_io.imdecode(refused_forms()[form])


def test_threads_decode_at_once():
    files = [cv2.imencode('.jpg', seeded_image(s, 200, 300),
                          [cv2.IMWRITE_JPEG_PROGRESSIVE, s % 2])[1].tobytes()
             for s in range(8)]
    serial = [native.jpeg_decode(f) for f in files]
    barrier = threading.Barrier(8)

    def decode(i):
        barrier.wait(timeout=30)
        return [native.jpeg_decode(files[i]) for _ in range(3)]

    with ThreadPoolExecutor(8) as pool:
        results = [f.result(timeout=120)
                   for f in [pool.submit(decode, i) for i in range(8)]]
    for want, got in zip(serial, results):
        for g in got:
            np.testing.assert_array_equal(g, want)


def test_exif_parse_ignores_what_does_not_parse():
    """A first APP1 segment that is not EXIF, a bad TIFF header, an IFD
    past the block's end and an orientation out of 1-8 leave the image as
    it is, as OpenCV's reader does."""
    be = b'MM\x00\x2a' + struct.pack('>I', 8) + struct.pack('>H', 1) + \
        struct.pack('>HHIHH', 0x0112, 3, 1, 6, 0)
    assert image_io._exif_orientation(be) == 6
    assert image_io._exif_orientation(be[:-6]) == 1
    assert image_io._exif_orientation(b'II\x2b\x00' + be[4:]) == 1
    bad = be[:-4] + struct.pack('>HH', 9, 0)
    assert image_io._exif_orientation(bad) == 1
    assert image_io._exif_orientation(b'http://ns.adobe.com/xap') == 1
