"""The port's JPEG codec (``csrc/jpeg.cpp`` through ``native.py`` and
``utils/image_io.py``) against OpenCV, bit for bit:

- the decoder against ``cv2.imdecode(..., cv2.IMREAD_COLOR)`` on files
  that OpenCV writes at sizes 1 x 1 to 255 x 257: qualities 50 to 100,
  4:4:4, 4:2:2, 4:2:0 and 4:4:0 sampling, grey, restart intervals,
  progressive and optimized Huffman coding; on PIL's Adobe-RGB files; and
  ``imread`` against ``cv2.imread`` under EXIF orientations 1-8;
- the encoder's bytes against ``cv2.imencode('.jpg')`` (and ``imwrite`` on
  ``.jpg`` / ``.jpeg`` / ``.jpe`` paths) on seeded BGR and grey images;
- the forms neither OpenCV nor PIL writes, made by ``tests/jpeg_forms.py``:
  arithmetic-coded (sequential, progressive, restarts, DAC conditioning),
  lossless (predictors 1-7, point transforms, restarts, 6 bits), CMYK and
  YCCK (subsampled, with and without an Adobe marker), against
  ``cv2.imdecode`` on the same bytes; the forms OpenCV returns no image for
  (12-bit, hierarchical, lossless grey / YCbCr / YCCK or over 8 bits,
  lossless arithmetic) raise saying so;
- truncated and corrupt files raise ``ValueError`` and never crash the
  process;
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

import jpeg_forms
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
    """The forms the port refused until it read them, as real files, and
    those OpenCV does not read either (a baseline file patched)."""
    data = cv2.imencode('.jpg', seeded_image(3, 16, 16))[1].tobytes()
    sof = data.index(b'\xff\xc0')
    buf = io.BytesIO()
    Image.fromarray(seeded_image(3, 16, 16)).convert('CMYK').save(buf, 'JPEG')
    tiff = io.BytesIO()
    Image.fromarray(seeded_image(3, 16, 16)).save(tiff, 'TIFF')
    samples = jpeg_forms.seeded_samples(3, 16, 16, 3)
    return {
        'TIFF': tiff.getvalue(),
        'CMYK': buf.getvalue(),
        'arithmetic-coded JPEG \\(SOF9\\)': jpeg_forms.dct_jpeg(
            samples, arithmetic=True, markers=jpeg_forms.jfif()),
        'arithmetic-coded JPEG \\(SOF10\\)': jpeg_forms.dct_jpeg(
            samples, arithmetic=True, progressive=True,
            markers=jpeg_forms.jfif()),
        '12-bit JPEG': patched(data, sof + 4, 12),
        'lossless JPEG \\(SOF3\\)': jpeg_forms.lossless_jpeg(samples,
                                                             predictor=4),
        'hierarchical JPEG \\(SOF5\\)': patched(data, sof + 1, 0xC5),
        'hierarchical JPEG \\(DHP\\)': data[:2] + b'\xff\xde\x00\x02' +
        data[2:],
    }


# the forms refused until the port read them
NOW_READ = ('TIFF', 'CMYK', 'arithmetic-coded JPEG \\(SOF9\\)',
            'arithmetic-coded JPEG \\(SOF10\\)', 'lossless JPEG \\(SOF3\\)')


@pytest.mark.parametrize('form', [
    'TIFF', 'CMYK', 'arithmetic-coded JPEG \\(SOF9\\)',
    'arithmetic-coded JPEG \\(SOF10\\)', '12-bit JPEG',
    'lossless JPEG \\(SOF3\\)', 'hierarchical JPEG \\(SOF5\\)',
    'hierarchical JPEG \\(DHP\\)'])
def test_refused_forms_are_named(form):
    """A form the port now reads decodes as ``cv2.imdecode`` decodes it; a
    form OpenCV does not read either raises, naming it and saying so."""
    data = refused_forms()[form]
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    if form in NOW_READ:
        assert want is not None
        np.testing.assert_array_equal(image_io.imdecode(data), want)
        return
    assert want is None
    with pytest.raises(ValueError,
                       match=form + '.*OpenCV does not read it either'):
        image_io.imdecode(data)


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


# ---- the forms neither OpenCV nor PIL writes (tests/jpeg_forms.py) -------
def made_forms():
    """name -> bytes: arithmetic-coded, lossless, CMYK and YCCK files."""
    f = jpeg_forms
    s3 = f.seeded_samples(11, 21, 35, 3)
    s4 = f.seeded_samples(12, 21, 35, 4)
    sub = [(2, 2), (1, 1), (1, 1)]
    forms = {
        'arith-seq': f.dct_jpeg(s3, arithmetic=True, markers=f.jfif()),
        'arith-seq-420-restart': f.dct_jpeg(
            s3, sampling=sub, arithmetic=True, restart=2, markers=f.jfif()),
        'arith-grey': f.dct_jpeg(s3[..., :1], arithmetic=True),
        'arith-progressive': f.dct_jpeg(s3, arithmetic=True, progressive=True,
                                        markers=f.jfif()),
        'arith-progressive-422-restart': f.dct_jpeg(
            s3, sampling=[(2, 1), (1, 1), (1, 1)], arithmetic=True,
            progressive=True, restart=3, markers=f.jfif()),
        'arith-dac': f.dct_jpeg(s3, arithmetic=True, dac=(1, 3, 9),
                                markers=f.jfif()),
        'arith-cmyk': f.dct_jpeg(s4, arithmetic=True, markers=f.adobe(0)),
        'cmyk-adobe': f.dct_jpeg(s4, markers=f.adobe(0)),
        'cmyk-no-marker': f.dct_jpeg(s4),
        'cmyk-subsampled': f.dct_jpeg(
            s4, sampling=[(2, 2), (1, 1), (1, 1), (2, 2)],
            markers=f.adobe(0)),
        'ycck': f.dct_jpeg(s4, markers=f.adobe(2)),
        'ycck-subsampled': f.dct_jpeg(
            s4, sampling=[(2, 2), (1, 1), (1, 1), (2, 2)],
            markers=f.adobe(2)),
        'lossless-cmyk': f.lossless_jpeg(s4, predictor=6),
        'lossless-adobe-rgb': f.lossless_jpeg(s3, markers=f.adobe(0)),
        'lossless-rgb-ids': f.lossless_jpeg(s3, predictor=2,
                                            ids=[82, 71, 66]),
        'lossless-6-bit': f.lossless_jpeg(f.seeded_samples(13, 21, 35, 3, 6),
                                          precision=6, predictor=5),
    }
    for p in range(1, 8):
        forms[f'lossless-p{p}'] = f.lossless_jpeg(s3, predictor=p)
        forms[f'lossless-p{p}-pt2-restart'] = f.lossless_jpeg(
            s3, predictor=p, pt=2, restart=35 * 4)
    buf = io.BytesIO()
    Image.fromarray(s4.astype(np.uint8), 'CMYK').save(buf, 'JPEG',
                                                       progressive=True)
    forms['pil-cmyk-progressive'] = buf.getvalue()
    return forms


def opencv_refuses():
    """name -> (bytes, the port's message): what OpenCV 5 returns no image
    for (libjpeg-turbo 3 converts no colour space of a lossless file, and
    OpenCV reads 8-bit samples alone)."""
    f = jpeg_forms
    s3 = f.seeded_samples(14, 21, 35, 3)
    lossless = f.lossless_jpeg(s3)
    sof3 = lossless.index(b'\xff\xc3')
    return {
        'lossless-grey': (f.lossless_jpeg(s3[..., :1]), 'lossless grey'),
        'lossless-jfif': (f.lossless_jpeg(s3, markers=f.jfif()),
                          'lossless YCbCr'),
        'lossless-ycck': (f.lossless_jpeg(f.seeded_samples(15, 21, 35, 4),
                                          markers=f.adobe(2)),
                          'lossless YCCK'),
        'lossless-12-bit': (f.lossless_jpeg(
            f.seeded_samples(16, 21, 35, 1, 12), precision=12),
            'lossless JPEG of 12-bit samples'),
        'lossless-16-bit': (f.lossless_jpeg(
            f.seeded_samples(17, 21, 35, 3, 16), precision=16),
            'lossless JPEG of 16-bit samples'),
        '12-bit-sequential': (f.dct_jpeg(f.seeded_samples(18, 21, 35, 3, 12),
                                         precision=12, markers=f.jfif()),
                              '12-bit JPEG'),
        'lossless-arithmetic': (patched(lossless, sof3 + 1, 0xCB),
                                'lossless arithmetic-coded JPEG \\(SOF11\\)'),
    }


MADE = made_forms()
REFUSED = opencv_refuses()


@pytest.mark.parametrize('name', sorted(MADE))
def test_made_forms_decode_as_opencv(name):
    """Each arithmetic-coded, lossless, CMYK and YCCK file decodes to
    ``cv2.imdecode``'s array, exactly."""
    decode_equal(MADE[name])


@pytest.mark.parametrize('name', sorted(REFUSED))
def test_forms_opencv_does_not_read_raise(name):
    data, message = REFUSED[name]
    assert cv2.imdecode(np.frombuffer(data, np.uint8),
                        cv2.IMREAD_COLOR) is None
    with pytest.raises(ValueError,
                       match=message + '.*OpenCV does not read it either'):
        image_io.imdecode(data)


def test_made_forms_truncated_or_corrupt_raise_and_never_crash():
    """Arithmetic-coded, lossless and CMYK files cut short or with bytes
    overwritten: each decode returns an image or raises ValueError (a few
    hundred files)."""
    rng = np.random.default_rng(5)
    raised = 0
    for name in ('arith-seq-420-restart', 'arith-progressive',
                 'lossless-p4-pt2-restart', 'ycck-subsampled'):
        data = MADE[name]
        for trial in range(60):
            bad = bytearray(data[:rng.integers(2, len(data))] if trial < 15
                            else data)
            if trial >= 15:
                for at in rng.integers(0, len(bad), rng.integers(1, 6)):
                    bad[at] = rng.integers(0, 256)
            try:
                img = image_io.imdecode(bytes(bad))
                assert img.dtype == np.uint8 and img.shape[2] == 3
            except ValueError:
                raised += 1
    assert raised > 50
