"""SGILog TIFFs (``csrc/tiff.cpp``'s port of libtiff's ``tif_luv.c`` 8-bit
path) against ``cv2.imdecode(..., IMREAD_COLOR)``, bit for bit, through
``utils/image_io`` from bytes and from a path: the LogLuv and LogL files
``cv2.imencode`` writes (compression 34676 and 34677), and LogL16,
LogLuv32 and LogLuv24 files of ``tests/tiff_forms.py`` (strips and tiles,
both byte orders, FillOrder 2, chroma codes past uvcode.h's table,
negative luminance); the SGILog forms libtiff's RGBA interface refuses
raise saying OpenCV does not read them either."""

import cv2
import numpy as np
import pytest

import tiff_forms as tf
from orientedobjectdetection_torch.utils import image_io

H, W = 23, 37


def opencv(data):
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)


def held(data, tmp_path):
    want = opencv(data)
    assert want is not None
    np.testing.assert_array_equal(image_io.imdecode(data), want)
    path = tmp_path / 'x.tif'
    path.write_bytes(data)
    np.testing.assert_array_equal(image_io.imread(str(path)), want)
    return want


def radiance(h, w, channels, seed, top):
    """Seeded float32 radiance in [0, top): a gradient with noise, some
    pixels black."""
    rng = np.random.default_rng(seed)
    img = (np.linspace(0, top, w)[None, :, None] * rng.random((h, 1, 1)) +
           rng.random((h, w, channels)) * top / 4).astype(np.float32)
    img[rng.random((h, w)) < 0.05] = 0
    return img


@pytest.mark.parametrize('compression', [34676, 34677])
@pytest.mark.parametrize('top', [0.05, 1.0, 6.0])
def test_opencv_logluv_files(tmp_path, compression, top):
    """``cv2.imencode`` of float32 BGR: LogLuv32 (run-length) or LogLuv24;
    OpenCV reads them back as 8-bit RGB through XYZ with a 2.0 gamma."""
    img = radiance(H, W, 3, int(top * 100) + compression, top)
    data = cv2.imencode('.tif', img,
                        [cv2.IMWRITE_TIFF_COMPRESSION, compression])[1]
    held(data.tobytes(), tmp_path)


@pytest.mark.parametrize('top', [0.05, 1.0, 6.0])
def test_opencv_logl_files(tmp_path, top):
    """``cv2.imencode`` of float32 grey with 34676 writes LogL16."""
    img = radiance(H, W, 1, int(top * 100), top)[..., 0]
    data = cv2.imencode('.tif', img, [cv2.IMWRITE_TIFF_COMPRESSION, 34676])[1]
    want = held(data.tobytes(), tmp_path)
    assert (want[..., 0] == want[..., 2]).all()


def logl_samples(h, w, seed, signed=False):
    """LogL16 codes: luminance from 2^-12 to 2^4 (and negative ones, the
    sign bit set, when ``signed``), runs of one value now and then."""
    rng = np.random.default_rng(seed)
    v = rng.integers(256 * 52, 256 * 68, (h, w))
    v[:, w // 3:w // 2] = v[:, w // 3:w // 3 + 1]
    if signed:
        v[rng.random((h, w)) < 0.2] |= 0x8000
        v[rng.random((h, w)) < 0.05] = 0
    return v


def logluv32_samples(h, w, seed):
    rng = np.random.default_rng(seed)
    return logl_samples(h, w, seed) << 16 | rng.integers(0, 256, (h, w)) \
        << 8 | rng.integers(0, 256, (h, w))


def logluv24_samples(h, w, seed):
    """LogLuv24: 10-bit log luminance, 14-bit chroma code (some past the
    table's 16289 codes: libtiff takes the neutral chroma there)."""
    rng = np.random.default_rng(seed)
    return rng.integers(300, 1023, (h, w)) << 14 | rng.integers(0, 16384,
                                                                (h, w))


FORMS = {'logl': (tf.logl, logl_samples, 1, 32844, 34676),
         'logl-signed': (tf.logl, lambda h, w, s: logl_samples(h, w, s, True),
                         1, 32844, 34676),
         'logluv32': (tf.logluv32, logluv32_samples, 3, 32845, 34676),
         'logluv24': (tf.logluv24, logluv24_samples, 3, 32845, 34677)}


def sgilog_tiff(form, seed, layout='strips', order='<', fill_order=1,
                h=H, w=W, tags=None):
    encode, samples, spp, photometric, comp = FORMS[form]
    v = samples(h, w, seed)
    tags = {339: (tf.SHORT, [2] * spp), **(tags or {})}
    if fill_order == 2:
        tags[266] = (tf.SHORT, [2])

    def block(part):
        data = encode(part)
        return tf.reverse_bits(data) if fill_order == 2 else data

    if layout == 'tiles':
        pad = np.zeros((-(-h // 16) * 16, -(-w // 16) * 16), np.int64)
        pad[:h, :w] = v
        blocks = [block(pad[y:y + 16, x:x + 16]) for y in range(0, h, 16)
                  for x in range(0, w, 16)]
        return tf.build(blocks, h, w, 16, spp, photometric, compression=comp,
                        tile=(16, 16), order=order, tags=tags)
    rps = 6 if layout == 'strips' else h
    return tf.build([block(v[y:y + rps]) for y in range(0, h, rps)], h, w,
                    16, spp, photometric, compression=comp,
                    rows_per_strip=rps, order=order, tags=tags)


@pytest.mark.parametrize('layout,order,fill_order', [
    ('strips', '<', 1), ('tiles', '>', 1), ('strip', '>', 2),
    ('tiles', '<', 2)])
@pytest.mark.parametrize('form', sorted(FORMS))
def test_built_files(tmp_path, form, layout, order, fill_order):
    held(sgilog_tiff(form, len(form), layout, order, fill_order), tmp_path)


def test_orientation(tmp_path):
    held(sgilog_tiff('logluv32', 5, tags={274: (tf.SHORT, [8])}), tmp_path)


@pytest.mark.parametrize('photometric,compression,planar,why', [
    (32844, 34677, 1, 'LogL'), (32845, 1, 1, 'LogLuv'),
    (32845, 34676, 2, 'LogLuv'), (1, 34676, 1, 'SGILog')])
def test_refused_as_opencv_refuses(photometric, compression, planar, why):
    """LogL under SGILog24, LogLuv uncompressed or planar, SGILog data
    under another photometric interpretation."""
    spp = 1 if photometric in (1, 32844) else 3
    v = logl_samples(8, 8, 1) if spp == 1 else logluv32_samples(8, 8, 1)
    data = (tf.logl if spp == 1 else tf.logluv32)(v)
    data = tf.build([data] * (3 if planar == 2 else 1), 8, 8, 16, spp,
                    photometric, compression=compression, planar=planar,
                    tags={339: (tf.SHORT, [2] * spp)})
    assert opencv(data) is None
    with pytest.raises(ValueError, match=why + '.*OpenCV does not read it '
                       'either'):
        image_io.imdecode(data)
