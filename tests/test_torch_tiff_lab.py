"""CIE L*a*b* TIFFs (``csrc/tiff.cpp``'s port of libtiff's ``tif_color.c``
conversion with its sRGB display) against ``cv2.imdecode(...,
IMREAD_COLOR)``, bit for bit, through ``utils/image_io`` from bytes and
from a path: 8 and 16 bits, strips and (compressed) tiles, both byte
orders, Predictor 2, a WhitePoint tag, PIL's ``LAB`` files; the L*a*b*
forms OpenCV does not read (planar, other than 3 samples, ICC and ITU
L*a*b*) raise saying so."""

import io

import cv2
import numpy as np
import pytest
from PIL import Image

import tiff_forms as tf
from jpeg_forms import seeded_samples
from orientedobjectdetection_torch.utils import image_io

H, W = 29, 41


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


def lab_samples(bits, seed, h=H, w=W):
    """L* over its range; a* and b* two's complement over theirs (both
    signs, the extremes included)."""
    s = seeded_samples(seed, h, w, 3, bits)
    s[0, :3, 1:] = [[0, 0], [1 << (bits - 1), (1 << bits) - 1],
                    [(1 << (bits - 1)) - 1, 1 << (bits - 1)]]
    s[1, :2, 0] = [0, (1 << bits) - 1]
    return s


LAYOUTS = {'strips': dict(rows_per_strip=7),
           'strips-lzw-predictor': dict(rows_per_strip=7, compression=5,
                                        predictor=2),
           'tiles-deflate': dict(tile=(16, 16), compression=8),
           'tiles-packbits': dict(tile=(16, 32), compression=32773)}


@pytest.mark.parametrize('order', ['<', '>'])
@pytest.mark.parametrize('layout', sorted(LAYOUTS))
@pytest.mark.parametrize('bits', [8, 16])
def test_built_files(tmp_path, bits, layout, order):
    held(tf.tiff(lab_samples(bits, bits + len(layout)), bits, 8,
                 order=order, **LAYOUTS[layout]), tmp_path)


@pytest.mark.parametrize('bits', [8, 16])
def test_white_point_and_orientation(tmp_path, bits):
    """A WhitePoint other than D50 (the default libtiff takes) moves X and
    Z; an Orientation 5 file is transposed."""
    tags = {318: (tf.RATIONAL, [(3127, 10000), (3290, 10000)]),
            274: (tf.SHORT, [5])}
    held(tf.tiff(lab_samples(bits, 3), bits, 8, tags=tags), tmp_path)


@pytest.mark.parametrize('compression', ['raw', 'tiff_lzw',
                                         'tiff_adobe_deflate'])
def test_pil_files(tmp_path, compression):
    rgb = seeded_samples(4, H, W, 3).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(rgb).convert('LAB').save(buf, 'TIFF',
                                             compression=compression)
    held(buf.getvalue(), tmp_path)


@pytest.mark.parametrize('photometric,spp,planar,why', [
    (8, 3, 2, 'CIE L'), (8, 4, 1, 'CIE L'), (8, 1, 1, 'CIE L'),
    (9, 3, 1, 'ICC L'), (10, 3, 1, 'ITU L')])
def test_refused_as_opencv_refuses(photometric, spp, planar, why):
    data = tf.tiff(seeded_samples(5, 8, 8, spp), 8, photometric,
                   planar=planar)
    assert opencv(data) is None
    with pytest.raises(ValueError, match=why + '.*OpenCV does not read it '
                       'either'):
        image_io.imdecode(data)
