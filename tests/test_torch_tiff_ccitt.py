"""CCITT-compressed TIFFs (``csrc/tiff.cpp``'s port of libtiff's
``tif_fax3.c``) against ``cv2.imdecode(..., IMREAD_COLOR)``, bit for bit,
through ``utils/image_io`` from bytes and from a path: RLE (2), RLEW
(32771), T.4 (3) 1-D and 2-D with and without fill bits, and T.6 (4),
MinIsWhite and MinIsBlack, strips and tiles, both byte orders, FillOrder 1
and 2 (files of ``tests/tiff_forms.py``'s encoder); runs long enough for the
make-up and the extended make-up codes; a 1-bit palette; PIL's RLE, T.4
and T.6 files (libtiff's encoder); an orientation; data cut short."""

import io

import cv2
import numpy as np
import pytest
from PIL import Image

import tiff_forms as tf
from orientedobjectdetection_torch.utils import image_io

H, W = 37, 53
MODES = {'rle': (2, {}), 'rlew': (32771, {}), 't4-1d': (3, {}),
         't4-1d-fill': (3, dict(fill_bits=True)),
         't4-2d': (3, dict(two_d=True, k=2)),
         't4-2d-fill': (3, dict(two_d=True, fill_bits=True, k=4)),
         't6': (4, {})}


def t4_options(kwargs):
    return (1 if kwargs.get('two_d') else 0) | \
        (4 if kwargs.get('fill_bits') else 0)


def pixels(h, w, seed):
    """Seeded 0 / 1 pixels: blobs and lines over sparse noise, as a scan."""
    rng = np.random.default_rng(seed)
    bits = (rng.random((h, w)) < 0.08).astype(np.int64)
    for _ in range(6):
        y, x = rng.integers(0, h), rng.integers(0, w)
        bits[y:y + rng.integers(1, 9), x:x + rng.integers(1, 30)] ^= 1
    return bits


def fax_tiff(bits, mode, photometric=0, layout='strips', order='<',
             fill_order=1, tags=None):
    """One CCITT TIFF of ``bits`` in ``layout``: 'strips' of 5 rows, one
    'strip', or 16 x 16 'tiles'."""
    comp, kwargs = MODES[mode]
    h, w = bits.shape
    tags = dict(tags or {})
    if comp == 3:
        tags[292] = (tf.LONG, [t4_options(kwargs)])
    if fill_order == 2:
        tags[266] = (tf.SHORT, [2])

    def encode(block):
        data = tf.ccitt(block, comp, **kwargs)
        return tf.reverse_bits(data) if fill_order == 2 else data

    if layout == 'tiles':
        pad = np.zeros((-(-h // 16) * 16, -(-w // 16) * 16), np.int64)
        pad[:h, :w] = bits
        blocks = [encode(pad[y:y + 16, x:x + 16]) for y in range(0, h, 16)
                  for x in range(0, w, 16)]
        return tf.build(blocks, h, w, 1, 1, photometric, compression=comp,
                        tile=(16, 16), order=order, tags=tags)
    rps = 5 if layout == 'strips' else h
    blocks = [encode(bits[y:y + rps]) for y in range(0, h, rps)]
    return tf.build(blocks, h, w, 1, 1, photometric, compression=comp,
                    rows_per_strip=rps, order=order, tags=tags)


def opencv(data):
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)


def held(data, tmp_path):
    """The port's decode from bytes and from a path, against OpenCV's."""
    want = opencv(data)
    assert want is not None
    np.testing.assert_array_equal(image_io.imdecode(data), want)
    path = tmp_path / 'x.tif'
    path.write_bytes(data)
    np.testing.assert_array_equal(image_io.imread(str(path)), want)
    return want


CASES = [(mode, photometric, layout, order, fill_order)
         for mode in MODES for photometric in (0, 1)
         for layout, order, fill_order in (('strips', '<', 1),
                                           ('tiles', '>', 2),
                                           ('strip', '>', 1),
                                           ('strips', '<', 2))]


@pytest.mark.parametrize('mode,photometric,layout,order,fill_order', CASES)
def test_forms_equal_opencv(tmp_path, mode, photometric, layout, order,
                            fill_order):
    seed = len(CASES) + CASES.index((mode, photometric, layout, order,
                                     fill_order))
    bits = pixels(H, W, seed)
    want = held(fax_tiff(bits, mode, photometric, layout, order, fill_order),
                tmp_path)
    if mode != 'rlew':             # libtiff's RLEW alignment garbles rows
        ink = 0 if photometric == 0 else 255
        np.testing.assert_array_equal(want[..., 0] == ink, bits == 1)


@pytest.mark.parametrize('mode', sorted(MODES))
def test_long_runs_use_make_up_codes(tmp_path, mode):
    """Rows of 2700 pixels: runs up to 2700 (terminating, make-up and the
    extended make-up codes shared by both colours, a run of 2560 and
    more), each colour first."""
    bits = np.zeros((4, 2700), np.int64)
    bits[0, 70:1900] = 1
    bits[1, :2650] = 1
    bits[2, 2000:2064] = 1
    bits[3, ::97] = 1
    held(fax_tiff(bits, mode, layout='strip'), tmp_path)


@pytest.mark.parametrize('mode', ['t4-2d', 't6'])
def test_palette_and_orientation(tmp_path, mode):
    """A 1-bit palette image and an Orientation 6 (transposing) file."""
    bits = pixels(H, W, 3)
    cmap = [0, 65535, 20000, 1000, 40000, 65535]
    held(fax_tiff(bits, mode, photometric=3,
                  tags={320: (tf.SHORT, cmap)}), tmp_path)
    held(fax_tiff(bits, mode, tags={274: (tf.SHORT, [6])}), tmp_path)


@pytest.mark.parametrize('compression', ['tiff_ccitt', 'group3', 'group4'])
def test_pil_files_equal_opencv(tmp_path, compression):
    """PIL writes these through libtiff's encoder."""
    img = Image.fromarray(pixels(H, W, 4).astype(bool))
    buf = io.BytesIO()
    img.save(buf, 'TIFF', compression=compression)
    held(buf.getvalue(), tmp_path)


@pytest.mark.parametrize('mode', sorted(MODES))
def test_data_cut_short(mode):
    """A strip whose data ends early: the rows OpenCV decodes from it before
    the end are the port's too (libtiff closes the row the data ends in;
    the rows after are what its buffer held, and 0 bits in the port), and
    the decode never crashes."""
    bits = pixels(20, W, 5)
    comp, kwargs = MODES[mode]
    data = tf.ccitt(bits, comp, **kwargs)
    tags = {292: (tf.LONG, [t4_options(kwargs)])} if comp == 3 else {}
    for keep in (1, len(data) // 3, len(data) // 2, len(data) - 1):
        cut = tf.build([data[:keep]], 20, W, 1, 1, 0, compression=comp,
                       tags=tags)
        got, want = image_io.imdecode(cut), opencv(cut)
        assert got.shape == want.shape == (20, W, 3)
        if mode == 'rlew':         # libtiff's word alignment garbles rows
            continue
        rows = 0
        while rows < 20 and np.array_equal(want[rows, :, 0] == 0,
                                           bits[rows] == 1):
            rows += 1
        assert rows >= (keep > len(data) // 3)
        np.testing.assert_array_equal(got[:rows], want[:rows])
