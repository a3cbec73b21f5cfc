"""The port's PNM, PAM and PFM codecs (``csrc/raster.cpp`` and
``utils/image_io.py``) against OpenCV 5.0:

- the reader against ``cv2.imdecode(..., cv2.IMREAD_COLOR)`` on files of
  ``tests/raster_forms.py`` and of ``cv2.imencode``: ``P1``-``P6`` ASCII
  and binary at maxvals 1-65535 (ASCII samples scaled to 8 bits, binary
  ones as stored, 16-bit ones by their high byte), comments and other
  whitespace in the header; PAM of each DEPTH, MAXVAL and TUPLTYPE OpenCV
  takes; PFM of either byte order and any scale, grey (returned as
  ``(H, W)``, as OpenCV returns it) and colour;
- the forms OpenCV refuses or leaves unset (PAM of DEPTH 2 or 4, an
  unknown TUPLTYPE, maxval 0 or past 65535) raise saying so;
- ``imwrite``'s ``.pbm``, ``.pgm``, ``.ppm``, ``.pnm``, ``.pam`` and
  ``.pfm`` bytes against ``cv2.imencode``'s, and its refusals where
  OpenCV's come;
- cut and corrupt files decode to OpenCV's array or raise ``ValueError``,
  and never crash.
"""

import os

import cv2
import numpy as np
import pytest

import raster_forms as rf
from orientedobjectdetection_torch.utils import image_io


def opencv(data):
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)


def same_as_opencv(data):
    """The port decodes ``data`` to OpenCV's array."""
    want = opencv(data)
    assert want is not None
    got = image_io.imdecode(data)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    return got


def encoded(ext, img):
    ok, buf = cv2.imencode(ext, img)
    return buf.tobytes() if ok else None


# ---- the table of OpenCV 5.0's behaviours -----------------------------------
def test_ascii_samples_scale_to_8_bits():
    """``P2``, maxval 100: 0 / 50 / 100 read as 0 / 127 / 255."""
    got = same_as_opencv(b'P2\n3 1\n100\n0 50 100\n')
    assert got[0, :, 0].tolist() == [0, 127, 255]


def test_binary_16_bit_samples_take_their_high_byte():
    """``P5``, maxval 1000: 1000 and 256 read as 3 and 1 (shifted right by
    8, not scaled by maxval)."""
    data = b'P5\n2 1\n1000\n' + np.array([1000, 256], '>u2').tobytes()
    assert same_as_opencv(data)[0, :, 0].tolist() == [3, 1]


def test_uint16_pgm_is_written_at_16_bits(tmp_path):
    img = np.array([[0, 255, 256, 65535]], np.uint16)
    image_io.imwrite(str(tmp_path / 'x.pgm'), img)
    data = (tmp_path / 'x.pgm').read_bytes()
    assert data == encoded('.pgm', img)
    assert data == b'P5\n4 1\n65535\n' + img.astype('>u2').tobytes()
    assert same_as_opencv(data)[0, :, 0].tolist() == [0, 0, 1, 255]


def test_pbm_sets_the_bits_of_zero(tmp_path):
    img = np.array([[0, 127, 128, 255]], np.uint8)
    image_io.imwrite(str(tmp_path / 'x.pbm'), img)
    data = (tmp_path / 'x.pbm').read_bytes()
    assert data == encoded('.pbm', img) == b'P4\n4 1\n\x80'
    assert same_as_opencv(data)[0, :, 0].tolist() == [0, 255, 255, 255]


def test_bgra_pam_has_no_tupltype(tmp_path):
    img = np.arange(24, dtype=np.uint8).reshape(2, 3, 4)
    image_io.imwrite(str(tmp_path / 'x.pam'), img)
    data = (tmp_path / 'x.pam').read_bytes()
    assert data == encoded('.pam', img)
    assert data == (b'P7\nWIDTH 3\nHEIGHT 2\nDEPTH 4\nMAXVAL 255\nENDHDR\n'
                    + img.tobytes())
    # OpenCV reads no DEPTH 4 PAM without a TUPLTYPE, and the port neither
    assert opencv(data) is None
    with pytest.raises(ValueError, match='OpenCV does not read it either'):
        image_io.imdecode(data)


def test_pfm_round_trip_saturates_unscaled(tmp_path):
    img = np.array([[[0, .5, 1], [2, -1, .004]]], np.float32)
    image_io.imwrite(str(tmp_path / 'x.pfm'), img)
    data = (tmp_path / 'x.pfm').read_bytes()
    assert data == encoded('.pfm', img)
    assert data.startswith(b'PF\n2 1\n-1\n')
    got = same_as_opencv(data)
    assert got.reshape(-1).tolist() == [0, 0, 1, 2, 0, 0]


@pytest.mark.parametrize('ext,img', [
    ('.ppm', np.zeros((2, 3), np.uint8)),
    ('.pgm', np.zeros((2, 3, 3), np.uint8)),
    ('.pbm', np.zeros((2, 3, 3), np.uint8)),
    ('.pnm', np.zeros((2, 3, 4), np.uint8)),
    ('.pfm', np.zeros((2, 3, 4), np.float32))])
def test_writers_refuse_where_opencv_refuses(tmp_path, ext, img):
    """Grey to ``.ppm``, colour to ``.pgm`` / ``.pbm``, BGRA to ``.pnm`` /
    ``.pfm``: ``cv2.imencode`` returns False and the port raises, writing
    nothing."""
    assert encoded(ext, img) is None
    path = str(tmp_path / f'x{ext}')
    with pytest.raises(ValueError, match='cv2.imwrite returns False'):
        image_io.imwrite(path, img)
    assert not os.path.exists(path)


# ---- PNM -------------------------------------------------------------------
@pytest.mark.parametrize('kind,maxval', [
    (k, m) for k in range(1, 7) for m in (1, 7, 100, 255, 256, 1000, 65535)
    if k not in (1, 4) or m == 1])                  # a PBM has no maxval
def test_pnm_reads_as_opencv(kind, maxval):
    """Samples above maxval too (ASCII ones cut to it, binary ones as
    stored)."""
    rng = np.random.default_rng(kind * 100 + maxval)
    h, w = 5, 13
    channels = 3 if kind in (3, 6) else 1
    top = 1 if kind in (1, 4) else min(maxval + 2, 65535)
    samples = rng.integers(0, top + 1, (h, w, channels)).squeeze(-1) \
        if channels == 1 else rng.integers(0, top + 1, (h, w, channels))
    if kind >= 5 and maxval <= 255:
        samples = np.minimum(samples, 255)
    same_as_opencv(rf.pnm(kind, samples, maxval))


@pytest.mark.parametrize('header', [
    b'\n# a comment\n5 3\n255\n', b' 5\t3\r255\n', b' #c\n5 #x\n 3\n#y\n255 ',
    b'\n5 3\n#comment before the samples\n255\n', b'\n05 003\n0255\n'])
def test_pnm_header_whitespace_and_comments(header):
    """Comments anywhere whitespace may stand (OpenCV reads a number's
    end as the one byte after its digits)."""
    rng = np.random.default_rng(3)
    samples = rng.integers(0, 256, (3, 5, 3))
    same_as_opencv(rf.pnm(6, samples, header=header))
    same_as_opencv(rf.pnm(3, samples, header=header))


def test_ascii_pbm_digits_need_no_separator():
    bits = np.random.default_rng(4).integers(0, 2, (4, 9))
    same_as_opencv(rf.pnm(1, bits, sep=b''))
    same_as_opencv(rf.pnm(1, bits, sep=b' \n'))


@pytest.mark.parametrize('data,reason', [
    (b'P5\n2 1\n0\n\x00\x00', 'maxval 0'),
    (b'P5\n2 1\n70000\n' + bytes(8), 'past 65535'),
    (b'P2\n2 1\n255\n1 x\n', 'unexpected byte'),
    (b'P6\n5#x\n 3\n255\n' + bytes(45), 'unexpected byte')])
def test_pnm_refusals(data, reason):
    assert opencv(data) is None
    with pytest.raises(ValueError, match=reason):
        image_io.imdecode(data)


# ---- PAM -------------------------------------------------------------------
@pytest.mark.parametrize('depth,tupltype', [
    (1, None), (1, b'GRAYSCALE'), (1, b'BLACKANDWHITE'), (3, None),
    (3, b'RGB')])
@pytest.mark.parametrize('maxval', [1, 15, 255, 256, 4000])
def test_pam_reads_as_opencv(depth, tupltype, maxval):
    if tupltype == b'BLACKANDWHITE' and maxval != 1 and maxval > 255:
        maxval = 255
    rng = np.random.default_rng(depth * 10 + maxval)
    samples = rng.integers(0, maxval + 1, (4, 11, depth))
    data = rf.pam(samples, depth, maxval, tupltype)
    want = opencv(data)
    if want is None:        # DEPTH 3 past 255 without a TUPLTYPE
        with pytest.raises(ValueError, match='OpenCV does not read it '
                           'either'):
            image_io.imdecode(data)
        return
    same_as_opencv(data)


@pytest.mark.parametrize('depth,tupltype', [(2, b'GRAYSCALE_ALPHA'),
                                            (4, b'RGB_ALPHA')])
def test_pam_with_alpha_is_refused(depth, tupltype):
    """OpenCV 5.0 converts the first width / DEPTH pixels of each row of a
    DEPTH 2 or 4 PAM and leaves the rest of its array unset: the port
    refuses such a file, saying so."""
    samples = np.random.default_rng(depth).integers(0, 256, (3, 16, depth))
    data = rf.pam(samples, depth, 255, tupltype)
    want = opencv(data)
    assert want is not None and want.shape == (3, 16, 3)
    with pytest.raises(ValueError, match='leaves the rest unset'):
        image_io.imdecode(data)


@pytest.mark.parametrize('lines', [
    [b'WIDTH 2', b'HEIGHT 1', b'DEPTH 1'],
    [b'WIDTH 2', b'HEIGHT 1', b'DEPTH 1', b'MAXVAL 255', b'TUPLTYPE RGB'],
    [b'WIDTH 2', b'HEIGHT 1', b'DEPTH 1', b'MAXVAL 255', b'TUPLTYPE rgb'],
    [b'WIDTH 2', b'HEIGHT 1', b'DEPTH 1', b'MAXVAL 70000'],
    [b'WIDTH 2', b'HEIGHT 1', b'DEPTH 1', b'MAXVAL 255', b'COLOUR 3']])
def test_pam_header_refusals(lines):
    data = rf.pam(np.zeros((1, 2, 1)), 1, 255, lines=lines)
    assert opencv(data) is None
    with pytest.raises(ValueError, match='OpenCV does not read it either'):
        image_io.imdecode(data)


def test_pam_header_comments_and_blank_lines():
    samples = np.random.default_rng(5).integers(0, 256, (3, 4, 3))
    lines = [b'# made by hand', b'WIDTH 4', b'', b'HEIGHT 3', b'  DEPTH 3',
             b'MAXVAL 255', b'TUPLTYPE RGB']
    same_as_opencv(rf.pam(samples, 3, 255, lines=lines))


# ---- PFM -------------------------------------------------------------------
@pytest.mark.parametrize('scale', [-1.0, 1.0, -2.0, 0.5, -1e-3])
@pytest.mark.parametrize('grey', [False, True])
def test_pfm_reads_as_opencv(scale, grey):
    """Either byte order, rows bottom-up, the samples over |scale|, rounded
    and saturated: NaN, infinities and negatives included. A grey PFM
    decodes to (H, W), as OpenCV 5.0 returns it."""
    rng = np.random.default_rng(int(abs(scale) * 1000) + grey)
    shape = (6, 7) if grey else (6, 7, 3)
    samples = rng.normal(0.3, 0.5, shape).astype(np.float32) * 300
    samples.reshape(-1)[:4] = [np.nan, np.inf, -np.inf, 3e9]
    got = same_as_opencv(rf.pfm(samples, scale))
    assert got.ndim == (2 if grey else 3)


@pytest.mark.parametrize('data', [
    b'PF\r2 1\n-1\n' + bytes(24), b'PF\n2 1\n0\n' + bytes(24),
    b'PF\n2 1\n-1\n' + bytes(23)])
def test_pfm_refusals(data):
    assert opencv(data) is None
    with pytest.raises(ValueError):
        image_io.imdecode(data)


# ---- the writers -----------------------------------------------------------
@pytest.mark.parametrize('ext', ['.pbm', '.pgm', '.ppm', '.pnm', '.pam',
                                 '.pfm'])
def test_writer_bytes_equal_opencv(tmp_path, ext):
    """Every array each writer takes, at sizes whose rows end inside a
    byte (PBM): uint8, uint16 and float32 of 1, 3 and 4 channels; what
    OpenCV refuses the port refuses."""
    rng = np.random.default_rng(len(ext))
    path = str(tmp_path / f'x{ext}')
    for h, w in ((1, 1), (3, 5), (7, 17)):
        for channels in (1, 3, 4):
            for dtype, top in ((np.uint8, 256), (np.uint16, 65536),
                               (np.float32, 300)):
                shape = (h, w) if channels == 1 else (h, w, channels)
                img = (rng.normal(top / 3, top / 3, shape) if dtype ==
                       np.float32 else rng.integers(0, top, shape)
                       ).astype(dtype)
                want = encoded(ext, img)
                if want is None:
                    with pytest.raises(ValueError):
                        image_io.imwrite(path, img)
                    continue
                image_io.imwrite(path, img)
                with open(path, 'rb') as f:
                    assert f.read() == want, (shape, dtype)
                back = opencv(want)
                if back is None:    # a 16-bit grey PAM: no TUPLTYPE
                    with pytest.raises(ValueError, match='OpenCV does not '
                                       'read it either'):
                        image_io.imread(path)
                    continue
                np.testing.assert_array_equal(image_io.imread(path), back)


# ---- robustness -------------------------------------------------------------
def test_cut_and_corrupt_files_raise_and_never_crash():
    """Files cut short or with bytes overwritten, of every form: each
    decode equals OpenCV's array or raises ValueError."""
    rng = np.random.default_rng(6)
    samples = rng.integers(0, 256, (6, 9, 3))
    files = [rf.pnm(k, samples if k in (3, 6) else samples[..., 0] %
                    (2 if k in (1, 4) else 256), 255) for k in range(1, 7)]
    files += [rf.pnm(5, samples[..., 0] * 200, 65535),
              rf.pam(samples, 3, 255, b'RGB'),
              rf.pfm(samples.astype(np.float32), -1.0)]
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
    assert raised > 100
