"""The port's TIFF codec (``csrc/tiff.cpp`` through ``native.py`` and
``utils/image_io.py``) against OpenCV, bit for bit:

- the reader against ``cv2.imdecode(..., cv2.IMREAD_COLOR)`` on files of
  ``tests/tiff_forms.py`` (grey and MinIsWhite at 1, 8 and 16 bits, RGB at
  8 and 16 with and without alpha, palette at 1-8 bits with 8- and 16-bit
  colormaps, CMYK, subsampled YCbCr with and without ReferenceBlackWhite,
  strips and tiles, planar or not, both byte orders, BigTIFF, Predictor 2,
  every compression read, orientations 1-8, more pages), on PIL's files
  (RGBA, grey + alpha, palette, 1-bit, 16-bit, CMYK, JPEG-compressed
  YCbCr) and on OpenCV's own (its ``IMWRITE_TIFF_COMPRESSION`` values);
  ``imread`` against ``cv2.imread`` on disk;
- the writer's bytes against ``cv2.imencode('.tif')`` (and ``imwrite`` on
  ``.tif`` / ``.tiff`` paths), BGR and grey, across strip boundaries;
  ``imwrite`` writes OpenCV's PNM, PAM, PFM, Sun raster, HDR and GIF
  bytes and a lossless WebP of OpenCV's pixels, and refuses the forms
  OpenCV writes that the port does not yet (ROADMAP A.4d) and extensions
  OpenCV has no writer for;
- the forms OpenCV refuses (2-bit samples, 4-bit grey) raise saying so;
  the TIFF forms ROADMAP A.4d once listed are read as OpenCV reads them or
  refused as OpenCV refuses them (``tests/test_torch_tiff_*.py`` hold each
  new form in full); files of the other formats OpenCV reads decode to
  its array (PNM, PAM, PFM, Sun raster, Radiance HDR, GIF, lossless WebP)
  or raise naming ROADMAP A.4d (lossy WebP, JPEG 2000, AVIF);
- truncated and corrupt files raise ``ValueError`` and never crash the
  process; a header past 2^30 pixels is refused before allocating;
- 8 threads decode at once (ctypes releases the GIL) to the serial result;
- the port's ``tools/img_split.py:split_one`` and the JAX package's cut one
  ``.tif`` scene into the same windows (``img_ext='.tif'``: the same bytes)
  and annotation files.
"""

import importlib.util
import io
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import cv2
import numpy as np
import pytest
from PIL import Image

import tiff_forms as tf
from orientedobjectdetection_torch import native
from orientedobjectdetection_torch.utils import image_io

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..')
H, W = 37, 53


def smooth(h, w, channels, bits, seed=0):
    rng = np.random.default_rng(seed)
    top = (1 << bits) - 1
    noise = rng.integers(0, top + 1, (h + 2, w + 2, channels))
    box = sum(noise[dy:dy + h, dx:dx + w] for dy in range(3)
              for dx in range(3)) // 9
    grad = (np.arange(h)[:, None, None] * top // h +
            np.arange(w)[None, :, None] * top // w) // 2
    return np.clip(box // 2 + grad // 2, 0, top)


def pil_tiff(img, **kwargs):
    buf = io.BytesIO()
    img.save(buf, 'TIFF', **kwargs)
    return buf.getvalue()


def built_forms():
    """name -> TIFF bytes of tests/tiff_forms.py."""
    forms = {}
    rng = np.random.default_rng(0)
    for bits in (1, 8, 16):
        for ph in (0, 1):
            s = smooth(H, W, 1, bits, bits)
            forms[f'grey{bits}-photometric{ph}'] = tf.tiff(s, bits, ph)
            forms[f'grey{bits}-photometric{ph}-lzw-strips'] = tf.tiff(
                s, bits, ph, compression=5, rows_per_strip=5)
    for bits in (8, 16):
        s = smooth(H, W, 3, bits, 3 + bits)
        for comp in (1, 5, 8, 32773, 32946):
            forms[f'rgb{bits}-compression{comp}'] = tf.tiff(
                s, bits, 2, compression=comp, rows_per_strip=7)
        forms[f'rgb{bits}-predictor'] = tf.tiff(
            s, bits, 2, compression=5, predictor=2, rows_per_strip=7)
        forms[f'rgb{bits}-predictor-big-endian'] = tf.tiff(
            s, bits, 2, compression=8, predictor=2, rows_per_strip=7,
            order='>')
        forms[f'rgb{bits}-predictor-ignored-uncompressed'] = tf.tiff(
            s, bits, 2, predictor=2)
        forms[f'rgb{bits}-planar'] = tf.tiff(
            s, bits, 2, planar=2, compression=5, predictor=2,
            rows_per_strip=9)
        forms[f'rgb{bits}-tiles'] = tf.tiff(
            s, bits, 2, tile=(16, 16), compression=8, predictor=2)
        forms[f'rgb{bits}-tiles-planar-bigtiff-big-endian'] = tf.tiff(
            s, bits, 2, tile=(16, 32), planar=2, big=True, order='>',
            compression=5)
        forms[f'rgb{bits}-bigtiff'] = tf.tiff(s, bits, 2, big=True,
                                              compression=32773)
        a = smooth(H, W, 4, bits, 5 + bits)
        for es in (0, 1, 2):
            forms[f'rgba{bits}-extrasamples{es}'] = tf.tiff(
                a, bits, 2, tags={338: (tf.SHORT, [es])})
            forms[f'rgba{bits}-extrasamples{es}-planar'] = tf.tiff(
                a, bits, 2, planar=2, tags={338: (tf.SHORT, [es])})
        forms[f'rgba{bits}-no-extrasamples'] = tf.tiff(a, bits, 2)
    for bits in (1, 4, 8):
        n = 1 << bits
        forms[f'palette{bits}-16-bit-colormap'] = tf.tiff(
            smooth(H, W, 1, bits, 9), bits, 3,
            tags={320: (tf.SHORT, list(rng.integers(0, 65536, 3 * n)))})
        forms[f'palette{bits}-8-bit-colormap'] = tf.tiff(
            smooth(H, W, 1, bits, 10), bits, 3, compression=32773,
            tags={320: (tf.SHORT, list(rng.integers(0, 256, 3 * n)))})
    forms['cmyk'] = tf.tiff(smooth(H, W, 4, 8, 11), 8, 5, compression=5,
                            predictor=2)
    forms['cmyk-planar'] = tf.tiff(smooth(H, W, 4, 8, 12), 8, 5, planar=2)
    ga = smooth(H, W, 2, 8, 13)
    forms['grey-alpha'] = tf.tiff(ga, 8, 1, tags={338: (tf.SHORT, [2])})
    forms['grey-alpha-planar'] = tf.tiff(ga, 8, 1, planar=2,
                                         tags={338: (tf.SHORT, [2])})
    forms['grey-alpha-planar-minwhite'] = tf.tiff(
        ga, 8, 0, planar=2, tags={338: (tf.SHORT, [2])})
    forms['grey16-alpha'] = tf.tiff(smooth(H, W, 2, 16, 14), 16, 1,
                                    tags={338: (tf.SHORT, [1])})
    for o in range(1, 9):
        forms[f'orientation{o}'] = tf.tiff(
            smooth(H, W, 3, 8, 15), 8, 2, compression=5,
            tags={274: (tf.SHORT, [o])})
    forms['three-pages'] = tf.tiff(smooth(H, W, 3, 8, 16), 8, 2, pages=3)
    for sh, sv in ((1, 1), (2, 1), (2, 2), (4, 2), (4, 4), (4, 1), (1, 2)):
        y = smooth(H, W, 1, 8, 17)[..., 0]
        cb = smooth(-(-H // sv), -(-W // sh), 1, 8, 18)[..., 0]
        cr = smooth(-(-H // sv), -(-W // sh), 1, 8, 19)[..., 0]
        rps = H if sv == 1 else sv * 4
        blocks = [tf.ycbcr_units(y[y0:y0 + rps],
                                 cb[y0 // sv:(y0 + rps) // sv],
                                 cr[y0 // sv:(y0 + rps) // sv], sh, sv)
                  for y0 in range(0, H, rps)]
        for ref in (None, [(16, 1), (235, 1), (128, 1), (240, 1), (128, 1),
                           (240, 1)]):
            tags = {530: (tf.SHORT, [sh, sv])}
            if ref:
                tags[532] = (tf.RATIONAL, ref)
            forms[f'ycbcr{sh}{sv}{"-refbw" if ref else ""}'] = tf.build(
                blocks, H, W, 8, 3, 6, rows_per_strip=rps, tags=tags)
    forms['ycbcr-planar-coefficients'] = tf.tiff(
        smooth(H, W, 3, 8, 20), 8, 6, planar=2,
        tags={530: (tf.SHORT, [1, 1]),
              529: (tf.RATIONAL, [(2990, 10000), (5870, 10000),
                                  (1140, 10000)])})
    return forms


def pil_forms():
    base = smooth(H, W, 4, 8, 21).astype(np.uint8)
    images = {'RGBA': Image.fromarray(base, 'RGBA'),
              'LA': Image.fromarray(base[..., :2].copy(), 'LA'),
              'P': Image.fromarray(base[..., :3].copy()).quantize(50),
              '1': Image.fromarray(base[..., 0] > 128),
              'L': Image.fromarray(base[..., 0].copy()),
              'I;16': Image.fromarray(
                  smooth(H, W, 1, 16, 22)[..., 0].astype(np.uint16)),
              'CMYK': Image.fromarray(base, 'CMYK'),
              'RGB': Image.fromarray(base[..., :3].copy())}
    forms = {}
    for comp in ('raw', 'tiff_lzw', 'tiff_adobe_deflate', 'packbits'):
        for mode, img in images.items():
            forms[f'pil-{mode}-{comp}'] = pil_tiff(img, compression=comp)
    for mode in ('RGB', 'L', 'CMYK'):
        forms[f'pil-{mode}-jpeg'] = pil_tiff(images[mode], compression='jpeg')
    for q in (50, 95):
        forms[f'pil-RGB-jpeg-q{q}'] = pil_tiff(images['RGB'],
                                               compression='jpeg', quality=q)
    return forms


def opencv_forms():
    base = smooth(H, W, 4, 8, 23).astype(np.uint8)
    forms = {}
    for comp in (1, 5, 7, 8, 32773, 32946):
        for name, img in (('bgr', base[..., :3].copy()),
                          ('grey', base[..., 0].copy()),
                          ('bgr16', smooth(H, W, 3, 16, 24)
                           .astype(np.uint16))):
            ok, data = cv2.imencode('.tif', img,
                                    [cv2.IMWRITE_TIFF_COMPRESSION, comp])
            if ok:
                forms[f'cv2-{name}-compression{comp}'] = data.tobytes()
    forms['cv2-bgra'] = cv2.imencode('.tif', base)[1].tobytes()
    return forms


FORMS = {**built_forms(), **pil_forms(), **opencv_forms()}


def opencv(data):
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)


@pytest.mark.parametrize('name', sorted(FORMS))
def test_reader_equals_opencv(name):
    data = FORMS[name]
    want = opencv(data)
    assert want is not None
    got = image_io.imdecode(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('orientation', [1, 2, 3, 4])
def test_imread_equals_opencv_imread(tmp_path, orientation):
    """On disk, ``imread`` against ``cv2.imread`` (OpenCV 5.0's imread
    gives no image for the transposing orientations 5-8, which
    ``cv2.imdecode`` and the port read: the test above holds those)."""
    path = str(tmp_path / 'o.tif')
    with open(path, 'wb') as f:
        f.write(FORMS[f'orientation{orientation}'])
    np.testing.assert_array_equal(image_io.imread(path),
                                  cv2.imread(path, cv2.IMREAD_COLOR))


@pytest.mark.parametrize('bits,photometric', [(2, 1), (2, 3), (4, 0),
                                              (4, 1)])
def test_forms_opencv_refuses_raise(bits, photometric):
    """OpenCV's reader takes 1, 8 or 16 bits (and 4 in a palette)."""
    tags = {320: (tf.SHORT, [0] * (3 << bits))} if photometric == 3 else {}
    data = tf.tiff(smooth(8, 8, 1, bits), bits, photometric, tags=tags)
    assert opencv(data) is None
    with pytest.raises(ValueError, match='OpenCV does not read them either'):
        image_io.imdecode(data)


# The TIFF forms ROADMAP A.4d once listed, by the name the reader's refusal
# gave each: now read as OpenCV reads them, or refused as OpenCV refuses
# them ('black': OpenCV gives an all-black image)
LATER = {
    'CCITT': ('read', dict(ccitt=4)),
    'CCITT-compressed TIFF': ('read', dict(ccitt=3)),
    'old-style JPEG': ('refused', dict(compression=6)),
    'LZMA': ('refused', dict(compression=34925)),
    'ZSTD': ('refused', dict(compression=50000)),
    'WebP': ('refused', dict(compression=50001)),
    'JPEG XL': ('black', dict(compression=50002)),
    'LERC': ('refused', dict(compression=34887)),
    'floating-point samples': ('refused',
                               dict(tags={339: (tf.SHORT, [3] * 3)})),
    'signed samples': ('read', dict(tags={339: (tf.SHORT, [2] * 3)})),
    'FillOrder 2': ('read', dict(fill_order=2, compression=5)),
}


@pytest.mark.parametrize('form', sorted(LATER))
def test_forms_left_out_name_roadmap(form):
    """Each form ROADMAP A.4d listed: one now read decodes to OpenCV's
    array; one OpenCV does not read either raises saying so, and
    ``cv2.imdecode`` gives no image for it (JPEG XL: an all-black one)."""
    kind, kwargs = LATER[form]
    kwargs = dict(kwargs)
    ccitt = kwargs.pop('ccitt', None)
    if ccitt:
        data = tf.build([tf.ccitt(smooth(8, 8, 1, 1)[..., 0], ccitt)], 8, 8,
                        1, 1, 0, compression=ccitt)
    else:
        data = tf.tiff(smooth(8, 8, 3, 8), 8, 2, **kwargs)
    want = opencv(data)
    if kind == 'read':
        assert want is not None
        np.testing.assert_array_equal(image_io.imdecode(data), want)
        return
    assert (want is None) if kind == 'refused' else not want.any()
    with pytest.raises(ValueError, match=form + '.*OpenCV does not read '
                       '(it|them) either'):
        image_io.imdecode(data)


def test_old_style_lzw_names_roadmap():
    """Old-style (LSB-first) LZW, which ROADMAP A.4d listed: libtiff reads
    it (LZWDecodeCompat), and the port reads it to OpenCV's array, with
    and without Predictor 2, across strips."""
    for predictor in (1, 2):
        data = tf.tiff(smooth(H, W, 3, 8, 29), 8, 2, compression=5,
                       old_lzw=True, predictor=predictor, rows_per_strip=9)
        want = opencv(data)
        assert want is not None
        np.testing.assert_array_equal(image_io.imdecode(data), want)


@pytest.mark.parametrize('ext,name', [
    ('.webp', 'WebP'), ('lossy .webp', 'lossy WebP'), ('.jp2', 'JPEG 2000'),
    ('.gif', 'GIF'), ('.ppm', 'PNM'), ('.pgm', 'PNM'), ('.pbm', 'PNM'),
    ('.pam', 'PAM'), ('.pfm', 'PFM'), ('.sr', 'Sun raster'),
    ('.hdr', 'Radiance HDR'), ('.avif', 'AVIF')])
def test_other_formats_opencv_reads_name_roadmap(ext, name):
    """Files OpenCV writes and reads: the PNM, PAM, PFM, Sun raster,
    Radiance HDR, GIF and lossless WebP ones decode to OpenCV's array
    (``tests/test_torch_pnm.py``, ``tests/test_torch_sunras_hdr.py``,
    ``tests/test_torch_gif.py`` and ``tests/test_torch_webp.py`` hold each
    form in full); those of a form the port does not read yet (lossy WebP
    among them) raise naming it and ROADMAP A.4d."""
    img = smooth(64, 64, 3, 8, 28).astype(np.uint8)
    if ext in ('.pgm', '.pbm'):
        img = img[..., 0].copy()
    elif ext in ('.pfm', '.hdr'):
        img = img.astype(np.float32) / 255
    lossy = ext.startswith('lossy')
    data = cv2.imencode(ext.split()[-1], img, [cv2.IMWRITE_WEBP_QUALITY, 80]
                        if lossy else [])[1].tobytes()
    want = opencv(data)
    assert want is not None
    if ext in image_io._LATER_WRITERS or lossy:
        with pytest.raises(ValueError, match=name + ' images.*ROADMAP A.4d'):
            image_io.imdecode(data)
        return
    np.testing.assert_array_equal(image_io.imdecode(data), want)


# ---- the writer ------------------------------------------------------------
WRITER_SIZES = [(1, 1), (5, 7), (2, 3), (37, 731), (64, 700), (3, 2184),
                (3, 2185), (2, 3276), (2, 3277), (1, 9000), (9000, 1),
                (300, 700)]


@pytest.mark.parametrize('grey', [False, True])
@pytest.mark.parametrize('h,w', WRITER_SIZES)
def test_writer_bytes_equal_opencv(h, w, grey):
    """Rows per strip 8192 / row bytes, StripByteCounts as SHORT or LONG
    as libtiff chooses, the LZW bytes: all OpenCV's."""
    rng = np.random.default_rng(h * 7 + w)
    img = rng.integers(0, 256, (h, w) if grey else (h, w, 3), np.uint8)
    if h > 4 and w > 4:
        img = cv2.GaussianBlur(img, (5, 5), 2)
    data = native.tiff_encode(img)
    assert data == cv2.imencode('.tif', img)[1].tobytes()
    back, orientation = native.tiff_decode(data)
    assert orientation == 1
    np.testing.assert_array_equal(back, img if not grey else
                                  np.repeat(img[..., None], 3, -1))


@pytest.mark.parametrize('img', ['zeros', 'ramp', 'noise'])
def test_writer_table_resets_equal_opencv(img):
    """Long strips: the LZW table fills and resets, and the ratio check
    clears it (low entropy, a ramp, noise)."""
    img = {'zeros': np.zeros((5, 20000, 3), np.uint8),
           'ramp': np.tile(np.arange(256, dtype=np.uint8),
                           (3, 80))[..., None].repeat(3, -1),
           'noise': np.random.default_rng(1).integers(
               0, 256, (50, 3000, 3), np.uint8)}[img]
    assert native.tiff_encode(img) == cv2.imencode('.tif', img)[1].tobytes()


@pytest.mark.parametrize('suffix', ['.tif', '.tiff', '.TIF'])
def test_imwrite_writes_what_opencv_writes(tmp_path, suffix):
    """``imwrite`` on a TIFF path writes OpenCV's TIFF (it used to write
    PNG bytes there), grey images too."""
    for grey in (False, True):
        img = smooth(61, 47, 1 if grey else 3, 8, 25).astype(np.uint8)
        img = img[..., 0] if grey else img
        port, ref = str(tmp_path / f'p{suffix}'), str(tmp_path / f'r{suffix}')
        image_io.imwrite(port, img)
        cv2.imwrite(ref, img)
        with open(port, 'rb') as f, open(ref, 'rb') as g:
            assert f.read() == g.read()
        np.testing.assert_array_equal(image_io.imread(port), cv2.imread(ref))


def test_imwrite_dib_is_opencv_s_bmp(tmp_path):
    img = smooth(9, 11, 3, 8, 26).astype(np.uint8)
    image_io.imwrite(str(tmp_path / 'p.dib'), img)
    cv2.imwrite(str(tmp_path / 'r.dib'), img)
    assert (tmp_path / 'p.dib').read_bytes() == \
        (tmp_path / 'r.dib').read_bytes()


@pytest.mark.parametrize('ext', [
    '.avif', '.gif', '.hdr', '.jp2', '.pam', '.pbm', '.pfm', '.pgm', '.pic',
    '.pnm', '.ppm', '.ras', '.sr', '.webp'])
def test_imwrite_refuses_forms_left_out(tmp_path, ext):
    """OpenCV writes these (the ``.pbm`` / ``.pgm`` writers grey alone):
    the port writes OpenCV's bytes for the PNM, PAM, PFM, Sun raster,
    Radiance HDR and GIF extensions, a lossless WebP of OpenCV's pixels
    (the port's own coder), and for the others names ROADMAP A.4d and
    writes nothing."""
    img = np.zeros((64, 64, 3), np.uint8)        # OpenJPEG's least size
    img = img[..., 0] if ext in ('.pbm', '.pgm') else img
    path = str(tmp_path / f'x{ext}')
    ref = str(tmp_path / f'r{ext}')
    assert cv2.imwrite(ref, img)
    if ext not in image_io._LATER_WRITERS:
        image_io.imwrite(path, img)
        if ext == '.webp':
            np.testing.assert_array_equal(
                cv2.imread(path, cv2.IMREAD_UNCHANGED),
                cv2.imread(ref, cv2.IMREAD_UNCHANGED))
            return
        assert (tmp_path / f'x{ext}').read_bytes() == \
            (tmp_path / f'r{ext}').read_bytes()
        return
    with pytest.raises(ValueError, match=image_io._LATER_WRITERS[ext] +
                       '.*ROADMAP A.4d'):
        image_io.imwrite(path, img)
    assert not os.path.exists(path)


@pytest.mark.parametrize('name', ['x.xyz', 'x.j2k', 'x.exr', 'noext'])
def test_imwrite_refuses_unknown_extensions(tmp_path, name):
    img = np.zeros((4, 5, 3), np.uint8)
    with pytest.raises(ValueError, match='could not find a writer'):
        image_io.imwrite(str(tmp_path / name), img)
    with pytest.raises(cv2.error, match='could not find a writer'):
        cv2.imwrite(str(tmp_path / ('r' + name)), img)


# ---- robustness -------------------------------------------------------------
def test_truncated_and_corrupt_files_raise_and_never_crash():
    """A few hundred files cut short or with bytes overwritten, of every
    compression and layout: each decode returns an image or raises
    ValueError."""
    rng = np.random.default_rng(2)
    names = ['rgb8-compression5', 'rgb8-compression8', 'rgb8-compression32773',
             'rgb16-tiles-planar-bigtiff-big-endian', 'ycbcr22-refbw',
             'palette4-16-bit-colormap', 'pil-RGB-jpeg', 'cv2-bgr16-'
             'compression5', 'grey1-photometric0-lzw-strips']
    raised = 0
    for name in names:
        data = FORMS[name]
        for trial in range(40):
            bad = bytearray(data[:rng.integers(1, len(data))] if trial < 12
                            else data)
            if trial >= 12:
                for at in rng.integers(0, len(bad), rng.integers(1, 8)):
                    bad[at] = rng.integers(0, 256)
            try:
                img = image_io.imdecode(bytes(bad))
                assert img.dtype == np.uint8 and img.shape[2] == 3
            except ValueError:
                raised += 1
    assert raised > 100


@pytest.mark.parametrize('tiled', [False, True])
def test_images_past_opencvs_pixel_limit_raise(tiled):
    """A 65536 x 65536 header in a few hundred bytes is refused before any
    pixel is allocated."""
    tags = {322: (tf.LONG, [16]), 323: (tf.LONG, [16])} if tiled else {}
    data = tf.build([bytes(16)], 65536, 65536, 8, 1, 1, tags=tags)
    with pytest.raises(ValueError,
                       match='65536 x 65536 pixels exceeds 2\\^30'):
        image_io.imdecode(data)


def test_threads_decode_at_once():
    files = [native.tiff_encode(
        smooth(300, 400, 3, 8, s).astype(np.uint8)) for s in range(4)]
    files += [FORMS[n] for n in ('rgb16-tiles', 'pil-RGB-jpeg',
                                 'rgb8-compression8', 'ycbcr44')]
    serial = [image_io.imdecode(f) for f in files]
    barrier = threading.Barrier(8)

    def decode(i):
        barrier.wait(timeout=30)
        return [image_io.imdecode(files[i]) for _ in range(3)]

    with ThreadPoolExecutor(8) as pool:
        results = [f.result(timeout=120)
                   for f in [pool.submit(decode, i) for i in range(8)]]
    for want, got in zip(serial, results):
        for g in got:
            np.testing.assert_array_equal(g, want)


# ---- the split tool ---------------------------------------------------------
def jax_split_tool():
    spec = importlib.util.spec_from_file_location(
        'jax_img_split', os.path.join(ROOT, 'tools', 'data', 'dota', 'split',
                                      'img_split.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_split_one_tif_matches_jax(tmp_path):
    """One annotated 500 x 420 ``.tif`` scene cut by both tools with
    ``img_ext='.tif'``: the same window names, the same TIFF bytes (both
    write OpenCV's TIFF) and the same annotation files."""
    from orientedobjectdetection_torch.tools import img_split
    scene = tmp_path / 'P0007.tif'
    pixels = smooth(420, 500, 3, 8, 27).astype(np.uint8)
    image_io.imwrite(str(scene), pixels)
    ann = tmp_path / 'P0007.txt'
    lines = []
    for k, (y, x) in enumerate((y, x) for y in range(30, 420, 70)
                               for x in range(30, 500, 70)):
        lines.append(f'{x} {y} {x + 40} {y + 5} {x + 35} {y + 25} {x - 5} '
                     f'{y + 20} {("plane", "ship")[k % 2]} {k % 2}')
    ann.write_text('\n'.join(lines))
    dirs = {}
    for name, tool in (('port', img_split), ('jax', jax_split_tool())):
        img_dir, ann_dir = tmp_path / name / 'images', tmp_path / name / 'ann'
        img_dir.mkdir(parents=True)
        ann_dir.mkdir()
        n = tool.split_one((str(scene), str(ann)), str(img_dir), str(ann_dir),
                           [256], [56], img_ext='.tif')
        assert n > 0
        dirs[name] = (img_dir, ann_dir, n)
    (pi, pa, pn), (ji, ja, jn) = dirs['port'], dirs['jax']
    assert pn == jn
    names = sorted(os.listdir(pi))
    assert names == sorted(os.listdir(ji)) and len(names) == pn
    for name in names:
        assert name.endswith('.tif')
        assert (pi / name).read_bytes() == (ji / name).read_bytes()
        np.testing.assert_array_equal(image_io.imread(str(pi / name)),
                                      cv2.imread(str(ji / name)))
    anns = sorted(os.listdir(pa))
    assert anns == sorted(os.listdir(ja))
    for name in anns:
        assert (pa / name).read_bytes() == (ja / name).read_bytes()
