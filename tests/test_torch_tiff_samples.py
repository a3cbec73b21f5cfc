"""TIFF sample forms against ``cv2.imdecode(..., IMREAD_COLOR)``, bit for
bit, through ``utils/image_io`` from bytes and from a path:

- signed samples (SampleFormat 2) at 1, 8 and 16 bits, read by their bits
  as the unsigned ones (grey 16 bits by the high byte, RGB as
  (v + 128) / 257, palette indices, alpha, planar, MinIsWhite);
- FillOrder 2 under every compression that reverses bits (none, LZW,
  deflate, PackBits, 1-bit) and a JPEG-compressed file (JPEG does not);
- old-style (LSB-first) LZW, strips and tiles, 8 and 16 bits, Predictor 2;
- every TIFF form OpenCV does not read: the reader raises saying so,
  ``cv2.imdecode`` gives no image (JPEG XL: an all-black one), and
  ``tools.serve`` answers each with a 400 that gives the reason; no message
  of ``csrc/tiff.cpp`` names a ROADMAP item."""

import http.client
import io
import json
import os
import threading
from http.server import HTTPServer

import cv2
import numpy as np
import pytest
from PIL import Image

import tiff_forms as tf
from jpeg_forms import seeded_samples
from orientedobjectdetection_torch.tools import serve
from orientedobjectdetection_torch.utils import image_io

H, W = 27, 39


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


# (samples a pixel, photometric, extra tags)
SIGNED = {'grey': (1, 1, {}), 'minwhite': (1, 0, {}), 'rgb': (3, 2, {}),
          'rgba-unassociated': (4, 2, {338: (tf.SHORT, [2])}),
          'rgba-associated': (4, 2, {338: (tf.SHORT, [1])}),
          'grey-alpha': (2, 1, {338: (tf.SHORT, [2])})}


@pytest.mark.parametrize('layout', [
    dict(rows_per_strip=5), dict(planar=2, compression=5, order='>'),
    dict(tile=(16, 16), compression=8, predictor=2),
    dict(tile=(16, 16), planar=2, compression=32773, order='>')])
@pytest.mark.parametrize('form', sorted(SIGNED))
@pytest.mark.parametrize('bits', [8, 16])
def test_signed_samples(tmp_path, bits, form, layout):
    spp, photometric, tags = SIGNED[form]
    s = seeded_samples(bits + spp, H, W, spp, bits)
    want = held(tf.tiff(s, bits, photometric,
                        tags={339: (tf.SHORT, [2] * spp), **tags},
                        **layout), tmp_path)
    if form == 'grey' and bits == 16 and 'tile' not in layout:
        np.testing.assert_array_equal(want[..., 0], s[..., 0] >> 8)


@pytest.mark.parametrize('bits,photometric,spp,extra', [
    (bits, photometric, spp, extra) for bits in (8, 16)
    for photometric, spp, extra in ((1, 1, []), (0, 1, []), (1, 2, [2]),
                                    (1, 2, [0]), (3, 2, [0]))
    if photometric != 3 or bits == 8])
def test_tiles_cut_at_the_right_edge(tmp_path, bits, photometric, spp,
                                     extra):
    """libtiff's grey and palette put routines step a tile cut at the
    image's right edge on by its hidden width in bytes, not pixels: 16-bit
    grey and 8-bit grey or palette with extra samples read the edge tiles'
    rows from there (unsigned samples too)."""
    tags = {338: (tf.SHORT, extra)} if extra else {}
    if photometric == 3:
        tags[320] = (tf.SHORT, list(np.random.default_rng(2).integers(
            0, 65536, 3 << bits)))
    s = seeded_samples(spp, H, W, spp, bits)
    for tile in ((16, 16), (32, 16)):
        held(tf.tiff(s, bits, photometric, tile=tile, compression=8,
                     tags=tags), tmp_path)


@pytest.mark.parametrize('bits', [1, 4, 8])
def test_signed_palette_and_one_bit(tmp_path, bits):
    n = 1 << bits
    cmap = list(np.random.default_rng(bits).integers(0, 65536, 3 * n))
    s = seeded_samples(bits, H, W, 1, bits)
    held(tf.tiff(s, bits, 3, tags={339: (tf.SHORT, [2]),
                                   320: (tf.SHORT, cmap)}), tmp_path)
    if bits == 1:
        held(tf.tiff(s, 1, 0, tags={339: (tf.SHORT, [2])}), tmp_path)


@pytest.mark.parametrize('compression', [1, 5, 8, 32773, 32946])
@pytest.mark.parametrize('bits', [1, 8, 16])
def test_fill_order_2(tmp_path, bits, compression):
    """Each stored byte's bits reversed, then decompressed."""
    spp = 1 if bits == 1 else 3
    s = seeded_samples(compression + bits, H, W, spp, bits)
    layout = dict(tile=(16, 16)) if compression != 1 else \
        dict(rows_per_strip=4)
    held(tf.tiff(s, bits, 0 if bits == 1 else 2, compression=compression,
                 fill_order=2, order='>' if bits == 16 else '<', **layout),
         tmp_path)


@pytest.mark.parametrize('bits,spp,tile', [
    (8, 1, (32, 32)), (8, 4, (16, 16)), (16, 3, (32, 16)), (1, 1, (64, 128)),
    (8, 1, (64, 16))])
def test_uncompressed_tiles_of_1024_bytes(tmp_path, bits, spp, tile):
    """OpenCV reads an uncompressed tile of a multiple of 1024 bytes (and
    no other: the refusals below)."""
    photometric = {1: 1, 3: 2, 4: 2}[spp]
    held(tf.tiff(seeded_samples(bits + spp, 40, 70, spp, bits), bits,
                 photometric, tile=tile), tmp_path)


def test_fill_order_2_jpeg(tmp_path):
    """libtiff's JPEG codec takes its bytes as stored whatever the
    FillOrder."""
    buf = io.BytesIO()
    Image.fromarray(seeded_samples(7, H, W, 3).astype(np.uint8)).save(
        buf, 'TIFF', compression='jpeg')
    held(tf.retag(buf.getvalue(), {266: (tf.SHORT, [2])}), tmp_path)


@pytest.mark.parametrize('layout', [
    dict(rows_per_strip=5), dict(rows_per_strip=9, predictor=2),
    dict(tile=(16, 32), order='>'), dict(planar=2, predictor=2,
                                         fill_order=2)])
@pytest.mark.parametrize('bits', [8, 16])
def test_old_style_lzw(tmp_path, bits, layout):
    s = seeded_samples(bits, H, W, 3, bits)
    held(tf.tiff(s, bits, 2, compression=5, old_lzw=True, **layout),
         tmp_path)


def test_old_style_lzw_table_fills_and_clears(tmp_path):
    """A 64 x 80 strip of noise: the codes widen to 12 bits, the table
    fills and is cleared."""
    s = np.random.default_rng(3).integers(0, 256, (64, 80, 3))
    held(tf.tiff(s, 8, 2, compression=5, old_lzw=True), tmp_path)


def jpeg12_strip():
    """A JPEG-compressed TIFF declaring 12-bit samples."""
    return tf.build([bytes(64)], 8, 8, 12, 3, 2, compression=7)


def raw_samples(bits, spp, fmt, **kwargs):
    return tf.build([bytes(8 * 8 * spp * bits // 8)], 8, 8, bits, spp,
                    1 if spp == 1 else 2,
                    tags={339: (tf.SHORT, [fmt] * spp)}, **kwargs)


# form -> (the file, what the refusal names)
REFUSED = {
    **{f'float{bits}-{kind}': (raw_samples(bits, spp, 3),
                               'floating-point samples')
       for bits in (16, 24, 32, 64)
       for kind, spp in (('grey', 1), ('rgb', 3))},
    'signed32': (raw_samples(32, 1, 2), '32-bit signed'),
    'complex-int32': (raw_samples(32, 1, 5), 'complex samples'),
    'complex-float64': (raw_samples(64, 1, 6), 'complex samples'),
    'predictor3': (tf.tiff(seeded_samples(1, 8, 8, 3), 8, 2, compression=5,
                           predictor=3), 'floating-point predictor'),
    'old-jpeg': (tf.tiff(seeded_samples(2, 8, 8, 3), 8, 2, compression=6),
                 'old-style JPEG'),
    'lzma': (tf.tiff(seeded_samples(3, 8, 8, 3), 8, 2, compression=34925),
             'LZMA'),
    'zstd': (tf.tiff(seeded_samples(4, 8, 8, 3), 8, 2, compression=50000),
             'ZSTD'),
    'webp': (tf.tiff(seeded_samples(5, 8, 8, 3), 8, 2, compression=50001),
             'WebP'),
    'lerc': (tf.tiff(seeded_samples(6, 8, 8, 3), 8, 2, compression=34887),
             'LERC'),
    'jpeg-xl': (tf.tiff(seeded_samples(7, 8, 8, 3), 8, 2,
                        compression=50002), 'JPEG XL'),
    'jpeg-12-bit': (jpeg12_strip(), '12-bit JPEG'),
    'icc-lab': (tf.tiff(seeded_samples(8, 8, 8, 3), 8, 9), 'ICC L'),
    'itu-lab': (tf.tiff(seeded_samples(9, 8, 8, 3), 8, 10), 'ITU L'),
    'rgb-5-samples': (tf.tiff(seeded_samples(10, 8, 8, 5), 8, 2, tags={
        338: (tf.SHORT, [0, 0])}), '5 samples a pixel'),
    'cmyk-5-samples': (tf.tiff(seeded_samples(11, 8, 8, 5), 8, 5, tags={
        338: (tf.SHORT, [2])}), '5 samples a pixel'),
    'uncompressed-tiles-768': (tf.tiff(seeded_samples(12, 20, 20, 3), 8, 2,
                                       tile=(16, 16)), '768 bytes'),
    'uncompressed-tiles-planar-256': (tf.tiff(
        seeded_samples(13, 20, 20, 3), 8, 2, tile=(16, 16), planar=2),
        '256 bytes'),
    'ccitt-8-bit': (tf.build([bytes(30)], 8, 8, 8, 1, 1, compression=4),
                    'CCITT'),
}


@pytest.mark.parametrize('form', sorted(REFUSED))
def test_refused_as_opencv_refuses(form):
    data, why = REFUSED[form]
    want = opencv(data)
    if form == 'jpeg-xl':          # OpenCV returns an all-black image
        assert want is not None and not want.any()
    else:
        assert want is None
    with pytest.raises(ValueError, match=why + '.*OpenCV does not read '
                       '(it|them) either'):
        image_io.imdecode(data)


def test_serve_answers_refusals_with_400():
    """``tools.serve`` answers each refused form, raw and base64, with a
    400 that gives the reader's reason (the body never reaches a model)."""
    import base64
    server = HTTPServer(('127.0.0.1', 0), serve.make_handler(None, 0.3))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        for form, (data, why) in sorted(REFUSED.items()):
            for body in (data, base64.b64encode(data)):
                conn = http.client.HTTPConnection(*server.server_address[:2],
                                                  timeout=30)
                conn.request('POST', '/predict', body=body)
                reply = conn.getresponse()
                answer = json.loads(reply.read())
                conn.close()
                assert reply.status == 400, form
                assert why in answer['error'] and \
                    'OpenCV does not read' in answer['error'], answer
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def test_no_reader_message_names_a_roadmap_item():
    source = os.path.join(os.path.dirname(image_io.__file__), '..', 'csrc',
                          'tiff.cpp')
    with open(source) as f:
        text = f.read()
    assert 'ROADMAP' not in text and 'A.4d' not in text
