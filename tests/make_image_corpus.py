"""Writes ``tests/image_corpus/``: small TIFF and JPEG files of the forms
``chip_smoke.py`` phase 57 holds the card machine's build of the port's
readers to, by the SHA-256 of OpenCV's decode (``CORPUS_DIGESTS``). Made
with PIL, OpenCV's writers (its ``IMWRITE_TIFF_COMPRESSION`` values) and the
test builders ``tiff_forms.py`` / ``jpeg_forms.py`` for what neither writes.

    python tests/make_image_corpus.py      # from the repo's root

The files are committed; rerunning rewrites them (PIL's and OpenCV's bytes
may differ between their versions, so the digests are computed anew by
``tests/test_torch_chip_smoke_tiff.py`` from the committed files).
"""

from __future__ import annotations

import io
import os
import sys

import cv2
import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import jpeg_forms as jf  # noqa: E402
import tiff_forms as tf  # noqa: E402

OUT = os.path.join(HERE, 'image_corpus')
H, W = 40, 53


def samples(seed, channels, bits=8, h=H, w=W):
    if bits > 8 and (h, w) == (H, W):      # smaller: 16-bit files are big
        h, w = 24, 33
    return jf.seeded_samples(seed, h, w, channels, bits)


def pil_bytes(img, fmt, **kwargs):
    buf = io.BytesIO()
    img.save(buf, fmt, **kwargs)
    return buf.getvalue()


def files() -> dict:
    out = {}
    rgb = samples(1, 3)
    out['tiles-deflate-predictor.tif'] = tf.tiff(
        rgb, 8, 2, tile=(16, 16), compression=8, predictor=2)
    out['planar-lzw.tif'] = tf.tiff(rgb, 8, 2, planar=2, compression=5,
                                    rows_per_strip=8)
    out['bigtiff-be-16bit-predictor.tif'] = tf.tiff(
        samples(2, 3, 16), 16, 2, big=True, order='>', compression=5,
        predictor=2, rows_per_strip=10)
    out['tiles-planar-bigtiff-be.tif'] = tf.tiff(
        samples(3, 3, 16), 16, 2, tile=(16, 16), planar=2, big=True,
        order='>', compression=32773)
    out['multipage.tif'] = tf.tiff(rgb, 8, 2, pages=3, compression=5)
    out['orientation-6.tif'] = tf.tiff(
        rgb, 8, 2, compression=5, tags={274: (tf.SHORT, [6])})
    out['orientation-3-grey.tif'] = tf.tiff(
        samples(4, 1), 8, 1, tags={274: (tf.SHORT, [3])})
    out['minwhite-1bit.tif'] = tf.tiff(samples(5, 1) > 128, 1, 0,
                                       compression=32773)
    out['grey-16bit.tif'] = tf.tiff(samples(6, 1, 16), 16, 1, compression=8)
    out['cmyk.tif'] = tf.tiff(samples(7, 4), 8, 5, compression=5,
                              predictor=2)
    out['rgba-unassociated-16bit.tif'] = tf.tiff(
        samples(8, 4, 16), 16, 2, tags={338: (tf.SHORT, [2])})
    cmap = list(np.random.default_rng(9).integers(0, 65536, 3 * 16))
    out['palette-4bit.tif'] = tf.tiff(samples(9, 1, 4), 4, 3,
                                      tags={320: (tf.SHORT, cmap)})
    y = samples(10, 1)[..., 0]
    cb = samples(11, 1, h=-(-H // 2), w=-(-W // 2))[..., 0]
    cr = samples(12, 1, h=-(-H // 2), w=-(-W // 2))[..., 0]
    out['ycbcr-22-refbw.tif'] = tf.build(
        [tf.ycbcr_units(y, cb, cr, 2, 2)], H, W, 8, 3, 6,
        tags={530: (tf.SHORT, [2, 2]),
              532: (tf.RATIONAL, [(16, 1), (235, 1), (128, 1), (240, 1),
                                  (128, 1), (240, 1)])})
    img8 = samples(13, 4).astype(np.uint8)
    out['pil-rgba.tif'] = pil_bytes(Image.fromarray(img8, 'RGBA'), 'TIFF',
                                    compression='tiff_lzw')
    out['pil-palette.tif'] = pil_bytes(
        Image.fromarray(img8[..., :3].copy()).quantize(60), 'TIFF',
        compression='packbits')
    out['pil-jpeg.tif'] = pil_bytes(Image.fromarray(img8[..., :3].copy()),
                                    'TIFF', compression='jpeg', quality=90)
    bgr = img8[..., :3].copy()
    for name, comp in (('none', 1), ('packbits', 32773), ('deflate', 8)):
        out[f'cv2-{name}.tif'] = cv2.imencode(
            '.tif', bgr, [cv2.IMWRITE_TIFF_COMPRESSION, comp])[1].tobytes()
    out['cv2-16bit.tif'] = cv2.imencode(
        '.tif', samples(14, 3, 16).astype(np.uint16))[1].tobytes()
    # the JPEG forms
    four = samples(15, 4)
    out['cmyk.jpg'] = pil_bytes(Image.fromarray(four.astype(np.uint8),
                                                'CMYK'), 'JPEG', quality=90)
    out['ycck.jpg'] = jf.dct_jpeg(four, markers=jf.adobe(2), sampling=[
        (2, 2), (1, 1), (1, 1), (2, 2)])
    out['arithmetic-progressive.jpg'] = jf.dct_jpeg(
        rgb, arithmetic=True, progressive=True, restart=4,
        markers=jf.jfif(), sampling=[(2, 2), (1, 1), (1, 1)])
    out['lossless.jpg'] = jf.lossless_jpeg(rgb, predictor=7, pt=1,
                                           restart=W * 5)
    out['12-bit.jpg'] = jf.dct_jpeg(samples(16, 1, 12), precision=12)
    return out


def main():
    os.makedirs(OUT, exist_ok=True)
    made = files()
    for name, data in sorted(made.items()):
        with open(os.path.join(OUT, name), 'wb') as f:
            f.write(data)
    print(f'{len(made)} files, {sum(map(len, made.values()))} bytes in '
          f'{OUT}')


if __name__ == '__main__':
    main()
