"""Writes ``tests/image_corpus/``: small TIFF, JPEG, PNM, PAM, PFM, Sun
raster, Radiance HDR, GIF and WebP files of the forms ``chip_smoke.py``
phase 57 holds the card machine's build of the port's readers to, by the
SHA-256 of OpenCV's decode (``CORPUS_DIGESTS``). Made with PIL, OpenCV's
writers (its ``IMWRITE_TIFF_COMPRESSION`` values, SGILog among them), the
port's lossless WebP writer and the test builders ``tiff_forms.py`` /
``jpeg_forms.py`` / ``raster_forms.py`` / ``gif_forms.py`` /
``webp_forms.py`` for what neither writes.

    python tests/make_image_corpus.py      # from the repo's root
    python tests/make_image_corpus.py --raster   # the raster forms alone
    python tests/make_image_corpus.py --gif-webp   # the GIF and WebP forms

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

import gif_forms as gf  # noqa: E402
import jpeg_forms as jf  # noqa: E402
import raster_forms as rf  # noqa: E402
import tiff_forms as tf  # noqa: E402
import webp_forms as wf  # noqa: E402

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
    # the forms of slice 21: CCITT, SGILog, CIE L*a*b*, signed samples,
    # FillOrder 2, old-style LZW, 16-bit grey tiles cut at the right edge,
    # and two forms OpenCV does not read
    bits = (samples(17, 1)[..., 0] > 150).astype(np.int64)
    for name, comp, kwargs, tags in (
            ('rle', 2, {}, {}), ('rlew', 32771, {}, {}),
            ('t4-1d', 3, {}, {292: (tf.LONG, [0])}),
            ('t4-2d-fill', 3, dict(two_d=True, fill_bits=True),
             {292: (tf.LONG, [5])}),
            ('t6', 4, {}, {})):
        out[f'ccitt-{name}.tif'] = tf.build(
            [tf.ccitt(bits[y:y + 16], comp, **kwargs)
             for y in range(0, H, 16)],
            H, W, 1, 1, 0, compression=comp, rows_per_strip=16, tags=tags)
    pad = np.zeros((48, 64), np.int64)
    pad[:H, :W] = bits
    out['ccitt-t6-tiles-fillorder2.tif'] = tf.build(
        [tf.reverse_bits(tf.ccitt(pad[y:y + 16, x:x + 16], 4))
         for y in range(0, 48, 16) for x in range(0, 64, 16)], H, W, 1, 1, 1,
        compression=4, tile=(16, 16), tags={266: (tf.SHORT, [2])})
    out['pil-group4.tif'] = pil_bytes(Image.fromarray(bits.astype(bool)),
                                      'TIFF', compression='group4')
    rng = np.random.default_rng(18)
    radiance = (rng.random((24, 33, 3)) * np.linspace(0.1, 3, 33)[:, None]
                ).astype(np.float32)
    for name, comp in (('logluv', 34676), ('logluv24', 34677)):
        out[f'cv2-{name}.tif'] = cv2.imencode(
            '.tif', radiance,
            [cv2.IMWRITE_TIFF_COMPRESSION, comp])[1].tobytes()
    logl = rng.integers(256 * 52, 256 * 68, (24, 33))
    out['logl-tiles-be.tif'] = tf.build(
        [tf.logl(np.pad(logl, ((0, 8), (0, 15)))[y:y + 16, x:x + 16])
         for y in range(0, 24, 16) for x in range(0, 33, 16)], 24, 33, 16, 1,
        32844, compression=34676, tile=(16, 16), order='>',
        tags={339: (tf.SHORT, [2])})
    out['lab-8bit.tif'] = tf.tiff(samples(19, 3), 8, 8, compression=5,
                                  predictor=2)
    out['lab-16bit-be.tif'] = tf.tiff(samples(20, 3, 16), 16, 8, order='>',
                                      compression=8)
    out['pil-lab.tif'] = pil_bytes(
        Image.fromarray(samples(21, 3).astype(np.uint8)).convert('LAB'),
        'TIFF', compression='tiff_lzw')
    out['signed-16bit-grey.tif'] = tf.tiff(
        samples(22, 1, 16), 16, 1, compression=8,
        tags={339: (tf.SHORT, [2])})
    out['signed-8bit-rgb-planar.tif'] = tf.tiff(
        samples(23, 3), 8, 2, planar=2, compression=32773,
        tags={339: (tf.SHORT, [2] * 3)})
    out['fillorder2-deflate.tif'] = tf.tiff(samples(24, 3), 8, 2,
                                            compression=8, fill_order=2)
    out['old-lzw-predictor.tif'] = tf.tiff(samples(25, 3), 8, 2,
                                           compression=5, old_lzw=True,
                                           predictor=2, rows_per_strip=16)
    out['grey16-tiles-right-edge.tif'] = tf.tiff(
        samples(26, 1, 16), 16, 1, tile=(16, 16), compression=8)
    out['float32.tif'] = tf.build([bytes(8 * 8 * 4)], 8, 8, 32, 1, 1,
                                  tags={339: (tf.SHORT, [3])})
    out['lzma.tif'] = tf.tiff(samples(27, 3, h=8, w=8), 8, 2,
                              compression=34925)
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
    out.update(raster_files())
    out.update(gif_webp_files())
    return out


def raster_files(h=16, w=21) -> dict:
    """The PNM, PAM, PFM, Sun raster and Radiance HDR forms, ``h`` x ``w``
    (OpenCV writes the binary PNM, PAM, PFM, Sun raster and RLE HDR
    ones)."""
    out = {}
    rgb = samples(30, 3, h=h, w=w).astype(np.uint8)
    grey = rgb[..., 1]
    out['ascii-maxval100.pgm'] = rf.pnm(2, grey * 100 // 255, 100)
    out['ascii.ppm'] = rf.pnm(3, rgb, header=b'\n# made by hand\n%d %d\n'
                              b'255\n' % (w, h))
    out['ascii.pbm'] = rf.pnm(1, grey > 128, sep=b'')
    out['cv2.pbm'] = cv2.imencode('.pbm', grey)[1].tobytes()
    out['cv2-16bit.pgm'] = cv2.imencode('.pgm', (
        grey.astype(np.uint16) << 8 | rgb[..., 0]))[1].tobytes()
    out['maxval1000.ppm'] = rf.pnm(6, rgb.astype(np.int64) * 1000 // 255,
                                   1000)
    out['cv2.ppm'] = cv2.imencode('.ppm', rgb)[1].tobytes()
    out['rgb.pam'] = rf.pam(rgb, 3, 255, b'RGB')
    floats = rgb.astype(np.float32) / 100
    out['big-endian.pfm'] = rf.pfm(floats[..., ::-1], scale=2.0)
    out['cv2-grey.pfm'] = cv2.imencode('.pfm', floats[..., 1])[1].tobytes()
    out['colormap-8bit.ras'] = rf.sun(
        rf.sun_rows(grey // 16, 8), w, h, 8, maptype=rf.RMT_EQUAL_RGB,
        colormap=bytes(range(0, 256, 6))[:48])
    out['1bit.ras'] = rf.sun(rf.sun_rows(grey > 128, 1), w, h, 1,
                             kind=rf.RT_OLD)
    out['cv2-bgra.ras'] = cv2.imencode('.ras', np.dstack([rgb, grey]))[
        1].tobytes()
    out['rle.ras'] = rf.sun(rf.sun_rle(rf.sun_rows(grey // 64, 8)), w, h, 8,
                            kind=rf.RT_BYTE_ENCODED)
    out['cv2-rle.hdr'] = cv2.imencode('.hdr', floats)[1].tobytes()
    out['flat-rgbe.hdr'] = rf.hdr(rf.rgbe(floats[:, :7]), 'flat', header=(
        b'#?RGBE\nEXPOSURE=1\nFORMAT=32-bit_rle_rgbe\n\n'))
    return out


def gif_webp_files(h=16, w=21) -> dict:
    """The GIF and lossless WebP forms, ``h`` x ``w``: OpenCV's GIFs (BGR,
    and BGRA with transparent pixels), built GIFs (interlaced with a
    transparent index and a background index other than 0, an offset
    image with a local table, GIF87a at minimum code size 2, neither colour
    table, disposal 4, which OpenCV refuses), PIL's animated GIF; OpenCV's
    lossless WebPs (BGR, BGRA), PIL's at methods 0 and 6 and with a
    palette, PIL's animation, the port's writer's, and built containers
    (VP8X with ICCP and an EXIF orientation, an animation whose first
    frame is offset)."""
    sys.path.insert(0, os.path.dirname(HERE))
    from orientedobjectdetection_torch import native
    out = {}
    rgb = samples(40, 3, h=h, w=w).astype(np.uint8)
    bgra = np.dstack([rgb, np.where(rgb[..., 1] < 64, 0, 255).astype(
        np.uint8)])
    out['cv2.gif'] = cv2.imencode('.gif', rgb)[1].tobytes()
    out['cv2-bgra-transparent.gif'] = cv2.imencode('.gif', bgra)[1].tobytes()
    pal = gf.palette(16, 41)
    idx = rgb[..., 0].astype(np.int64) * 16 // 256
    out['interlaced-transparent-bg5.gif'] = gf.gif(
        w, h, gf.gce(2, 10, transparent=3) + gf.frame(idx, interlace=True,
                                                    min_code_size=4),
        pal, background=5)
    out['offset-local-table.gif'] = gf.gif(
        w + 6, h + 4, gf.comment(b'offset') + gf.frame(
            idx[:h - 3, :w - 5] % 8, left=4, top=3, local=gf.palette(8, 42),
            min_code_size=3), pal, background=9)
    out['gif87a-mcs2.gif'] = gf.gif(w, h, gf.frame(idx % 4, min_code_size=2),
                                    pal[:4], version=b'87a')
    out['no-table.gif'] = gf.gif(w, h, gf.frame(idx * 16 + 1,
                                                min_code_size=8), None)
    out['disposal-4.gif'] = gf.gif(w, h, gf.gce(4) + gf.frame(
        idx, min_code_size=4), pal)
    frames = [Image.fromarray(np.roll(rgb[..., ::-1], 5 * k, 1)).quantize(
        12) for k in range(3)]
    out['pil-animated.gif'] = pil_bytes(frames[0], 'GIF', save_all=True,
                                        append_images=frames[1:],
                                        transparency=0, duration=50)
    out['cv2-lossless.webp'] = cv2.imencode('.webp', rgb)[1].tobytes()
    out['cv2-bgra.webp'] = cv2.imencode('.webp', bgra)[1].tobytes()
    rgba = Image.fromarray(bgra[..., (2, 1, 0, 3)].copy(), 'RGBA')
    out['pil-method0.webp'] = pil_bytes(rgba, 'WEBP', lossless=True,
                                        method=0)
    out['pil-method6.webp'] = pil_bytes(Image.fromarray(rgb[..., ::-1]),
                                        'WEBP', lossless=True, method=6)
    out['pil-palette.webp'] = pil_bytes(Image.fromarray(
        pal[idx % 3].astype(np.uint8)), 'WEBP', lossless=True, method=4)
    wframes = [Image.fromarray(np.roll(rgb[..., ::-1], 3 * k, 0))
               for k in range(2)]
    out['pil-animated.webp'] = pil_bytes(wframes[0], 'WEBP', save_all=True,
                                         append_images=wframes[1:],
                                         lossless=True, duration=50)
    out['port.webp'] = native.webp_encode(np.where(bgra[..., 3:] > 0, rgb, 0))
    still = wf.image_chunk(cv2.imencode('.webp', rgb)[1].tobytes())
    out['vp8x-iccp-exif6.webp'] = wf.riff([
        wf.vp8x(wf.ICCP | wf.EXIF, w, h), wf.chunk(b'ICCP', bytes(24)),
        still, wf.exif(6)])
    small = wf.image_chunk(cv2.imencode('.webp', rgb[:6, :8])[1].tobytes())
    out['anim-offset.webp'] = wf.riff([
        wf.vp8x(wf.ANIMATION, w, h), wf.anim(),
        wf.anmf(4, 6, 8, 6, [small]), wf.anmf(0, 0, w, h, [still])])
    return out


def main():
    os.makedirs(OUT, exist_ok=True)
    made = (raster_files() if '--raster' in sys.argv else
            gif_webp_files() if '--gif-webp' in sys.argv else files())
    for name, data in sorted(made.items()):
        with open(os.path.join(OUT, name), 'wb') as f:
            f.write(data)
    print(f'{len(made)} files, {sum(map(len, made.values()))} bytes in '
          f'{OUT}')


if __name__ == '__main__':
    main()
