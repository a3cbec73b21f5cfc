"""The port's OpenCV-free image I/O (``utils/image_io.py``) against OpenCV:
PNGs that ``cv2.imwrite`` writes decode equal to ``cv2.imread``; PNGs the
port writes read back equal through OpenCV; PNGs with the Average and Paeth
row filters (written by PIL, which chooses a filter per row) decode equal;
so do palette, 1/2/4-bit, 16-bit, Adam7-interlaced and eXIf-oriented PNGs
and a JPEG, as do a TIFF and a CMYK JPEG, while an LZMA-compressed TIFF
and a 12-bit JPEG say OpenCV does not read them either;
``resize_bilinear`` within 1 of ``cv2.resize(INTER_LINEAR)`` per element;
the drawing helpers as ``tests/test_torch_synth.py`` needs them."""

import os
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from orientedobjectdetection_torch.utils import image_io


def smooth_image(seed, h, w):
    rng = np.random.default_rng(seed)
    return cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), np.uint8),
                            (5, 5), 0)


@pytest.mark.parametrize('h,w', [(1, 1), (7, 13), (97, 131), (256, 256)])
def test_reads_what_opencv_writes(tmp_path, h, w):
    img = smooth_image(h * w, h, w)
    path = str(tmp_path / 'a.png')
    cv2.imwrite(path, img)
    got = image_io.imread(path)
    assert got.dtype == np.uint8 and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, cv2.imread(path, cv2.IMREAD_COLOR))


@pytest.mark.parametrize('h,w', [(1, 5), (64, 80), (255, 257)])
def test_opencv_reads_what_the_port_writes(tmp_path, h, w):
    img = smooth_image(h + w, h, w)
    path = str(tmp_path / 'b.png')
    image_io.imwrite(path, img)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_COLOR), img)
    np.testing.assert_array_equal(image_io.imread(path), img)


@pytest.mark.parametrize('mode', ['RGB', 'RGBA', 'L', 'LA'])
def test_every_row_filter_and_colour_type(tmp_path, mode):
    img = smooth_image(3, 61, 47)
    path = str(tmp_path / 'c.png')
    Image.fromarray(img[..., ::-1]).convert(mode).save(path)
    data = open(path, 'rb').read()
    got = image_io.imread(path)
    np.testing.assert_array_equal(got, cv2.imread(path, cv2.IMREAD_COLOR))
    if mode == 'RGB':                   # PIL picked Average or Paeth rows
        raw = zlib.decompress(
            data[data.index(b'IDAT') + 4:data.rindex(b'IEND') - 8])
        filters = {raw[i * (47 * 3 + 1)] for i in range(61)}
        assert filters & {3, 4}, filters


def with_header(path, interlace):
    """Rewrite the IHDR's interlace byte of a PNG, with its CRC."""
    data = bytearray(open(path, 'rb').read())
    at = data.index(b'IHDR')
    data[at + 16] = interlace
    crc = zlib.crc32(bytes(data[at:at + 17]))
    data[at + 17:at + 21] = struct.pack('>I', crc)
    open(path, 'wb').write(bytes(data))


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def png_file(path, samples, colour, depth, interlace=0, plte=None):
    """A PNG of ``samples`` ((H, W[, C]) integers), as other writers lay it
    out: any depth, palette or Adam7 passes (PIL writes no interlaced
    PNG); every row unfiltered."""
    h, w = samples.shape[:2]

    def chunk(kind, body):
        return (struct.pack('>I', len(body)) + kind + body +
                struct.pack('>I', zlib.crc32(kind + body)))

    raw = b''
    for x0, y0, dx, dy in ADAM7 if interlace else ((0, 0, 1, 1),):
        sub = samples[y0::dy, x0::dx]
        if not sub.size:                    # an empty pass has no rows
            continue
        for row in sub.reshape(sub.shape[0], sub.shape[1], -1):
            row = row.reshape(-1)
            if depth == 16:
                data = row.astype('>u2').tobytes()
            elif depth < 8:
                bits = np.unpackbits(row.astype(np.uint8)[:, None], axis=1)
                data = np.packbits(bits[:, 8 - depth:].reshape(-1)).tobytes()
            else:
                data = row.astype(np.uint8).tobytes()
            raw += b'\0' + data
    out = b'\x89PNG\r\n\x1a\n' + chunk(b'IHDR', struct.pack(
        '>IIBBBBB', w, h, depth, colour, 0, 0, interlace))
    if plte is not None:
        out += chunk(b'PLTE', plte)
    out += chunk(b'IDAT', zlib.compress(raw)) + chunk(b'IEND', b'')
    with open(path, 'wb') as f:
        f.write(out)


def used_to_refuse(name, path):
    """Write the form ``name`` at ``path``: those the reader refused before
    it read them."""
    img = smooth_image(4, 37, 53)
    rng = np.random.default_rng(len(name))
    if name.startswith('palette'):
        bits = int(name.split('-')[1])
        quant = Image.fromarray(img[..., ::-1]).quantize(1 << bits)
        extra = dict(transparency=0) if name.endswith('tRNS') else {}
        quant.save(path, bits=bits, **extra)
    elif name == '16-bit':
        cv2.imwrite(path, img.astype(np.uint16) * 251 + 7)
    elif name == '16-bit grey':
        cv2.imwrite(path, img[..., 0].astype(np.uint16) * 257)
    elif name == '16-bit grey+alpha':
        png_file(path, rng.integers(0, 65536, (9, 10, 2)), 4, 16)
    elif name == '16-bit RGBA':
        cv2.imwrite(path, np.dstack([img, img[..., :1]]).astype(np.uint16) *
                    257)
    elif name.startswith('grey-'):
        depth = int(name.split('-')[1])
        png_file(path, rng.integers(0, 1 << depth, (13, 11)), 0, depth)
    elif name == 'interlaced':
        png_file(path, img[..., ::-1], 2, 8, interlace=1)
    elif name == 'interlaced 1 x 1':
        png_file(path, img[:1, :1, ::-1], 2, 8, interlace=1)
    elif name == 'interlaced 16-bit RGBA':
        png_file(path, rng.integers(0, 65536, (5, 3, 4)), 6, 16, interlace=1)
    elif name == 'interlaced palette-4':
        png_file(path, rng.integers(0, 16, (21, 19)), 3, 4, interlace=1,
                 plte=rng.integers(0, 256, 48).astype(np.uint8).tobytes())
    elif name == 'interlaced grey-2':
        png_file(path, rng.integers(0, 4, (13, 11)), 0, 2, interlace=1)
    elif name.startswith('eXIf'):
        exif = Image.Exif()
        exif[0x0112] = int(name.split('-')[1])
        Image.fromarray(img[..., ::-1]).save(path, exif=exif.tobytes())
    elif name == 'jpeg':
        cv2.imwrite(str(path) + '.jpg', img)
        os.replace(str(path) + '.jpg', path)
    else:
        raise KeyError(name)


@pytest.mark.parametrize('name', [
    'palette-1', 'palette-2', 'palette-4', 'palette-8', 'palette-8-tRNS',
    'palette-2-tRNS', '16-bit', '16-bit grey', '16-bit grey+alpha',
    '16-bit RGBA', 'grey-1', 'grey-2', 'grey-4', 'interlaced',
    'interlaced 1 x 1', 'interlaced 16-bit RGBA', 'interlaced palette-4',
    'interlaced grey-2', 'eXIf-3', 'eXIf-6', 'jpeg'])
def test_reads_what_it_used_to_refuse(tmp_path, name):
    """Palette, low-depth and 16-bit PNGs (16 bits cut to the high byte),
    Adam7-interlaced ones, a PNG's eXIf orientation and a JPEG (under a
    ``.png`` name: the bytes decide) read as ``cv2.imread`` reads them."""
    path = str(tmp_path / 'x.png')
    used_to_refuse(name, path)
    want = cv2.imread(path, cv2.IMREAD_COLOR)
    got = image_io.imread(path)
    assert want is not None and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_refuses_what_it_does_not_read(tmp_path):
    """A TIFF and a CMYK JPEG (refused until the port read them) read as
    OpenCV reads them; an LZMA-compressed TIFF and a 12-bit JPEG say OpenCV
    does not read them either (it gives no image for either); a truncated
    PNG, a PNG whose data does not inflate and bytes of no image format
    raise too."""
    from jpeg_forms import dct_jpeg, seeded_samples
    from tiff_forms import tiff as build_tiff
    img = smooth_image(4, 16, 16)
    tiff, cmyk = tmp_path / 'x.tif', tmp_path / 'x.jpg'
    Image.fromarray(img).save(tiff)
    Image.fromarray(img).convert('CMYK').save(cmyk)
    for path in (tiff, cmyk):
        np.testing.assert_array_equal(image_io.imread(str(path)),
                                      cv2.imread(str(path), cv2.IMREAD_COLOR))
    lzma = build_tiff(img, 8, 2, compression=34925)
    twelve = dct_jpeg(seeded_samples(4, 16, 16, 3, 12), precision=12)
    for data, match in ((lzma, 'LZMA.*OpenCV does not read it either'),
                        (twelve, '12-bit JPEG: OpenCV does not read it')):
        assert cv2.imdecode(np.frombuffer(data, np.uint8),
                            cv2.IMREAD_COLOR) is None
        with pytest.raises(ValueError, match=match):
            image_io.imdecode(data)
    png = str(tmp_path / 'x.png')
    image_io.imwrite(png, img)
    data = open(png, 'rb').read()
    at = data.index(b'IDAT') + 4
    broken = data[:at] + bytes(len(data) - at - 16) + data[-16:]
    for bad in (data[:len(data) // 2], broken, b'GIF89a' + bytes(20)):
        with pytest.raises(ValueError):
            image_io.imdecode(bad)


def test_images_past_opencvs_pixel_limit_raise():
    """A header past 2^30 pixels (OpenCV's limit) raises before any pixel
    is allocated: a 4-byte RLE8 BMP and an empty PNG."""
    bmp = (struct.pack('<2sIHHI', b'BM', 1082, 0, 0, 1078) +
           struct.pack('<IiiHHIIiiII', 40, 65536, 65536, 1, 8, 1, 4, 0, 0,
                       256, 0) + bytes(1024) + b'\0\1\0\1')
    with pytest.raises(ValueError, match='65536 x 65536'):
        image_io.imdecode(bmp)
    def chunk(kind, body):
        return (struct.pack('>I', len(body)) + kind + body +
                struct.pack('>I', zlib.crc32(kind + body)))

    png = (b'\x89PNG\r\n\x1a\n' + chunk(b'IHDR', struct.pack(
        '>IIBBBBB', 40000, 40000, 8, 2, 0, 0, 0)) +
        chunk(b'IDAT', zlib.compress(b'')) + chunk(b'IEND', b''))
    with pytest.raises(ValueError, match='40000 x 40000'):
        image_io.imdecode(png)


@pytest.mark.parametrize('src,dst', [((97, 131), (200, 150)),
                                     ((97, 131), (60, 40)),
                                     ((100, 100), (50, 50)),
                                     ((256, 256), (300, 301)),
                                     ((64, 64), (128, 128)),
                                     ((256, 256), (256, 256))])
def test_resize_bilinear_within_one_of_opencv(src, dst):
    img = np.random.default_rng(src[0] + dst[1]).integers(
        0, 256, src + (3,), np.uint8)
    got = image_io.resize_bilinear(img, dst)
    ref = cv2.resize(img, dst, interpolation=cv2.INTER_LINEAR)
    assert got.shape == ref.shape
    diff = np.abs(got.astype(int) - ref)
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.01       # off by one in a few elements


def test_blur_circle_and_thin_line_equal_opencv():
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, (37, 53, 3), np.uint8)
    np.testing.assert_array_equal(image_io.gaussian_blur_3x3(img),
                                  cv2.GaussianBlur(img, (3, 3), 0))
    for r, c in [(1, (10, 10)), (3, (0, 3)), (3, (30, 31)), (5, (15, 20))]:
        a, b = np.zeros((32, 32, 3), np.uint8), np.zeros((32, 32, 3),
                                                          np.uint8)
        image_io.circle(a, c, r, (9, 8, 7))
        cv2.circle(b, c, r, (9, 8, 7), -1)
        np.testing.assert_array_equal(a, b)
    for _ in range(200):
        p0 = tuple(int(v) for v in rng.integers(0, 64, 2))
        p1 = tuple(int(v) for v in rng.integers(0, 64, 2))
        a, b = np.zeros((64, 64, 3), np.uint8), np.zeros((64, 64, 3),
                                                          np.uint8)
        image_io.line(a, p0, p1, (5, 6, 7))
        cv2.line(b, p0, p1, (5, 6, 7), 1)
        np.testing.assert_array_equal(a, b)


def test_fill_poly_equals_opencv_inside_the_image():
    rng = np.random.default_rng(7)
    for _ in range(200):
        cx, cy = rng.uniform(20, 44, 2)
        w, h = rng.uniform(3, 30, 2)
        a = rng.uniform(-1.6, 1.6)
        c, s = np.cos(a), np.sin(a)
        pts = np.array([[cx - w / 2 * c + h / 2 * s, cy - w / 2 * s - h / 2 * c],
                        [cx + w / 2 * c + h / 2 * s, cy + w / 2 * s - h / 2 * c],
                        [cx + w / 2 * c - h / 2 * s, cy + w / 2 * s + h / 2 * c],
                        [cx - w / 2 * c - h / 2 * s, cy - w / 2 * s + h / 2 * c]]
                       ).astype(np.int32)
        a_img, b_img = np.zeros((64, 64, 3), np.uint8), np.zeros(
            (64, 64, 3), np.uint8)
        image_io.fill_poly(a_img, pts, (1, 2, 3))
        cv2.fillPoly(b_img, [pts], (1, 2, 3))
        np.testing.assert_array_equal(a_img, b_img)


def test_hsv2bgr_within_one_of_opencv():
    h, s, v = np.meshgrid(np.arange(180), np.arange(0, 256, 5),
                          np.arange(0, 256, 5), indexing='ij')
    hsv = np.stack([h, s, v], -1).astype(np.uint8).reshape(-1, 1, 3)
    diff = np.abs(image_io.hsv2bgr(hsv).astype(int) -
                  cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
