"""The port's OpenCV-free image I/O (``utils/image_io.py``) against OpenCV:
PNGs that ``cv2.imwrite`` writes decode equal to ``cv2.imread``; PNGs the
port writes read back equal through OpenCV; PNGs with the Average and Paeth
row filters (written by PIL, which chooses a filter per row) decode equal;
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


def test_refuses_what_it_does_not_read(tmp_path):
    img = smooth_image(4, 16, 16)
    paths = {name: str(tmp_path / f'{name}.png')
             for name in ('palette', '16-bit', 'interlaced', 'jpeg')}
    Image.fromarray(img[..., 0]).convert('P').save(paths['palette'])
    cv2.imwrite(paths['16-bit'], img.astype(np.uint16) * 257)
    image_io.imwrite(paths['interlaced'], img)
    with_header(paths['interlaced'], 1)
    cv2.imwrite(str(tmp_path / 'a.jpg'), img)
    os.replace(str(tmp_path / 'a.jpg'), paths['jpeg'])
    for name, path in paths.items():
        with pytest.raises(ValueError):
            image_io.imread(path)


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
