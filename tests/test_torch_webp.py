"""The port's lossless WebP codec (``csrc/webp.cpp`` through ``native.py``
and ``utils/image_io.py``) against OpenCV 5.0 with libwebp on the CPU:

- the reader on PIL's lossless files at methods 0-6 (noise, smooth,
  gradients, palettes of 2-200 colours, alpha), libwebp's own through
  ``cv2.imencode``, PIL's animations, and containers built by
  ``tests/webp_forms.py`` (VP8X with ICCP, EXIF orientations and unknown
  chunks; an animation's offset first frame): every decode equal to
  ``cv2.imdecode(IMREAD_COLOR)``'s array, or both refusing; together they
  use every VP8L transform, all 14 predictor modes, colour caches, LZ77
  with plane codes, meta prefix codes and colour-index bundling at 1, 2, 4
  and 8 pixels a byte;
- lossy WebP refused by name (ROADMAP A.4d); files cut short or with bytes
  overwritten as OpenCV takes them;
- the writer: for every array ``cv2.imwrite('.webp')`` takes, the port's
  file decodes under ``IMREAD_UNCHANGED`` to what OpenCV's file decodes
  to; its size and speed against libwebp's.
"""

import io
import time

import cv2
import numpy as np
import pytest
from PIL import Image

import webp_forms as wf
from orientedobjectdetection_torch import native
from orientedobjectdetection_torch.utils import image_io

cv2.utils.logging.setLogLevel(cv2.utils.logging.LOG_LEVEL_SILENT)


def opencv(data, flags=cv2.IMREAD_COLOR):
    try:
        return cv2.imdecode(np.frombuffer(data, np.uint8), flags)
    except cv2.error:
        return None


def port(data):
    try:
        return image_io.imdecode(data)
    except ValueError:
        return None


def same_as_opencv(data) -> bool:
    want, got = opencv(data), port(data)
    if want is None or got is None:
        return want is None and got is None
    return np.array_equal(want, got)


def pil_webp(img, **kwargs) -> bytes:
    """PIL's WebP of BGR or BGRA ``img``."""
    rgb = img[..., (2, 1, 0, 3)[:img.shape[2]]]
    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(rgb)).save(buf, 'WEBP', **kwargs)
    return buf.getvalue()


def images(seed, sizes=((1, 1), (2, 3), (7, 13), (31, 47), (97, 131))):
    """(name, BGR or BGRA uint8) of kinds each transform suits."""
    rng = np.random.default_rng(seed)
    for h, w in sizes:
        noise = rng.integers(0, 256, (h, w, 3), np.uint8)
        yield 'noise', noise
        if h > 4 and w > 4:
            yield 'smooth', cv2.GaussianBlur(noise, (7, 7), 2)
        ramp = (np.add.outer(np.arange(h) * 3, np.arange(w) * 5) % 256)
        yield 'ramp', np.dstack([ramp, ramp[::-1], 255 - ramp]).astype(
            np.uint8)
        for k in (2, 3, 4, 5, 16, 17, 200):
            pal = rng.integers(0, 256, (k, 3), np.uint8)
            yield f'palette {k}', pal[rng.integers(0, k, (h, w))]
        alpha = rng.integers(0, 256, (h, w), np.uint8)
        alpha[alpha < 50] = 0
        yield 'alpha', np.dstack([noise, alpha])


@pytest.mark.parametrize('method', range(7))
def test_pil_lossless_files_equal_opencv(method):
    for name, img in images(method):
        data = pil_webp(img, lossless=True, method=method,
                        quality=(0, 50, 100)[method % 3])
        want = opencv(data)
        assert want is not None, name
        np.testing.assert_array_equal(image_io.imdecode(data), want, name)


def test_libwebp_files_through_opencv_equal_opencv():
    for name, img in images(7):
        data = cv2.imencode('.webp', img)[1].tobytes()
        assert data[12:16] == b'VP8L', name
        np.testing.assert_array_equal(image_io.imdecode(data), opencv(data),
                                      name)


def directional(seed, side=256):
    """A smooth scene over a ramp in one of six directions: libwebp's
    predictor search picks most of the 14 modes on such scenes."""
    rng = np.random.default_rng(seed)
    base = cv2.resize(rng.integers(0, 256, (8 + seed, 8 + seed, 3),
                                   np.uint8), (side, side),
                      interpolation=(cv2.INTER_CUBIC, cv2.INTER_LINEAR,
                                     cv2.INTER_NEAREST)[seed % 3])
    yy, xx = np.mgrid[:side, :side]
    dy, dx = ((1, 0), (0, 1), (1, 1), (1, -1), (2, 1), (1, 2))[seed % 6]
    ramp = ((yy * dy + xx * dx) * (seed + 1) // 2 % 256).astype(np.int64)
    noise = rng.integers(-3, 4, (side, side, 3))
    return np.clip(base // 2 + ramp[..., None] // 2 + noise, 0,
                   255).astype(np.uint8)


def test_every_vp8l_feature_is_read_as_opencv_reads_it():
    """The bitstreams above and these, decoded to OpenCV's arrays, used
    between them every transform, predictor modes 0-13, colour caches,
    backward references with plane codes, meta prefix codes and every
    colour-index bundling (1, 2, 4, 8 pixels a byte)."""
    files = []
    for seed in range(12):
        files.append(pil_webp(directional(seed, 160), lossless=True,
                              method=4 + seed % 3, quality=100))
    for k in (2, 3, 5, 17):
        pal = np.random.default_rng(k).integers(0, 256, (k, 3), np.uint8)
        files.append(pil_webp(pal[np.random.default_rng(k).integers(
            0, k, (64, 64))], lossless=True, method=6))
    black = directional(1, 64)
    black[:32] = 0                           # mode 0 (black) tiles
    files.append(native.webp_encode(black))
    seen = dict(transforms=0, predictor_modes=0, cache_bits=0, meta_bits=0,
                copies=0, plane_codes=0, cache_hits=0)
    palettes = set()
    for data in files:
        stats = {}
        got = native.webp_decode(data, stats)
        np.testing.assert_array_equal(got, opencv(data))
        for key in ('transforms', 'predictor_modes'):
            seen[key] |= stats[key]
        for key in ('cache_bits', 'meta_bits'):
            seen[key] = max(seen[key], stats[key])
        for key in ('copies', 'plane_codes', 'cache_hits'):
            seen[key] += stats[key]
        palettes.add(stats['palette_bits'])
    assert seen['transforms'] == 0b1111
    assert seen['predictor_modes'] & 0x3fff == 0x3fff
    assert seen['cache_bits'] >= 1 and seen['meta_bits'] >= 2
    assert seen['copies'] and seen['plane_codes'] and seen['cache_hits']
    assert {1, 2, 3, 4} <= palettes


def test_animations_give_the_first_frame_on_the_canvas():
    rng = np.random.default_rng(4)
    frames = [Image.fromarray(rng.integers(0, 256, (20, 30, 3), np.uint8))
              for _ in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, 'WEBP', save_all=True, append_images=frames[1:],
                   lossless=True)
    data = buf.getvalue()
    want = opencv(data)
    np.testing.assert_array_equal(want, np.asarray(frames[0])[..., ::-1])
    np.testing.assert_array_equal(image_io.imdecode(data), want)
    small = rng.integers(0, 256, (6, 8, 3), np.uint8)
    alpha = np.dstack([small, np.where(small[..., 0] < 60, 0, 200)]).astype(
        np.uint8)
    still = wf.image_chunk(cv2.imencode('.webp', alpha)[1].tobytes())
    lossy = wf.image_chunk(cv2.imencode('.webp', small, [
        cv2.IMWRITE_WEBP_QUALITY, 80])[1].tobytes())
    offset = wf.riff([wf.vp8x(wf.ANIMATION | wf.ALPHA, 40, 30), wf.anim(),
                      wf.anmf(4, 6, 8, 6, [still]),
                      wf.anmf(0, 0, 8, 6, [lossy])])
    got = image_io.imdecode(offset)
    np.testing.assert_array_equal(got, opencv(offset))
    assert got[:6].sum() == 0 and got[6:12, 4:12].any()
    past = wf.riff([wf.vp8x(wf.ANIMATION, 10, 10), wf.anim(),
                    wf.anmf(4, 6, 8, 6, [still])])
    assert same_as_opencv(past) and opencv(past) is None
    lossy_first = wf.riff([wf.vp8x(wf.ANIMATION, 8, 6), wf.anim(),
                           wf.anmf(0, 0, 8, 6, [lossy])])
    assert opencv(lossy_first) is not None
    with pytest.raises(ValueError, match='lossy WebP images.*ROADMAP A.4d'):
        image_io.imdecode(lossy_first)


def test_containers_equal_opencv():
    img = np.random.default_rng(5).integers(0, 256, (20, 30, 3), np.uint8)
    vp8l = wf.image_chunk(cv2.imencode('.webp', img)[1].tobytes())
    simple = wf.riff([vp8l])
    made = {
        'vp8x still': wf.riff([wf.vp8x(0, 30, 20), vp8l]),
        'vp8x alpha flag': wf.riff([wf.vp8x(wf.ALPHA, 30, 20), vp8l]),
        'iccp, xmp': wf.riff([wf.vp8x(wf.ICCP | wf.XMP, 30, 20),
                              wf.chunk(b'ICCP', b'x' * 13), vp8l,
                              wf.chunk(b'XMP ', b'<x/>')]),
        'unknown chunk before': wf.riff([wf.vp8x(0, 30, 20),
                                         wf.chunk(b'ABCD', b'x' * 5), vp8l]),
        'unknown chunk after': wf.riff([vp8l, wf.chunk(b'ABCD', b'x' * 5)]),
        'trailing bytes': simple + b'junk',
    }
    for name, data in made.items():
        np.testing.assert_array_equal(image_io.imdecode(data), img, name)
        assert same_as_opencv(data), name
    refused = {
        'unknown chunk first': wf.riff([wf.chunk(b'ABCD', b'x' * 5), vp8l]),
        'another canvas': wf.riff([wf.vp8x(0, 31, 20), vp8l]),
        'RIFF size past the data': simple[:4] + (
            len(simple)).to_bytes(4, 'little') + simple[8:],
        'cut by 1': simple[:-1], 'cut by 10': simple[:-10],
    }
    for name, data in refused.items():
        assert opencv(data) is None, name
        with pytest.raises(ValueError, match='WebP'):
            image_io.imdecode(data)


@pytest.mark.parametrize('orientation', range(1, 9))
def test_exif_orientation_applied_as_opencv_applies_it(orientation):
    """The EXIF chunk's orientation, where VP8X's EXIF flag is set (and
    only there), as OpenCV applies it; a big-endian block too."""
    img = np.random.default_rng(orientation).integers(0, 256, (20, 30, 3),
                                                      np.uint8)
    vp8l = wf.image_chunk(cv2.imencode('.webp', img)[1].tobytes())
    for flags, order in ((wf.EXIF, '<'), (wf.EXIF, '>'), (0, '<')):
        data = wf.riff([wf.vp8x(flags, 30, 20), vp8l,
                        wf.exif(orientation, order)])
        want = opencv(data)
        np.testing.assert_array_equal(image_io.imdecode(data), want)
        if not flags:
            np.testing.assert_array_equal(want, img)


def test_lossy_webp_is_refused_naming_roadmap():
    img = np.random.default_rng(6).integers(0, 256, (20, 30, 3), np.uint8)
    lossy = cv2.imencode('.webp', img, [cv2.IMWRITE_WEBP_QUALITY, 80])[1]
    bgra = np.dstack([img, np.full((20, 30), 128, np.uint8)])
    alph = cv2.imencode('.webp', bgra, [cv2.IMWRITE_WEBP_QUALITY, 80])[1]
    assert alph.tobytes()[12:16] == b'VP8X' and b'ALPH' in alph.tobytes()
    for data in (lossy.tobytes(), alph.tobytes()):
        assert opencv(data) is not None
        with pytest.raises(ValueError, match='lossy WebP images.*ROADMAP '
                                             'A.4d'):
            image_io.imdecode(data)


@pytest.mark.parametrize('chunk', range(3))
def test_cut_and_overwritten_files_as_opencv_takes_them(chunk):
    rng = np.random.default_rng(20 + chunk)
    base = []
    for i, (_, img) in enumerate(images(30 + chunk, ((9, 14), (33, 20)))):
        base.append(pil_webp(img, lossless=True, method=i % 7))
    for i in range(400):
        data = bytearray(base[int(rng.integers(0, len(base)))])
        if rng.random() < 0.3:
            data = data[:int(rng.integers(0, len(data)))]
        else:
            for _ in range(int(rng.integers(1, 3))):
                data[int(rng.integers(20, len(data)))] = int(
                    rng.integers(0, 256))
        assert same_as_opencv(bytes(data)), (chunk, i)


# ---- the writer -------------------------------------------------------------
def writer_arrays():
    rng = np.random.default_rng(8)
    bgr = cv2.GaussianBlur(rng.integers(0, 256, (37, 53, 3), np.uint8),
                           (5, 5), 1)
    alpha = rng.integers(0, 256, (37, 53), np.uint8)
    alpha[alpha < 60] = 0
    yield 'bgr', bgr
    yield 'grey', bgr[..., 1]
    yield 'grey (H, W, 1)', bgr[..., 1:2]
    yield 'bgra', np.dstack([bgr, alpha])
    yield 'bgra opaque', np.dstack([bgr, np.full((37, 53), 255, np.uint8)])
    yield 'bgra all transparent', np.dstack([bgr, np.zeros((37, 53),
                                                           np.uint8)])
    yield '1 x 1', bgr[:1, :1]
    yield '1 x 300', rng.integers(0, 256, (1, 300, 3), np.uint8)
    yield '300 x 1', rng.integers(0, 256, (300, 1, 3), np.uint8)
    yield 'uint16', bgr.astype(np.uint16) * 3
    yield 'int8', (bgr.astype(np.int16) - 128).astype(np.int8)
    yield 'float32', bgr.astype(np.float32) * 1.5 - 20
    yield 'float64 bgra', np.dstack([bgr, alpha]).astype(np.float64)
    yield 'bool', bgr > 100
    for k in (2, 12, 300):
        pal = rng.integers(0, 256, (k, 3), np.uint8)
        yield f'{k} colours', pal[rng.integers(0, k, (64, 64))]
    yield 'black', np.zeros((40, 40, 3), np.uint8)


@pytest.mark.parametrize('name', [n for n, _ in writer_arrays()])
def test_writer_decodes_to_what_opencv_s_file_decodes_to(name, tmp_path):
    img = dict(writer_arrays())[name]
    ref = cv2.imencode('.webp', img)[1].tobytes()
    path = str(tmp_path / 'x.webp')
    image_io.imwrite(path, img)
    with open(path, 'rb') as f:
        data = f.read()
    assert data[12:16] == b'VP8L'
    want = opencv(ref, cv2.IMREAD_UNCHANGED)
    got = opencv(data, cv2.IMREAD_UNCHANGED)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(image_io.imread(path), cv2.imread(path))


def test_writer_refuses_sides_past_16383():
    img = np.zeros((1, 16384, 3), np.uint8)
    assert not cv2.imencode('.webp', img)[0]
    with pytest.raises(ValueError, match='16383'):
        image_io.imencode('.webp', img)


def test_writer_speed_and_size_against_libwebp():
    """An 800^2 BGR write on one thread takes under 0.5 s; the file is
    within 1.6x libwebp's (the sizes are printed)."""
    rng = np.random.default_rng(9)
    img = cv2.GaussianBlur(rng.integers(0, 256, (800, 800, 3), np.uint8),
                           (9, 9), 3)
    native.webp_encode(img[:8, :8])
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        data = image_io.imencode('.webp', img)
        times.append(time.perf_counter() - t0)
    ref = cv2.imencode('.webp', img)[1].tobytes()
    print(f'800^2 smooth noise: port {len(data)} bytes in '
          f'{1e3 * min(times):.1f} ms, libwebp {len(ref)} bytes')
    assert min(times) < 0.5
    assert len(data) < 1.6 * len(ref)
    np.testing.assert_array_equal(image_io.imdecode(data), img)
