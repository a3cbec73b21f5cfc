"""Port parity, the HRSC2016 path: BMP reading and writing
(``utils/image_io.py``: 24- and 32-bit, palette, RLE8 / RLE4 and 16-bit
files) against OpenCV, ``HRSCDataset`` against the JAX
package's (the XML parse, the long-edge boxes in each angle version,
``classwise``, AP50 / AP75), and ``generate_synth --hrsc`` against
``tools/data/synth/generate_synth.py``'s: byte-identical XML and image-set
files for the same seed, and pixel-equal images (ships are drawn without
the thick line where the generators differ)."""

import os
import struct
import sys

import cv2
import numpy as np
import pytest

from orientedobjectdetection_tpu.datasets import \
    build_dataset as jax_build_dataset
from orientedobjectdetection_torch.datasets import build_dataset
from orientedobjectdetection_torch.tools import generate_synth as port_gen
from orientedobjectdetection_torch.utils import image_io

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', 'tools',
                                'data', 'synth'))
import generate_synth as jax_gen  # noqa: E402

AP_ATOL = 1e-6


@pytest.mark.parametrize('h,w', [(1, 1), (3, 5), (7, 4), (33, 17),
                                 (64, 64)])
def test_bmp_matches_cv2(tmp_path, h, w):
    img = np.random.default_rng(h * w).integers(0, 256, (h, w, 3), np.uint8)
    port, ref = str(tmp_path / 'port.bmp'), str(tmp_path / 'cv2.bmp')
    image_io.imwrite(port, img)
    cv2.imwrite(ref, img)
    with open(port, 'rb') as f, open(ref, 'rb') as g:
        assert f.read() == g.read()
    np.testing.assert_array_equal(image_io.imread(ref), img)


def bmp_file(path, img, bits=24, top_down=False, compression=0,
             header=40, masks=None):
    """A BMP as other writers lay it out: 32-bit rows with a fourth byte,
    negative heights for top-down rows, BITFIELDS masks after the
    header."""
    h, w = img.shape[:2]
    pixel = bits // 8
    px = np.zeros((h, w, pixel), np.uint8)
    px[..., :3] = img
    if pixel == 4:
        px[..., 3] = 200
    stride = (w * pixel + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * pixel] = (px if top_down else px[::-1]).reshape(h, -1)
    extra = struct.pack('<III', *masks) if masks else b''
    offset = 14 + header + len(extra)
    info = struct.pack('<IiiHHIIiiII', header, w, -h if top_down else h, 1,
                       bits, compression, stride * h, 2835, 2835, 0, 0)
    info += b'\0' * (header - 40)
    with open(path, 'wb') as f:
        f.write(struct.pack('<2sIHHI', b'BM', offset + stride * h, 0, 0,
                            offset) + info + extra + rows.tobytes())


@pytest.mark.parametrize('bits,top_down,header,masks', [
    (24, True, 40, None), (32, False, 40, None), (32, True, 124, None),
    (32, False, 40, (0xFF0000, 0xFF00, 0xFF))])
def test_bmp_layouts_read_as_cv2_reads_them(tmp_path, bits, top_down,
                                            header, masks):
    img = np.random.default_rng(bits).integers(0, 256, (9, 13, 3), np.uint8)
    path = str(tmp_path / 'x.bmp')
    bmp_file(path, img, bits, top_down, 3 if masks else 0, header, masks)
    ref = cv2.imread(path, cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(ref, img)
    np.testing.assert_array_equal(image_io.imread(path), ref)


def bmp_indexed(path, idx, palette, bits, compression=0, core=False):
    """A palette BMP of indices ``idx`` ((H, W), rows top first): plain
    rows of ``bits`` bits, or, with RLE compression, the runs ``idx`` is
    taken as (bytes). A 12-byte core header takes 3-byte palette entries.
    16 bytes follow the pixels: OpenCV's reader reads ahead."""
    h, w = (idx.shape if compression == 0 else idx[1])
    if compression == 0:
        stride = ((w * bits + 31) // 32) * 4
        rows = []
        for row in idx[::-1]:
            bit = np.unpackbits(row.astype(np.uint8)[:, None], axis=1)
            packed = np.packbits(bit[:, 8 - bits:].reshape(-1)).tobytes()
            rows.append(packed + bytes(stride - len(packed)))
        pixels = b''.join(rows)
    else:
        pixels = idx[0] + bytes(16)
    pal = b''.join(bytes(entry[:3]) + (b'' if core else b'\0')
                   for entry in palette.tolist())
    if core:
        info = struct.pack('<IHHHH', 12, w, h, 1, bits)
    else:
        info = struct.pack('<IiiHHIIiiII', 40, w, h, 1, bits, compression,
                           len(pixels), 2835, 2835, len(palette), 0)
    offset = 14 + len(info) + len(pal)
    with open(path, 'wb') as f:
        f.write(struct.pack('<2sIHHI', b'BM', offset + len(pixels), 0, 0,
                            offset) + info + pal + pixels)


# RLE8 lines, file order: a run, an absolute run of 4 and a run (13 pixels),
# end of line; an absolute run of 3 (padded) and a run that fills the line
# (the end of line after it does nothing); a run of 2 and end of line
# (the rest is palette entry 0); a delta of (3, 1) then a run; a line of
# one absolute run of 13; end of bitmap
RLE8 = bytes([5, 3, 0, 4, 9, 8, 7, 6, 4, 11, 0, 0,
              0, 3, 1, 2, 250, 0, 10, 200, 0, 0,
              2, 77, 0, 0,
              0, 2, 3, 1, 4, 5, 0, 0,
              0, 13]) + bytes(range(100, 113)) + bytes([0, 0, 0, 0, 1])
# RLE4: a run of two alternating colours, an absolute run of 5 (4 bytes),
# end of line; a run over the whole line and end of line; a delta of
# (4, 2), which OpenCV 5 takes along the line alone, a run of 3; end of
# bitmap
RLE4 = bytes([5, 0x3C, 0, 5, 0x12, 0x34, 0x50, 0, 0, 0,
              13, 0x9A, 0, 0,
              0, 2, 4, 2, 3, 0x77, 0, 0, 0, 1])


@pytest.mark.parametrize('bits,compression,match', [
    (8, 1, 'RLE'), (4, 2, 'RLE'), (8, 0, 'palette'), (1, 0, 'palette'),
    (16, 0, '16-bit')])
def test_bmp_refuses_by_name(tmp_path, bits, compression, match):
    """The forms the reader refused by name (``match``) before it read
    them: RLE8, RLE4, 8- and 1-bit palette and 16-bit (555) BMPs read as
    ``cv2.imread`` reads them."""
    path = str(tmp_path / 'x.bmp')
    rng = np.random.default_rng(bits + compression)
    h, w = 7, 13
    palette = rng.integers(0, 256, (1 << min(bits, 8), 3))
    if compression:
        bmp_indexed(path, (RLE8 if bits == 8 else RLE4, (h, w)), palette,
                    bits, compression)
    elif bits <= 8:
        bmp_indexed(path, rng.integers(0, 1 << bits, (h, w)), palette, bits)
    else:
        v = rng.integers(0, 1 << 16, (h, w)).astype('<u2')
        stride = (w * 2 + 3) & ~3
        rows = b''.join(r.tobytes() + bytes(stride - 2 * w) for r in v[::-1])
        with open(path, 'wb') as f:
            f.write(struct.pack('<2sIHHI', b'BM', 54 + len(rows), 0, 0, 54) +
                    struct.pack('<IiiHHIIiiII', 40, w, h, 1, 16, 0,
                                len(rows), 0, 0, 0, 0) + rows)
    ref = cv2.imread(path, cv2.IMREAD_COLOR)
    assert ref is not None and ref.shape == (h, w, 3), match
    np.testing.assert_array_equal(image_io.imread(path), ref)


@pytest.mark.parametrize('bits,core', [(1, True), (4, False), (4, True),
                                       (8, True)])
def test_palette_bmps_read_as_cv2_reads_them(tmp_path, bits, core):
    path = str(tmp_path / 'x.bmp')
    rng = np.random.default_rng(bits)
    bmp_indexed(path, rng.integers(0, 1 << bits, (9, 17)),
                rng.integers(0, 256, (1 << bits, 3)), bits, core=core)
    np.testing.assert_array_equal(image_io.imread(path),
                                  cv2.imread(path, cv2.IMREAD_COLOR))


@pytest.mark.parametrize('masks', [(0xF800, 0x07E0, 0x1F),
                                   (0x7C00, 0x03E0, 0x1F)])
def test_16_bit_bitfields_read_as_cv2_reads_them(tmp_path, masks):
    h, w = 5, 9
    v = np.random.default_rng(3).integers(0, 1 << 16, (h, w)).astype('<u2')
    stride = (w * 2 + 3) & ~3
    rows = b''.join(r.tobytes() + bytes(stride - 2 * w) for r in v)
    path = str(tmp_path / 'x.bmp')
    with open(path, 'wb') as f:
        f.write(struct.pack('<2sIHHI', b'BM', 66 + len(rows), 0, 0, 66) +
                struct.pack('<IiiHHIIiiII', 40, w, h, 1, 16, 3, len(rows),
                            0, 0, 0, 0) + struct.pack('<III', *masks) + rows)
    np.testing.assert_array_equal(image_io.imread(path),
                                  cv2.imread(path, cv2.IMREAD_COLOR))


def test_imread_names_what_it_does_not_read(tmp_path):
    """A corrupt JPEG and a corrupt TIFF name their format; an LZMA-
    compressed TIFF (a form OpenCV does not read either: it gives no image)
    says so."""
    from tiff_forms import tiff
    jpeg, other = str(tmp_path / 'x.jpg'), str(tmp_path / 'x.tif')
    lzma = str(tmp_path / 'lzma.tif')
    open(jpeg, 'wb').write(b'\xff\xd8\xff\xe0' + b'\0' * 20)
    open(other, 'wb').write(b'II*\0' + b'\0' * 20)
    open(lzma, 'wb').write(tiff(np.zeros((8, 8), np.int64), 8, 1,
                                compression=34925))
    with pytest.raises(ValueError, match='JPEG'):
        image_io.imread(jpeg)
    with pytest.raises(ValueError, match='TIFF: corrupt'):
        image_io.imread(other)
    assert cv2.imread(lzma, cv2.IMREAD_COLOR) is None
    with pytest.raises(ValueError, match='LZMA.*OpenCV does not read it '
                       'either'):
        image_io.imread(lzma)


@pytest.fixture(scope='module')
def hrsc_root(tmp_path_factory):
    """The generator's scenes, plus an image whose objects stand upright
    (w < h), carry other class ids, and one without an XML."""
    root = tmp_path_factory.mktemp('hrsc')
    port_gen.generate_synth_hrsc(str(root), num_images=6, size=192, seed=4)
    objs = [('100000001', 50, 60, 10, 40, 0.3),
            ('100000005', 120, 80, 60, 20, -1.2),
            ('100000033', 90, 140, 12, 12, 1.5),
            ('100000021', 30, 30, 20, 25, 0.0)]          # 21: not a class
    xml = '<HRSC_Image><HRSC_Objects>' + ''.join(
        f'<HRSC_Object><Class_ID>{c}</Class_ID><mbox_cx>{x}</mbox_cx>'
        f'<mbox_cy>{y}</mbox_cy><mbox_w>{w}</mbox_w><mbox_h>{h}</mbox_h>'
        f'<mbox_ang>{a}</mbox_ang></HRSC_Object>'
        for c, x, y, w, h, a in objs) + '</HRSC_Objects></HRSC_Image>'
    (root / 'FullDataSet/Annotations/U0000.xml').write_text(xml)
    image_io.imwrite(str(root / 'FullDataSet/AllImages/U0000.bmp'),
                     np.zeros((192, 192, 3), np.uint8))
    ids = (root / 'ImageSets/trainval.txt').read_text().split()
    (root / 'ImageSets/all.txt').write_text(
        '\n'.join(ids + ['U0000', 'NOXML']) + '\n')
    return root


def hrsc_spec(root, version, classwise, ann_file, **kw):
    return dict(type='HRSCDataset', version=version, classwise=classwise,
                ann_file=ann_file, img_prefix=f'{root}/FullDataSet/',
                pipeline=[], **kw)


@pytest.mark.parametrize('version', ['le90', 'oc', 'le135'])
@pytest.mark.parametrize('classwise', [False, True])
@pytest.mark.parametrize('source', ['imageset', 'folder'])
def test_hrsc_dataset_matches_jax(hrsc_root, version, classwise, source):
    ann_file = (f'{hrsc_root}/ImageSets/all.txt' if source == 'imageset'
                else f'{hrsc_root}/FullDataSet/Annotations')
    kw = dict(test_mode=True, filter_empty_gt=False)
    got = build_dataset(hrsc_spec(hrsc_root, version, classwise, ann_file,
                                  **kw))
    ref = jax_build_dataset(hrsc_spec(hrsc_root, version, classwise,
                                      ann_file, **kw))
    assert got.CLASSES == ref.CLASSES
    assert len(got.CLASSES) == (31 if classwise else 1)
    assert len(got) == len(ref) == (8 if source == 'imageset' else 7)
    for g, r in zip(got.data_infos, ref.data_infos):
        assert g['filename'] == r['filename']
        assert g['filename'].startswith('AllImages/')
        for key in ('bboxes', 'labels', 'bboxes_ignore', 'labels_ignore'):
            np.testing.assert_array_equal(g['ann'][key], r['ann'][key])
            assert g['ann'][key].dtype == r['ann'][key].dtype
    upright = [d for d in got.data_infos if 'U0000' in d['filename']][0]
    boxes = upright['ann']['bboxes']
    assert (boxes[:, 2] >= boxes[:, 3]).all()             # the long edge
    assert len(boxes) == (3 if classwise else 4)
    if classwise:
        assert upright['ann']['labels'].tolist() == [0, 4, 30]
    # the image-set file's filter of empty images, in training mode
    train = build_dataset(hrsc_spec(hrsc_root, version, classwise,
                                    f'{hrsc_root}/ImageSets/all.txt'))
    assert len(train) == 7 and 'NOXML' not in str(train.data_infos)


def test_hrsc_evaluate_matches_jax(hrsc_root):
    ann_file = f'{hrsc_root}/ImageSets/trainval.txt'
    spec = hrsc_spec(hrsc_root, 'le90', False, ann_file, test_mode=True)
    got, ref = build_dataset(spec), jax_build_dataset(spec)
    rng = np.random.default_rng(0)
    results = []
    for info in got.data_infos:
        gts = info['ann']['bboxes']
        moved = gts + rng.normal(0, [1.5, 1.5, 3, 1.5, 0.05], gts.shape)
        noise = np.stack([rng.uniform(0, 192, 3), rng.uniform(0, 192, 3),
                          rng.uniform(20, 60, 3), rng.uniform(5, 20, 3),
                          rng.uniform(-1.5, 1.5, 3)], -1)
        dets = np.concatenate([moved, noise]).astype(np.float32)
        scores = rng.uniform(0.1, 1, (len(dets), 1)).astype(np.float32)
        results.append([np.concatenate([dets, scores], -1)])
    metrics = got.evaluate(results, device='cpu')
    want = ref.evaluate(results)
    assert sorted(metrics) == ['AP50', 'AP75', 'mAP']
    for key in metrics:
        assert abs(metrics[key] - want[key]) <= AP_ATOL, (metrics, want)
    assert metrics['mAP'] == metrics['AP50'] > metrics['AP75'] > 0


def test_generate_hrsc_matches_jax(tmp_path):
    port_gen.main(['--root', str(tmp_path / 'port'), '--num-images', '4',
                   '--size', '160', '--seed', '5', '--hrsc', '--split',
                   'test'])
    jax_gen.generate_synth_hrsc(str(tmp_path / 'jax'), 4, 160, 5, 'test')
    for sub in ('ImageSets', 'FullDataSet/Annotations'):
        names = sorted(os.listdir(tmp_path / 'port' / sub))
        assert names == sorted(os.listdir(tmp_path / 'jax' / sub))
        for name in names:
            assert (tmp_path / 'port' / sub / name).read_bytes() == \
                (tmp_path / 'jax' / sub / name).read_bytes()
    images = sorted(os.listdir(tmp_path / 'port/FullDataSet/AllImages'))
    assert images == ['H0000.bmp', 'H0001.bmp', 'H0002.bmp', 'H0003.bmp']
    for name in images:
        got = image_io.imread(str(tmp_path / 'port/FullDataSet/AllImages' /
                                  name))
        ref = cv2.imread(str(tmp_path / 'jax/FullDataSet/AllImages' / name))
        np.testing.assert_array_equal(got, ref)
