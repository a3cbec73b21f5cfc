"""The port's drawing without OpenCV against OpenCV and the JAX package's
``core/visualization.py``:

- ``utils/image_io.py:line`` equals ``cv2.line`` and the polygons equal
  ``cv2.polylines``, thickness 1 to 4, inside and across the image's
  edges, pixel for pixel;
- ``utils/font.py``'s glyphs are ``cv2.putText``'s (``FONT_HERSHEY_SIMPLEX``
  at scale 0.5, thickness 1) where OpenCV's antialiased coverage is at least
  half, for every printable character and for the labels' strings;
- ``imshow_det_rbboxes`` and ``imshow_gt_det_rbboxes`` equal the JAX
  package's outside the label boxes (where OpenCV blends the text's edges);
- the JET colour map and ``add_weighted`` equal ``cv2.applyColorMap`` and
  ``cv2.addWeighted``.
"""

import cv2
import numpy as np
import pytest

from orientedobjectdetection_tpu.core import visualization as j_vis
from orientedobjectdetection_torch.core import visualization as vis
from orientedobjectdetection_torch.utils import font, image_io

FONT = cv2.FONT_HERSHEY_SIMPLEX


@pytest.mark.parametrize('thickness', [1, 2, 3, 4])
def test_line_equals_opencv(thickness):
    rng = np.random.default_rng(thickness)
    for _ in range(150):
        p0, p1 = (tuple(int(v) for v in rng.integers(-60, 160, 2))
                  for _ in range(2))
        ref = np.zeros((100, 90, 3), np.uint8)
        got = ref.copy()
        cv2.line(ref, p0, p1, (1, 2, 3), thickness)
        image_io.line(got, p0, p1, (1, 2, 3), thickness)
        np.testing.assert_array_equal(got, ref, err_msg=f'{p0} {p1}')


@pytest.mark.parametrize('thickness', [1, 2, 3])
def test_polygons_equal_polylines(thickness):
    rng = np.random.default_rng(10 + thickness)
    for _ in range(100):
        pts = rng.integers(-40, 140, (4, 2)).astype(np.int32)
        ref = np.zeros((100, 100, 3), np.uint8)
        got = ref.copy()
        cv2.polylines(ref, [pts], True, (9, 8, 7), thickness)
        vis.draw_polygon(got, pts, (9, 8, 7), thickness)
        np.testing.assert_array_equal(got, ref)


def test_every_glyph_is_opencv_s_at_half_coverage():
    for c in map(chr, range(32, 127)):
        ref = np.zeros((40, 40), np.uint8)
        cv2.putText(ref, c, (10, 25), FONT, 0.5, 255, 1)
        got = np.zeros((40, 40), np.uint8)
        font.put_text(got, c, (10, 25), 0.5, 255)
        np.testing.assert_array_equal(got > 0, ref >= 128, err_msg=repr(c))
        twenty = cv2.getTextSize(c * 20, FONT, 0.5, 1)[0][0]
        ten = cv2.getTextSize(c * 10, FONT, 0.5, 1)[0][0]
        assert font.text_width(c) == (twenty - ten) // 10


@pytest.mark.parametrize('text', ['plane|0.95', 'large-vehicle|1.00',
                                  'ship', '0|0.31', 'ground-track-field'])
def test_labels_are_opencv_s_at_half_coverage(text):
    ref = np.zeros((30, 200, 3), np.uint8)
    cv2.putText(ref, text, (3, 18), FONT, 0.5, (255, 255, 255), 1)
    got = np.zeros((30, 200, 3), np.uint8)
    font.put_text(got, text, (3, 18), 0.5, (255, 255, 255))
    np.testing.assert_array_equal(got[..., 0] > 0, ref[..., 0] >= 128)
    # clipped at the image's edges, other characters drawn as '?'
    edge = np.zeros((10, 20, 3), np.uint8)
    font.put_text(edge, 'planeé', (-3, 5), 1.0, (1, 1, 1))
    assert edge.any()


def scene(seed=0, size=256, classes=3):
    """A noisy image and per-class detections, some across the edges."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 120, (size, size, 3)).astype(np.uint8)
    result = []
    for c in range(classes):
        n = 4
        dets = np.stack([rng.uniform(-20, size + 20, n),
                         rng.uniform(10, size + 20, n),
                         rng.uniform(10, 90, n), rng.uniform(8, 60, n),
                         rng.uniform(-1.5, 1.5, n), rng.uniform(0, 1, n)],
                        -1).astype(np.float32)
        result.append(dets)
    return img, result


def label_boxes(result, score_thr, version, names, font_scale=0.5):
    """A mask of every label's box: its glyph rows and columns, one pixel
    more around them."""
    from orientedobjectdetection_torch.ops.boxes import obb2poly_np
    mask = np.zeros((400, 600), bool)
    k = font_scale / font.BASE_SCALE
    for cls, dets in enumerate(result):
        dets = dets[dets[:, 5] >= score_thr]
        for p in obb2poly_np(dets, version):
            x, y = int(p[0]), int(p[1]) - 3
            text = f'{names[cls] if names else cls}|{p[8]:.2f}'
            top, left = y - int(round(font.ABOVE * k)) - 1, x - 2
            bottom = top + int(round(font.ROWS * k)) + 2
            right = x + font.text_width(text, font_scale) + \
                int(round(font.COLS * k)) + 1
            mask[max(top, 0) + 100:bottom + 100,
                 max(left, -100) + 100:right + 100] = True
    return mask[100:, 100:]


@pytest.mark.parametrize('version', ['le90', 'oc'])
@pytest.mark.parametrize('names', [None, ('plane', 'ship', 'harbor')])
def test_imshow_det_rbboxes_equals_jax_outside_the_labels(version, names,
                                                          tmp_path):
    img, result = scene(1)
    ref = j_vis.imshow_det_rbboxes(img, result, class_names=names,
                                   score_thr=0.3, version=version)
    out_file = str(tmp_path / 'det.png')
    got = vis.imshow_det_rbboxes(img, result, class_names=names,
                                 score_thr=0.3, version=version,
                                 out_file=out_file)
    assert got.shape == ref.shape and not np.shares_memory(got, img)
    outside = ~label_boxes(result, 0.3, version, names)[:256, :256]
    drawn = (ref != img).any(-1) & outside
    assert drawn.sum() > 500                     # polygons are drawn
    np.testing.assert_array_equal(got[outside], ref[outside])
    np.testing.assert_array_equal(image_io.imread(out_file), got)


def test_palettes_and_a_path(tmp_path):
    img, result = scene(2)
    path = str(tmp_path / 'img.png')
    image_io.imwrite(path, img)
    for palette in vis.PALETTES:
        ref = j_vis.imshow_det_rbboxes(img, result, palette=palette)
        got = vis.imshow_det_rbboxes(path, result, palette=palette)
        outside = ~label_boxes(result, 0.3, 'le90', None)[:256, :256]
        np.testing.assert_array_equal(got[outside], ref[outside])
    with pytest.raises(ValueError, match='palette'):
        vis.imshow_det_rbboxes(img, result, palette='rainbow')


def test_imshow_gt_det_rbboxes_equals_jax_outside_the_labels():
    img, result = scene(3)
    rng = np.random.default_rng(5)
    gts = result[0][:, :5].copy()
    labels = rng.integers(0, 3, len(gts))
    ref = j_vis.imshow_gt_det_rbboxes(img, gts, labels, result,
                                      class_names=None, score_thr=0.3)
    got = vis.imshow_gt_det_rbboxes(img, gts, labels, result,
                                    class_names=None, score_thr=0.3)
    assert got.shape == ref.shape == (256, 256 * 2 + 4, 3)
    gt_result = [np.concatenate([gts[labels == c],
                                 np.ones((int((labels == c).sum()), 1),
                                         np.float32)], -1)
                 for c in range(3)]
    gt_mask = label_boxes(gt_result, 0, 'le90', None)[:256, :256]
    det_mask = label_boxes(result, 0.3, 'le90', None)[:256, :256]
    # a gt's label is its class alone: its box is narrower than masked
    outside = ~np.concatenate([gt_mask, np.zeros((256, 4), bool), det_mask],
                              1)
    np.testing.assert_array_equal(got[outside], ref[outside])


def test_jet_colormap_equals_opencv():
    gray = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(image_io.apply_colormap_jet(gray),
                                  cv2.applyColorMap(gray, cv2.COLORMAP_JET))
    rng = np.random.default_rng(0)
    gray = rng.integers(0, 256, (40, 50)).astype(np.uint8)
    np.testing.assert_array_equal(image_io.apply_colormap_jet(gray),
                                  cv2.applyColorMap(gray, cv2.COLORMAP_JET))
    with pytest.raises(ValueError):
        image_io.apply_colormap_jet(gray.astype(np.float32))


@pytest.mark.parametrize('weights', [(0.5, 0.5, 0.0), (0.3, 0.7, 0.0),
                                     (0.25, 0.8, 3.5), (1.5, -0.2, 10.0),
                                     (0.1, 0.9, -4.0)])
def test_add_weighted_equals_opencv(weights):
    rng = np.random.default_rng(1)
    a = rng.integers(0, 256, (64, 80, 3)).astype(np.uint8)
    b = rng.integers(0, 256, (64, 80, 3)).astype(np.uint8)
    alpha, beta, gamma = weights
    np.testing.assert_array_equal(
        image_io.add_weighted(a, alpha, b, beta, gamma),
        cv2.addWeighted(a, alpha, b, beta, gamma))
