"""SAR ship detection from JPEGs, the port against the JAX package:

- a ``.jpg`` test split (SSDD's, HRSID's and the SSDD RetinaNet's configs;
  the DOTA glob) gives equal ``data_infos`` and equal pipeline outputs in
  both packages (images at each config's scale, where the resize is a
  copy): the port's decoder reads what OpenCV reads;
- the HRSID Oriented R-CNN (R50-FPN, one class) at 128 px, seeded JAX
  weights carried across, serves a JPEG written by OpenCV to the JAX
  package's detections through ``inference_detector`` on its path, at
  ``tests/test_torch_two_stage.py``'s tolerances for the slice (valid
  counts and labels exact, boxes and scores within 1e-3); the path and its
  decoded array give the port the same detections;
- the writers: ``imshow_det_rbboxes`` and ``tools.image_demo`` with a
  ``.jpg`` out file write a JPEG (the bytes OpenCV writes of the drawing),
  ``tools.heatmap`` reads a ``.jpg`` image.
"""

import os
import os.path as osp

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orientedobjectdetection_tpu.apis.inference import \
    DetectorBundle as JBundle
from orientedobjectdetection_tpu.apis.inference import \
    inference_detector as j_inference_detector
from orientedobjectdetection_tpu.datasets import \
    build_dataset as j_build_dataset
from orientedobjectdetection_tpu.models import build_detector as j_build
from orientedobjectdetection_tpu.utils.config import Config as JConfig
from orientedobjectdetection_torch.apis import (inference_detector,
                                                init_detector)
from orientedobjectdetection_torch.datasets import build_dataset
from orientedobjectdetection_torch.utils import Config
from orientedobjectdetection_torch.utils.image_io import imread
from orientedobjectdetection_torch.utils.jax_weights import \
    from_jax_variables
from test_torch_two_stage import perturb_variables

torch.set_num_threads(2)

ROOT = osp.join(osp.dirname(osp.abspath(__file__)), '..')
HRSID = osp.join(ROOT, 'configs', 'oriented_rcnn',
                 'oriented_rcnn_r50_fpn_6x_hrsid_le90.py')
SSDD = osp.join(ROOT, 'configs', 'oriented_rcnn',
                'oriented_rcnn_r50_fpn_6x_ssdd_le90.py')
SSDD_RETINA = osp.join(ROOT, 'configs', 'sar',
                       'rotated_retinanet_obb_r50_fpn_1x_ssdd_le90.py')
SIZE = 128
# the HRSID config at SIZE px: inference_detector's canvas and the proposals
# cut to the size (2000 proposals and candidates take the JAX package a
# minute to compile; 200 and 150 run every check)
SMALL = f"""pad_size = ({SIZE}, {SIZE})
model = dict(test_cfg=dict(rpn=dict(max_per_img=200),
                           rcnn=dict(max_candidates=150)))
"""


def speckle(seed, h, w):
    """A seeded SAR-like image: the product of two uniform draws (dark,
    skewed; the SAR configs normalize by mean 21.55, deviation 24.42),
    blurred a little as a sensor's point spread would."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (h, w, 3)) * rng.uniform(0, 86, (h, w, 3))
    return cv2.GaussianBlur(img.astype(np.float32), (3, 3), 0).astype(
        np.uint8)


def split_config(config, folder):
    """``config``'s test split pointed at ``folder`` (no annotation files:
    the images are the split)."""
    return lambda cfg: dict(cfg.data['test'], ann_file=folder + '/',
                            img_prefix=folder + '/', test_mode=True,
                            filter_empty_gt=False)


@pytest.mark.parametrize('config,scale', [(SSDD, 512), (HRSID, 800),
                                          (SSDD_RETINA, 1024)])
def test_jpg_test_split_loads_as_in_jax(tmp_path, config, scale):
    folder = str(tmp_path / 'images')
    os.makedirs(folder)
    for i, (h, w) in enumerate([(scale, scale), (scale * 3 // 4, scale)]):
        cv2.imwrite(osp.join(folder, f'{i:04d}.jpg'), speckle(i, h, w))
    cv2.imwrite(osp.join(folder, '0002.png'), speckle(2, scale, scale // 2))
    split = split_config(config, folder)
    ours = build_dataset(split(Config.fromfile(config)))
    theirs = j_build_dataset(split(JConfig.fromfile(config)))
    assert [d['filename'] for d in ours.data_infos] == \
        ['0002.png', '0000.jpg', '0001.jpg']          # the DOTA glob's order
    assert len(ours.data_infos) == len(theirs.data_infos)
    for a, b in zip(ours.data_infos, theirs.data_infos):
        assert a['filename'] == b['filename']
        for key in ('bboxes', 'labels'):
            np.testing.assert_array_equal(a['ann'][key], b['ann'][key])
    for i in range(len(ours)):
        got, ref = ours[i], theirs[i]
        assert sorted(got) == sorted(ref) == ['img', 'img_metas']
        assert got['img'].dtype == ref['img'].dtype
        np.testing.assert_array_equal(got['img'], ref['img'])
        assert sorted(got['img_metas']) == sorted(ref['img_metas'])
        for key, value in ref['img_metas'].items():
            np.testing.assert_array_equal(np.asarray(got['img_metas'][key]),
                                          np.asarray(value), err_msg=key)


class Hrsid:
    """The HRSID Oriented R-CNN in both packages on the same seeded JAX
    weights, served at ``SIZE`` px (``pad_size``), its proposals cut to the
    size (``SMALL``)."""

    def __init__(self, tmp):
        self.config = str(tmp / 'hrsid_small.py')
        with open(self.config, 'w') as f:
            f.write(f'_base_ = [{HRSID!r}]\n' + SMALL)
        self.jcfg = JConfig.fromfile(self.config)
        self.jdet = j_build(dict(self.jcfg.model))
        shapes = jax.eval_shape(
            self.jdet.init, jax.random.PRNGKey(0),
            jnp.zeros((1, SIZE, SIZE, 3), jnp.float32))
        self.variables = perturb_variables(shapes, 17)
        self.jbundle = JBundle(self.jcfg, self.jdet, self.variables)
        self.state = from_jax_variables(self.variables)
        self.cfg = Config.fromfile(self.config)
        self.bundle = init_detector(self.cfg, self.state, device='cpu')
        self.jpeg = str(tmp / 'ship.jpg')
        cv2.imwrite(self.jpeg, speckle(7, SIZE - 8, SIZE))


@pytest.fixture(scope='module')
def hrsid(tmp_path_factory):
    return Hrsid(tmp_path_factory.mktemp('hrsid'))


def test_hrsid_serves_a_jpeg_as_jax_does(hrsid):
    norm = hrsid.cfg.img_norm_cfg
    assert hrsid.bundle.two_stage and hrsid.bundle.num_classes == 1
    ref = j_inference_detector(hrsid.jbundle, hrsid.jpeg, dict(norm))
    got = inference_detector(hrsid.bundle, hrsid.jpeg, dict(norm))
    assert len(got) == len(ref) == 1 and len(ref[0]) > 5
    assert got[0].shape == np.asarray(ref[0]).shape
    np.testing.assert_allclose(got[0], np.asarray(ref[0]), atol=1e-3)
    again = inference_detector(hrsid.bundle, imread(hrsid.jpeg), dict(norm))
    np.testing.assert_array_equal(again[0], got[0])


def test_jpeg_out_files_are_the_encoder_s(hrsid, tmp_path):
    """``imshow_det_rbboxes`` and ``tools.image_demo`` write a ``.jpg`` out
    file as ``cv2.imwrite`` does (they wrote PNG bytes under that name);
    ``tools.heatmap`` reads the JPEG."""
    from orientedobjectdetection_torch.core.visualization import \
        imshow_det_rbboxes
    from orientedobjectdetection_torch.tools import heatmap, image_demo
    result = [np.array([[40, 50, 30, 12, 0.3, 0.9],
                        [90, 70, 20, 20, -1.0, 0.6]], np.float32)]
    out = str(tmp_path / 'drawn.jpg')
    drawn = imshow_det_rbboxes(hrsid.jpeg, result, class_names=('ship',),
                               score_thr=0.5, out_file=out)
    with open(out, 'rb') as f:
        assert f.read() == cv2.imencode('.jpg', drawn)[1].tobytes()
    ckpt = str(tmp_path / 'hrsid.pth')
    torch.save(hrsid.state, ckpt)
    demo = str(tmp_path / 'demo.jpg')
    image_demo.main([hrsid.jpeg, hrsid.config, ckpt, '--out-file', demo,
                     '--device', 'cpu', '--score-thr', '0.99'])
    with open(demo, 'rb') as f:
        assert f.read(3) == b'\xff\xd8\xff'
    np.testing.assert_array_equal(imread(demo),
                                  cv2.imread(demo, cv2.IMREAD_COLOR))
    overlay = heatmap.heatmap(hrsid.bundle, hrsid.jpeg, 0, 'mean')
    assert overlay.shape == (SIZE, SIZE, 3)
