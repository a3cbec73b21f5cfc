"""Rehearsal of ``chip_smoke.py``'s phase 58 (a batch of SAR products as
signed 16-bit TIFFs, served) on the CPU at the smallest size that runs each
of its checks: 1 image of 128^2, where every wrapper takes its plain
version (so no launch is counted); and its TIFF writer and its timed T.6
and LogLuv scenes against OpenCV."""

import cv2
import numpy as np
import pytest
import torch

import chip_smoke
from orientedobjectdetection_torch.utils import image_io
from test_torch_chip_smoke import NO_LAUNCHES, derived_config

torch.set_num_threads(2)

# the HRSID config at 128 px: inference_detector's canvas and the
# proposals cut to the size
SMALL = """pad_size = (128, 128)
model = dict(test_cfg=dict(rpn=dict(max_per_img=200),
                           rcnn=dict(max_candidates=150)))
"""


@pytest.mark.parametrize('size', [37, 128])
def test_int16_tiff_reads_as_opencv_reads_it(size):
    """OpenCV reads the phase's signed 16-bit grey TIFF by its samples'
    high bytes: the scene, negative samples included."""
    scene = chip_smoke.sar_scene(size, seed=3)
    assert (scene >= 128).any() and scene.mean() < 100
    data = chip_smoke.int16_grey_tiff(scene, seed=4)
    samples = np.frombuffer(data[8:8 + 2 * size * size], '<i2')
    assert (samples < 0).any()
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(want, np.repeat(scene[..., None], 3, -1))


def test_phase_sar_tiff_rehearsal(tmp_path):
    config = derived_config(tmp_path, chip_smoke.SAR_CONFIG, SMALL)
    runs, captured = chip_smoke.phase_sar_tiff(
        str(tmp_path), 'cpu', bsz=1, size=128, dtype=torch.float32,
        max_num=200, max_candidates=150, config=config, timed_side=64,
        reps=1)
    assert runs == [NO_LAUNCHES] * 2
    boxes, cls = captured['sar_tiff']
    assert boxes.shape == (1, 150, 5) and cls.shape == (1, 150)
    levels, rois = captured['sar_tiff_roi']
    assert rois.shape == (1, 200, 5) and levels[0].shape[-1] == 256
    tiffs = sorted((tmp_path / 'sar_tiff').glob('*.tif'))
    assert len(tiffs) == 1


def test_timed_scenes_read_as_opencv_reads_them():
    """The T.6 and LogLuv32 scenes the phase times decode to OpenCV's
    arrays."""
    for name, data in chip_smoke.fax_and_luv_scenes(64).items():
        want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        assert want is not None and want.shape == (64, 64, 3), name
        np.testing.assert_array_equal(image_io.imdecode(data), want)
