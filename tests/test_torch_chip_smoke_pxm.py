"""Rehearsal of ``chip_smoke.py``'s phase 59 (a batch of SAR products as
16-bit PGMs and as PPMs, served) on the CPU at the smallest size that runs
each of its checks: 1 image of 128^2, where every wrapper takes its plain
version (so no launch is counted), the detections from the PGM and the
PPM held to the JPEG's as on the card; and its 16-bit PGM and its timed
scenes against OpenCV."""

import cv2
import numpy as np
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


def test_uint16_pgm_reads_as_opencv_reads_it(tmp_path):
    """OpenCV reads the phase's 16-bit PGM by its samples' high bytes:
    the scene."""
    scene = chip_smoke.sar_scene(37, seed=3)
    samples = chip_smoke.uint16_grey(scene, seed=4)
    assert samples.dtype == np.uint16 and (samples & 0xFF).any()
    path = str(tmp_path / 'x.pgm')
    image_io.imwrite(path, samples)
    want = cv2.imread(path, cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(want, np.repeat(scene[..., None], 3, -1))
    with open(path, 'rb') as f:
        assert f.read() == cv2.imencode('.pgm', samples)[1].tobytes()


def test_phase_sar_pxm_rehearsal(tmp_path):
    config = derived_config(tmp_path, chip_smoke.SAR_CONFIG, SMALL)
    runs, captured = chip_smoke.phase_sar_pxm(
        str(tmp_path), 'cpu', bsz=1, size=128, dtype=torch.float32,
        max_num=200, max_candidates=150, config=config, timed_side=64,
        reps=1)
    assert runs == [NO_LAUNCHES] * 3
    boxes, cls = captured['sar_pxm']
    assert boxes.shape == (1, 150, 5) and cls.shape == (1, 150)
    levels, rois = captured['sar_pxm_roi']
    assert rois.shape == (1, 200, 5) and levels[0].shape[-1] == 256
    for kind in ('pgm', 'ppm', 'jpg'):
        assert len(list((tmp_path / 'sar_pxm').glob(f'*.{kind}'))) == 1


def test_timed_scenes_read_as_opencv_reads_them():
    """The PPM, 16-bit PGM, PFM, RLE HDR and Sun raster scenes the phase
    times are OpenCV's bytes and decode to OpenCV's arrays."""
    scenes = chip_smoke.raster_scenes(70, tile=32)
    assert sorted(scenes) == ['hdr', 'pfm', 'pgm16', 'ppm', 'ras']
    for name, data in scenes.items():
        want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        assert want is not None and want.shape == (70, 70, 3), name
        np.testing.assert_array_equal(image_io.imdecode(data), want)
    at = scenes['hdr'].index(b'-Y 70 +X 70\n') + 12
    assert scenes['hdr'][at:at + 4] == b'\x02\x02\x00\x46'   # RLE rows
