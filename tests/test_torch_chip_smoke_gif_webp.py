"""Rehearsal of ``chip_smoke.py``'s phase 60 (a batch of SAR products as
lossless WebPs and as GIFs, served) on the CPU at the smallest size that
runs each of its checks: 1 image of 128^2, where every wrapper takes its
plain version (so no launch is counted), the WebP's detections held to
the JPEG's and the GIF's counted as on the card; and the digests phase 57
and phase 60 hold the card machine's build to, against OpenCV."""

import hashlib

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


def opencv_gif(img):
    return cv2.imencode('.gif', img)[1].tobytes()


def opencv_decode(data):
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)


def opencv_sar_gif_digests(bsz, size):
    """OpenCV's decode of OpenCV's GIF of each scene phase 60 writes (the
    scene through OpenCV's JPEG codec, which the port's equals)."""
    out = []
    for i in range(bsz):
        jpeg = cv2.imencode('.jpg', chip_smoke.sar_scene(size, 100 + i))[1]
        scene = cv2.imdecode(jpeg, cv2.IMREAD_COLOR)
        out.append(hashlib.sha256(
            opencv_decode(opencv_gif(scene)).tobytes()).hexdigest())
    return tuple(out)


def test_gif_digests_are_opencv_s():
    """``GIF_DIGESTS`` are OpenCV's GIF files and decodes of every seeded
    case in BGR and in BGRA with transparent pixels, and the port's writer
    and reader built here give the same."""
    ref = chip_smoke.gif_digests(encode=opencv_gif, decode=opencv_decode)
    assert sorted(ref) == sorted(chip_smoke.GIF_DIGESTS)
    assert ref == chip_smoke.GIF_DIGESTS
    assert chip_smoke.gif_digests() == ref
    img = chip_smoke.gif_image(97, 131, 7 * 97 + 131, alpha=True)
    assert (img[..., 3] == 0).any() and (img[..., 3] == 255).any()


def test_sar_gif_digests_are_opencv_s():
    assert opencv_sar_gif_digests(8, 800) == chip_smoke.SAR_GIF_DIGESTS


def test_phase_sar_gif_webp_rehearsal(tmp_path):
    config = derived_config(tmp_path, chip_smoke.SAR_CONFIG, SMALL)
    runs, captured = chip_smoke.phase_sar_gif_webp(
        str(tmp_path), 'cpu', bsz=1, size=128, dtype=torch.float32,
        max_num=200, max_candidates=150, config=config,
        gif_digests=opencv_sar_gif_digests(1, 128), timed_side=64, reps=1)
    assert runs == [NO_LAUNCHES] * 3
    boxes, cls = captured['sar_gif']
    assert boxes.shape == (1, 150, 5) and cls.shape == (1, 150)
    levels, rois = captured['sar_gif_roi']
    assert rois.shape == (1, 200, 5) and levels[0].shape[-1] == 256
    for kind in ('webp', 'gif', 'jpg'):
        assert len(list((tmp_path / 'sar_gif_webp').glob(f'*.{kind}'))) == 1


def test_phase_sar_gif_webp_refuses_other_digests(tmp_path):
    with pytest.raises(AssertionError, match=r'GIFs \[0\]'):
        chip_smoke.phase_sar_gif_webp(str(tmp_path), 'cpu', bsz=1, size=32,
                                      gif_digests=('0' * 64,))


def test_timed_scenes_read_as_opencv_reads_them():
    """The GIF scene phase 60 times is OpenCV's bytes, and both scenes
    decode to OpenCV's arrays; the WebP holds the scene's pixels."""
    scenes = chip_smoke.gif_webp_scenes(70, tile=32)
    tile = chip_smoke.codec_image(32, 32, seed=70)
    img = np.tile(tile, (3, 3, 1))[:70, :70]
    assert scenes['gif'] == opencv_gif(np.ascontiguousarray(img))
    for data in scenes.values():
        np.testing.assert_array_equal(image_io.imdecode(data),
                                      opencv_decode(data))
    np.testing.assert_array_equal(opencv_decode(scenes['webp']), img)
