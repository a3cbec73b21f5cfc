"""Rehearsal of ``chip_smoke.py``'s phases 53-55 (the JPEG codec, SAR ship
detection from JPEGs) on the CPU at a small size: 128^2 images, 4 images
in the test split, a 300^2 scene, where every wrapper takes its plain
version (so no launch is counted); and the codec digests that phase 53
holds the card machine's build to, against OpenCV's encoder and decoder."""

import cv2
import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_chip_smoke import NO_LAUNCHES, derived_config

torch.set_num_threads(2)


def opencv_encode(img):
    return cv2.imencode('.jpg', img)[1].tobytes()


def opencv_decode(data):
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)


def test_codec_digests_are_opencv_s():
    """``CODEC_DIGESTS`` are OpenCV's files and decodes of every case, and
    the port's codec built here gives the same."""
    ref = chip_smoke.codec_digests(encode=opencv_encode,
                                   decode=opencv_decode)
    assert sorted(ref) == sorted(f'{name}-{kind}' for name, *_ in
                                 chip_smoke.CODEC_CASES
                                 for kind in ('bgr', 'grey'))
    assert ref == chip_smoke.CODEC_DIGESTS
    assert chip_smoke.codec_digests() == ref


def test_codec_image_is_made_in_integers():
    a = chip_smoke.codec_image(97, 131, seed=3)
    assert a.shape == (97, 131, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, chip_smoke.codec_image(97, 131, seed=3))
    assert not np.array_equal(a, chip_smoke.codec_image(97, 131, seed=4))
    grey = chip_smoke.codec_image(7, 13, grey=True)
    assert grey.shape == (7, 13) and 20 < a.std() < 80


def test_phase_codec_rehearsal(tmp_path):
    result = chip_smoke.phase_codec(
        str(tmp_path), cases=chip_smoke.CODEC_CASES[:3], timed=(128,),
        reps=1, loader_size=128, loader_images=8, bsz=4, num_workers=2,
        rounds=1)
    assert result['encode_ms'][128] > 0 and result['decode_ms'][128] > 0
    assert len(result['loader']['.jpg']) == len(result['loader']['.png']) \
        == 1
    assert min(result['loader']['.jpg'] + result['loader']['.png']) > 0
    assert result['decoder_imgs_per_s'] > 0


def test_phase_codec_refuses_other_digests(tmp_path):
    wrong = dict(chip_smoke.CODEC_DIGESTS)
    wrong['7x13-grey'] = (wrong['7x13-grey'][0], '0' * 64)
    with pytest.raises(AssertionError, match='7x13-grey'):
        chip_smoke.phase_codec(str(tmp_path),
                               cases=chip_smoke.CODEC_CASES[1:2],
                               digests=wrong, timed=())


# the SAR configs at 128 px: inference_detector's and the loader's canvas,
# the test pipeline's scale and the proposals cut to the size
SMALL = """pad_size = (128, 128)
model = dict(test_cfg=dict(rpn=dict(max_per_img=200),
                           rcnn=dict(max_candidates=150)))
"""
SMALL_TEST = """pad_size = (128, 128)
img_norm_cfg = dict(mean=[21.55, 21.55, 21.55],
                    std=[24.42, 24.42, 24.42], to_rgb=True)
data = dict(test=dict(pipeline=[
    dict(type='LoadImageFromFile'),
    dict(type='MultiScaleFlipAug', img_scale=(128, 128), flip=False,
         transforms=[dict(type='RResize'),
                     dict(type='Normalize', **img_norm_cfg),
                     dict(type='Pad', size_divisor=32),
                     dict(type='DefaultFormatBundle'),
                     dict(type='Collect', keys=['img'])])]))
"""


def test_phase_sar_serving_rehearsal(tmp_path):
    config = derived_config(tmp_path, chip_smoke.SAR_CONFIG, SMALL)
    runs, captured = chip_smoke.phase_sar_serving(
        str(tmp_path), 'cpu', bsz=2, size=128, warm=1, timed=1, slice_bsz=1,
        served=1, dtype=torch.float32, max_num=200, max_candidates=150,
        config=config)
    assert runs == [NO_LAUNCHES] * 2
    boxes, cls = captured['sar']
    assert boxes.shape == (2, 150, 5) and cls.shape == (2, 150)
    levels, rois = captured['sar_roi']
    assert rois.shape == (2, 200, 5) and levels[0].shape[-1] == 256


def test_phase_sar_split_rehearsal(tmp_path):
    config = derived_config(tmp_path, chip_smoke.SSDD_CONFIG,
                            SMALL + SMALL_TEST)
    retina = derived_config(tmp_path, chip_smoke.SSDD_RETINA_CONFIG,
                            SMALL_TEST)
    runs = chip_smoke.phase_sar_split(
        str(tmp_path), 'cpu', n_images=4, size=128, batch_size=2,
        slice_bsz=1, scene=300, window=128, gap=32, max_candidates=150,
        config=config, retina_config=retina)
    assert runs == [NO_LAUNCHES]
