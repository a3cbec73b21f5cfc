"""Rehearsal of ``chip_smoke.py``'s phase 57 (TIFF: the codec's digests, a
DOTA scene split into TIFF windows and served) on the CPU at a small size:
a 200^2 scene, 128^2 windows, where every wrapper takes its plain version
(so no launch is counted); and the digests phase 57 holds the card
machine's build to, against OpenCV: the TIFF writer's files and decodes,
and OpenCV's decodes of ``tests/image_corpus/``."""

import os

import cv2
import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_chip_smoke import NO_LAUNCHES, derived_config

torch.set_num_threads(2)


def opencv_encode(img):
    return cv2.imencode('.tif', img)[1].tobytes()


def opencv_decode(data):
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)


def test_tiff_digests_are_opencv_s():
    """``TIFF_DIGESTS`` are OpenCV's TIFF files and decodes of every seeded
    case (BGR and grey, across strip boundaries), and the port's writer
    and reader built here give the same."""
    ref = chip_smoke.codec_digests(encode=opencv_encode, decode=opencv_decode)
    assert sorted(ref) == sorted(chip_smoke.TIFF_DIGESTS)
    assert ref == chip_smoke.TIFF_DIGESTS
    assert chip_smoke.tiff_digests() == ref


def test_corpus_digests_are_opencv_s():
    """``CORPUS_DIGESTS`` are OpenCV's decodes of every committed corpus
    file (None where OpenCV gives no image), the port's readers give the
    same, and the corpus stays small."""
    assert chip_smoke.corpus_digests(opencv_decode) == \
        chip_smoke.CORPUS_DIGESTS
    assert chip_smoke.corpus_digests() == chip_smoke.CORPUS_DIGESTS
    names = os.listdir(chip_smoke.IMAGE_CORPUS)
    assert sum(os.path.getsize(os.path.join(chip_smoke.IMAGE_CORPUS, n))
               for n in names) < 200 * 1024
    assert any(v is None for v in chip_smoke.CORPUS_DIGESTS.values())


def test_scene_objects_cover_every_window():
    lines = chip_smoke.scene_objects(4000)
    assert len(lines) == 13 * 13
    pts = np.array([[float(v) for v in line.split()[:8]] for line in lines])
    assert pts.min() > 0 and pts.max() < 4000
    for x0 in range(0, 4000, 824):
        inside = ((pts[:, 0::2].min(1) >= x0) &
                  (pts[:, 0::2].max(1) < x0 + 1024))
        assert inside.any()


# Oriented R-CNN at 128 px: inference_detector's canvas and the proposals
# cut to the size
SMALL = """pad_size = (128, 128)
model = dict(test_cfg=dict(rpn=dict(max_per_img=200),
                           rcnn=dict(max_candidates=150)))
"""


def test_phase_tiff_rehearsal(tmp_path):
    config = derived_config(tmp_path, chip_smoke.ORCNN_CONFIG, SMALL)
    runs, captured = chip_smoke.phase_tiff(
        str(tmp_path / 'tiff'), 'cpu', scene=200, window=128, gap=32, bsz=2,
        dtype=torch.float32, max_num=200, max_candidates=150, reps=1,
        workers=2, rounds=1, cases=chip_smoke.CODEC_CASES[:3],
        timed=(128, 200), objects_step=40, config=config)
    assert runs == [NO_LAUNCHES] * 5
    boxes, cls = captured['tiff']
    assert boxes.shape == (2, 150, 5) and cls.shape == (2, 150)
    levels, rois = captured['tiff_roi']
    assert rois.shape == (2, 200, 5) and levels[0].shape[-1] == 256
    assert captured['tiff_merge']
    windows = os.listdir(tmp_path / 'tiff' / 'split_tif' / 'images')
    assert len(windows) == 4 and all(w.endswith('.tif') for w in windows)


def test_phase_tiff_refuses_other_digests(tmp_path):
    wrong = dict(chip_smoke.TIFF_DIGESTS)
    wrong['7x13-grey'] = (wrong['7x13-grey'][0], '0' * 64)
    with pytest.raises(AssertionError, match='7x13-grey'):
        chip_smoke.phase_tiff(str(tmp_path), 'cpu',
                              cases=chip_smoke.CODEC_CASES[1:2], digests=wrong)
    corpus = dict(chip_smoke.CORPUS_DIGESTS)
    corpus['cmyk.tif'] = '0' * 64
    with pytest.raises(AssertionError, match='cmyk.tif'):
        chip_smoke.phase_tiff(str(tmp_path), 'cpu',
                              cases=chip_smoke.CODEC_CASES[1:2],
                              corpus=corpus)
