"""Rehearsal of ``chip_smoke.py``'s phases 50-52 (prototype4 with the YOLOv6
Rep-PAFPN neck, the YOLO block library, reference checkpoints through the
converter) on the CPU at a tiny size: the configs with the backbone and
neck at deepen 0.33 / widen 0.125 at 128 px, the tiny ReDet, the blocks at
an eighth of their widths, where every wrapper takes its plain version (so
no launch is counted)."""

import os.path as osp

import pytest
import torch

import chip_smoke
from test_torch_chip_smoke import NO_LAUNCHES, derived_config
from test_torch_chip_smoke_yolov8 import TINY_YOLO

torch.set_num_threads(1)

TINY_SIZES = dict(widths=(24, 48, 72), sizes=(16, 8, 4), guide=(5, 32))


@pytest.fixture
def tiny_v6(tmp_path):
    return derived_config(tmp_path, chip_smoke.yolov6_config(str(tmp_path)),
                          TINY_YOLO)


def test_yolov6_config_is_prototype4_with_the_rep_pafpn(tmp_path):
    """The phase's model: prototype4's backbone and head, the v6 neck with
    8 RepVGG blocks a stage and the head's widths (built, not run)."""
    from orientedobjectdetection_torch.models import build_detector
    from orientedobjectdetection_torch.models.necks.pafpn import \
        YOLOv6RepPAFPN
    from orientedobjectdetection_torch.utils import Config
    cfg = Config.fromfile(chip_smoke.yolov6_config(str(tmp_path)))
    assert dict(cfg.model['neck']) == chip_smoke.YOLOV6_NECK
    ref = Config.fromfile(chip_smoke.YOLO_CONFIGS['prototype4']).model
    assert cfg.model['backbone'] == ref['backbone']
    assert cfg.model['bbox_head'] == ref['bbox_head']
    det = build_detector(dict(cfg.model))
    assert isinstance(det.neck, YOLOv6RepPAFPN)
    assert det.neck.out_widths == [192, 384, 576]
    assert det.neck.bottom_up_1.num_blocks == 8


def test_phase_yolov6_slice_rehearsal(tiny_v6):
    captured = chip_smoke.phase_yolov6_slice('cpu', tiny_v6, bsz=1, size=128,
                                             g=8, valid=3,
                                             max_candidates=300)
    assert sorted(captured) == ['yolov6_slice_assign', 'yolov6_slice_nms']
    (boxes, cls), = captured['yolov6_slice_nms']
    assert boxes.shape == (1, 300, 5) and cls.shape == (1, 300)
    (preds, gts, mode), = captured['yolov6_slice_assign']
    assert preds.shape == (1, 336, 5) and gts.shape == (1, 8, 5)
    assert mode == 'iou'


def test_decided_rule_refuses_a_tie(tiny_v6):
    """Two equal gts share their best point: not decided."""
    from orientedobjectdetection_torch.models import build_detector
    from orientedobjectdetection_torch.utils import Config
    det = build_detector(dict(Config.fromfile(tiny_v6).model))
    det.init_weights(0)
    with torch.no_grad():
        outputs = det(torch.randn(1, 3, 128, 128))
    box = torch.tensor([40.3, 52.7, 30.0, 20.0, 0.2])
    gts = (torch.stack([box, box])[None], torch.tensor([[1, 2]]),
           torch.ones(1, 2, dtype=torch.bool))
    assert not chip_smoke.yolo_decided(det.bbox_head, outputs, gts)


def test_phase_yolov6_rehearsal(tiny_v6):
    runs, captured = chip_smoke.phase_yolov6(
        'cpu', config=tiny_v6, bsz=1, size=128, warm=2, timed=1,
        train_timed=4, g=8, valid=3, dtype=torch.float32,
        max_candidates=300)
    assert runs == [NO_LAUNCHES] * 2
    boxes, cls = captured['yolov6']
    assert boxes.shape == (1, 300, 5) and cls.shape == (1, 300)
    (preds, gts, _), = captured['yolov6_train']
    assert preds.shape == (1, 336, 5) and gts.shape == (1, 8, 5)


def test_block_cases_cover_the_library():
    """38 classes, ASFF at each of its three levels."""
    from orientedobjectdetection_torch.models import yolo_blocks
    cases = chip_smoke.block_cases(**TINY_SIZES)
    assert len(cases) == 40
    names = {n.split('_level')[0] for n in cases}
    own = {n for n in yolo_blocks.__all__
           if getattr(yolo_blocks, n).__module__ == yolo_blocks.__name__
           and getattr(yolo_blocks, n).__name__ == n}
    assert names == own and len(own) == 38


def test_phase_blocks_rehearsal():
    records = chip_smoke.phase_blocks(
        'cpu', bsz=2, reps=1, cases=chip_smoke.block_cases(**TINY_SIZES))
    assert len(records) == 40
    for rec in records:
        assert rec['err'] <= chip_smoke.BLOCK_RTOL and rec['ms'] > 0


def test_phase_blocks_refuses_a_block_that_differs():
    """A module whose output on the device differs from the host's (here
    the device is the CPU, so a block that adds its own device's noise)."""
    cases = chip_smoke.block_cases(**TINY_SIZES)
    make, specs = cases['ESEAttn']

    class Noisy(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.inner = make()

        def forward(self, x):
            out = self.inner(x)
            return out + 1e-3 * out.abs().max() * (x.shape[0] > 1)

    with pytest.raises(AssertionError, match='off the host'):
        chip_smoke.phase_blocks('cpu', bsz=2, reps=1,
                                cases={'Noisy': (Noisy, specs)})


def test_phase_reference_weights_rehearsal(tmp_path):
    configs = {'prototype4': derived_config(
        tmp_path, chip_smoke.YOLO_CONFIGS['prototype4'], TINY_YOLO),
        'redet': chip_smoke.REDET_TINY_CONFIGS['redet']}
    runs, captured = chip_smoke.phase_reference_weights(
        'cpu', root=str(tmp_path / 'ref'), bsz=1, size=128, configs=configs,
        max_num=64, max_candidates=64)
    assert runs == [NO_LAUNCHES] * 2
    assert sorted(captured) == ['prototype4_converted_nms',
                                'redet_converted_nms', 'redet_converted_roi']
    assert len(captured['prototype4_converted_nms']) == 2
    (levels, rois, ratio), _ = captured['redet_converted_roi']
    assert rois.shape[0] == 1 and ratio == 2
    assert osp.exists(tmp_path / 'ref' / 'redet_converted.pth')
