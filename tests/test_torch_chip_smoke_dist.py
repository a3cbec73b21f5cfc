"""Rehearsal of ``chip_smoke.py``'s phases 47-49 (data-parallel training and
evaluation, the host side) on the CPU at a tiny size: RetinaNet R18 with a
32-wide FPN and head and prototype4 at deepen 0.33 / widen 0.125, 128 px,
a global batch of 4 (2 a rank), two gloo ranks and a gloo group of one in
place of NCCL; a synthetic set of 4 val images. Every wrapper takes its
plain version here, so no launch is counted."""

import os

import pytest
import torch

import chip_smoke
from test_torch_chip_smoke import (NO_LAUNCHES, TINY_PIPELINES,
                                   TINY_RETINANET, derived_config)
from test_torch_chip_smoke_yolov8 import TINY_YOLO

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def tiny_dp(tmp_path_factory):
    """The tiny configs, a val set and seeded weights (class bias zeroed),
    with DATA_DIR in a temporary directory."""
    from orientedobjectdetection_torch.models import build_detector
    from orientedobjectdetection_torch.tools.generate_synth import \
        generate_synth
    from orientedobjectdetection_torch.utils import Config
    tmp = tmp_path_factory.mktemp('dp')
    retina = derived_config(tmp, chip_smoke.CONFIG, TINY_RETINANET)
    yolo = derived_config(tmp, chip_smoke.DP_CONFIGS['prototype4'],
                          TINY_YOLO + TINY_PIPELINES)
    synth = derived_config(tmp, chip_smoke.SYNTH1024_CONFIG, TINY_RETINANET)
    root = str(tmp / 'synth')
    generate_synth(root, 4, 128, seed=2, split='val')
    det = build_detector(dict(Config.fromfile(synth).model))
    det.init_weights(0)
    trained = {k: v.clone() for k, v in det.state_dict().items()}
    weights = str(tmp / 'weights.pth')
    torch.save(chip_smoke.zero_class_bias(trained), weights)
    return dict(tmp=tmp, retina=retina, yolo=yolo, synth=synth, root=root,
                trained=trained, weights=weights)


@pytest.fixture
def patched(tiny_dp, monkeypatch):
    monkeypatch.setenv('OMP_NUM_THREADS', '1')     # the ranks' threads
    monkeypatch.setattr(chip_smoke, 'DP_CONFIGS',
                        {'retinanet': tiny_dp['retina'],
                         'prototype4': tiny_dp['yolo']})
    monkeypatch.setattr(chip_smoke, 'DATA_DIR', str(tiny_dp['tmp'] / 'data'))
    return tiny_dp


def test_phases_47_48_rehearsal(patched, capsys):
    runs = chip_smoke.phase_data_parallel(
        'cpu', bsz=4, size=128, g=8, valid=(3, 1), timed=1,
        eval_sets={'retinanet': (patched['synth'], patched['root'],
                                 patched['weights'])},
        single_backend='gloo')
    # the group of one, 2 ranks x (RetinaNet, prototype4 live and frozen,
    # bf16), 2 evals
    assert runs == [NO_LAUNCHES] * 11
    out = capsys.readouterr().out
    assert '(i) 1 rank(s) on gloo' in out and 'bit for bit: True' in out
    assert out.count('[rank 0]') == 6 and out.count('[rank 1]') == 6
    assert 'in two other orders' in out
    assert '(ii) 2 gloo ranks' in out and '(iii) 2 gloo ranks' in out
    # the fault of the gradient alone, planted in live BN, is refused
    assert out.count('(iii) planted fault') == 2
    assert 'mAP' in out and "DetectorBundle(devices=['cpu', 'cpu'])" in out
    assert not os.path.exists(os.path.join(chip_smoke.DATA_DIR,
                                           'data_parallel', 'collect'))


def test_the_comparison_catches_a_local_step(patched):
    """A rank's step on its own rows with its own normalizers is not the
    global batch's: :func:`chip_smoke.same_dp_step` refuses it."""
    batch = chip_smoke.dp_batch(4, 128, 8, (3, 1), 120, 'cpu')
    ref = chip_smoke.dp_step(patched['retina'], True, batch, 'cpu')
    local = chip_smoke.dp_step(patched['retina'], True, batch, 'cpu',
                               rows=slice(0, 2))
    assert batch['gt_mask'][:2].sum() != batch['gt_mask'][2:].sum()
    chip_smoke.same_dp_step(ref, ref, 'itself')
    with pytest.raises(AssertionError):
        chip_smoke.same_dp_step(local, ref, 'local')
    # live BN, held to the spread of the step on the batch reordered: the
    # reordered step passes, a rank's step on its own rows does not
    live = chip_smoke.dp_step(patched['yolo'], False, batch, 'cpu')
    swapped = chip_smoke.dp_step(patched['yolo'], False, {
        k: v[[2, 3, 0, 1]] for k, v in batch.items()}, 'cpu')
    backwards = chip_smoke.dp_step(patched['yolo'], False, {
        k: v[[3, 2, 1, 0]] for k, v in batch.items()}, 'cpu')
    chip_smoke.same_dp_step(swapped, live, 'swapped', True, [backwards])
    local = chip_smoke.dp_step(patched['yolo'], False, batch, 'cpu',
                               rows=slice(0, 2))
    with pytest.raises(AssertionError):
        chip_smoke.same_dp_step(local, live, 'local', True,
                                [swapped, backwards])


def test_phase_host_rehearsal(patched, capsys):
    boxes, cls = chip_smoke.dota_candidates(1, 300, 3, num_classes=3)
    captured = {'submission_merge': [(torch.from_numpy(boxes),
                                      torch.from_numpy(cls))]}
    os.makedirs(chip_smoke.DATA_DIR, exist_ok=True)
    runs = chip_smoke.phase_host(
        patched['root'], patched['trained'], captured, device='cpu',
        n_requests=2, config=patched['synth'], flops_config=patched['retina'],
        flops_shape=(128, 128))
    assert runs == [NO_LAUNCHES] * 3
    out = capsys.readouterr().out
    assert '[serve]' in out and '2 PNG requests' in out
    assert 'the native NMS keeps the' in out
    assert '[confusion]' in out and '[get-flops]' in out
    assert os.path.exists(os.path.join(chip_smoke.DATA_DIR,
                                       'serve_request.png'))
