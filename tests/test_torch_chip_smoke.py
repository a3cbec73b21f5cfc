"""Rehearsal of ``chip_smoke.py`` on the CPU: its phases at a tiny size,
where every wrapper takes its plain version (so the launch count must stay
0). ``main()`` is not called: it requires a CUDA device."""

import pathlib
import subprocess
import sys

import pytest
import torch

import chip_smoke

torch.set_num_threads(1)


def test_phase_kernel_rehearsal():
    rec = chip_smoke.phase_kernel('cpu', bsz=2, n=130, small_n=70, reps=1,
                                  plain_reps=1)
    assert rec['max_abs_err'] == 0
    assert rec['bound_by'] in ('bytes', 'operations')
    assert rec['bound_ms'] > 0 and rec['ms'] > 0 and rec['plain_ms'] > 0
    assert rec['library_ms'] is None and rec['route'] == 'cuda'


def test_phase_slice_rehearsal():
    chip_smoke.phase_slice('cpu', bsz=1, size=128, max_candidates=300)


def test_phase_serving_rehearsal():
    launches = chip_smoke.phase_serving('cpu', bsz=2, size=128, warm=1,
                                        timed=1, dtype=torch.float32,
                                        max_candidates=300)
    assert launches == {'nms_pair_mask': 0, 'box_iou_rotated': 0}


def test_phase_iou_kernel_rehearsal():
    rec = chip_smoke.phase_iou_kernel('cpu', bsz=2, g=8, valid=3, size=128,
                                      dense_g=16, reps=1, plain_reps=1)
    assert rec['name'] == 'box_iou_rotated' and rec['route'] == 'cuda'
    assert rec['max_abs_err'] == 0          # the wrapper took the plain one
    assert rec['bound_by'] in ('bytes', 'operations')
    assert rec['bound_ms'] > 0 and rec['ms'] > 0 and rec['plain_ms'] > 0
    assert rec['library_ms'] is None
    assert rec['replaces'].endswith('iou_pallas.py:347')


def test_phase_train_slice_rehearsal():
    chip_smoke.phase_train_slice('cpu', bsz=1, size=128, g=8, valid=3)


def test_phase_training_rehearsal():
    launches = chip_smoke.phase_training('cpu', bsz=1, size=128, g=8,
                                         valid=3, warm=1, timed=2,
                                         dtype=torch.float32)
    assert launches == {'nms_pair_mask': 0, 'box_iou_rotated': 0}


def test_kernels_table_names_both_sources():
    root = pathlib.Path(chip_smoke.__file__).parent
    assert sorted(chip_smoke.KERNELS) == ['box_iou_rotated', 'nms_pair_mask']
    for name, entry in chip_smoke.KERNELS.items():
        assert (root / entry['source']).name == f'{name}.cu'
        assert (root / entry['source']).exists()
        path, line = entry['replaces'].split(':')
        text = (root / path).read_text().splitlines()[int(line) - 1]
        assert text.startswith(f'def {name}_pallas(')


def test_main_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    proc = subprocess.run([sys.executable, chip_smoke.__file__],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ''
    assert 'no CUDA device' in proc.stderr
