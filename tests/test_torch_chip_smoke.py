"""Rehearsal of ``chip_smoke.py`` on the CPU: its phases at a tiny size,
where every wrapper takes its plain version (so the launch count must stay
0). ``main()`` is not called: it requires a CUDA device."""

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
    assert launches == {'nms_pair_mask': 0}


def test_main_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    proc = subprocess.run([sys.executable, chip_smoke.__file__],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ''
    assert 'no CUDA device' in proc.stderr
