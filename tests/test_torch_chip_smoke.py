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

NO_LAUNCHES = {'nms_pair_mask': 0, 'box_iou_rotated': 0,
               'roi_align_rotated': 0}


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
    assert launches == NO_LAUNCHES


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
    assert launches == NO_LAUNCHES


def test_phase_roi_kernel_rehearsal():
    rec = chip_smoke.phase_roi_kernel('cpu', bsz=2, r=40, size=256,
                                      channels=16, odd=(1, 13, 72, 8),
                                      reps=1, plain_reps=1)
    assert rec['name'] == 'roi_align_rotated' and rec['route'] == 'cuda'
    assert rec['max_abs_err'] == 0          # the wrapper took the plain one
    assert rec['bound_by'] in ('bytes', 'operations')
    assert rec['bound_ms'] > 0 and rec['ms'] > 0 and rec['plain_ms'] > 0
    assert rec['bound_ms_float32'] > rec['bound_ms']    # twice the bytes
    assert rec['library_ms'] is None
    assert rec['replaces'].endswith('roi_align_pallas.py:226')


def test_roi_align_work_counts_cells_once():
    """Two identical RoIs touch the cells of one; a padding RoI none."""
    feats = chip_smoke.seeded_pyramid(1, 256, 4, torch.float32, 'cpu', 0)
    one = torch.tensor([[[100.0, 90.0, 28.0, 14.0, 0.0]]])
    cells, live, per_level = chip_smoke.roi_align_work(feats, one)
    # 14 x 14 samples half a cell apart on the stride-4 level: 8 x 5 cells
    assert (cells, live, per_level) == (40, 1, [1, 0, 0, 0])
    twice = torch.cat([one, one, torch.zeros(1, 1, 5)], 1)
    assert chip_smoke.roi_align_work(feats, twice) == (40, 2, [2, 0, 0, 0])
    bound, by = chip_smoke.roi_align_bound_ms(feats, twice, 40, 2)
    nbytes = 3 * 5 * 4 + (40 * 4 + 3 * 49 * 4) * 4
    assert by == 'bytes' and bound == nbytes / chip_smoke.PEAK_BYTES * 1e3


def test_phase_orcnn_slice_rehearsal():
    chip_smoke.phase_orcnn_slice('cpu', bsz=1, size=128, max_num=200,
                                 max_candidates=300)


def test_phase_orcnn_serving_rehearsal():
    launches = chip_smoke.phase_orcnn_serving(
        'cpu', bsz=1, size=128, warm=1, timed=1, split=1,
        dtype=torch.float32, max_num=200, max_candidates=300)
    assert launches == NO_LAUNCHES


def dets_of(rows):
    """rows: (score, label) per detection, in output order, one image."""
    scores = torch.tensor([[r[0] for r in rows]])
    boxes = 100.0 * scores[..., None] + torch.arange(5.0)
    labels = torch.tensor([[r[1] for r in rows]])
    return (torch.cat([boxes, scores[..., None]], -1), labels,
            torch.ones_like(labels, dtype=torch.bool))


@pytest.mark.parametrize('got,ref,result', [
    # a near-tie in another order, and another candidate at the NMS cut
    ([(.9, 1), (.50002, 2), (.50001, 3), (.20004, 1)],
     [(.9, 1), (.50001, 3), (.50002, 2), (.20003, 4), (.20001, 1)],
     (0.0, 2, 3)),
    ([(.9, 1), (.5, 2)], [(.9, 1), (.5, 2)], (0.0, 0, 0)),
    ([(.9, 1), (.5, 2)], [(.9, 1), (.5, 3)], 'detections differ'),
    ([(.9, 1), (.5, 2)], [(.9, 1), (.52, 2)], 'detections differ'),
    ([(.9, 1), (.5, 2)], [(.9, 1)], 'clear of the cut'),
    ([(.9, 1), (.9005, 2)], [(.9005, 2), (.9, 1)], 'changed places'),
])
def test_same_detections(got, ref, result):
    cut = torch.tensor([0.2])
    if isinstance(result, str):
        with pytest.raises(AssertionError, match=result):
            chip_smoke.same_detections(dets_of(got), dets_of(ref), cut)
    else:
        assert chip_smoke.same_detections(dets_of(got), dets_of(ref),
                                          cut) == result


def test_kernels_table_names_both_sources():
    root = pathlib.Path(chip_smoke.__file__).parent
    assert sorted(chip_smoke.KERNELS) == ['box_iou_rotated', 'nms_pair_mask',
                                          'roi_align_rotated']
    assert sorted(chip_smoke.kernel_wrappers()) == sorted(chip_smoke.KERNELS)
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
