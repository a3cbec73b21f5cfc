"""The port and chip_smoke.py stand alone: no module imports JAX, flax or
the JAX package, nor OpenCV or PIL, which the port does not depend on (an
AST scan, so lazy imports inside functions count)."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orientedobjectdetection_tpu',
             'cv2', 'PIL')
SOURCES = sorted((ROOT / 'orientedobjectdetection_torch').rglob('*.py')) + \
    [ROOT / 'chip_smoke.py']


def imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_scan_covers_the_package():
    names = {p.name for p in SOURCES}
    assert {'chip_smoke.py', 'nms.py', 'iou_kernels.py', 'inference.py',
            'assigners.py', 'common.py', 'train_state.py', 'checkpoint.py',
            'jax_weights.py', 'roi_align_rotated.py', 'roi_align_kernels.py',
            'oriented_rpn_head.py', 'bbox_heads.py', 'oriented_roi_head.py',
            'two_stage.py', 'image_io.py', 'eval_map.py', 'pipelines.py',
            'dota.py', 'loader.py', 'eval.py', 'train.py', 'test.py',
            'generate_synth.py', 'patch.py', 'hrsc.py', 'wrappers.py',
            'img_split.py', 'rotated_fcos_head.py', 'gaussian_dist_loss.py',
            'kf_iou_loss.py', 'rotated_iou_loss.py', 'rotated_anchor_head.py',
            'coders.py', 'anchors.py', 'fpn.py', 'feature_align.py',
            'utils_rotation.py', 'refine_heads.py',
            'refine_detectors.py'} <= names
    tools = {p.name for p in SOURCES if p.parent.name == 'tools'}
    assert {'train.py', 'test.py', 'generate_synth.py',
            'img_split.py'} <= tools


@pytest.mark.parametrize('path', SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_imports(path):
    bad = [m for m in imported_modules(path)
           if m.split('.')[0] in FORBIDDEN]
    assert not bad, f'{path.relative_to(ROOT)} imports {bad}'
