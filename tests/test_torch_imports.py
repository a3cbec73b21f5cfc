"""The port and chip_smoke.py stand alone: no module imports JAX, flax or
the JAX package (an AST scan, so lazy imports inside functions count)."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orientedobjectdetection_tpu')
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
            'jax_weights.py'} <= names


@pytest.mark.parametrize('path', SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_imports(path):
    bad = [m for m in imported_modules(path)
           if m.split('.')[0] in FORBIDDEN]
    assert not bad, f'{path.relative_to(ROOT)} imports {bad}'
