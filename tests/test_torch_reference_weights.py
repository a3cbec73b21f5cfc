"""Port parity, the reference-checkpoint converter
(``utils/reference_weights.py`` and ``tools/convert_reference_weights.py``)
against the JAX package's (``tools/model_converters/
convert_torch_weights.py``): JAX variables filled from a seed, written
under the reference's names by the JAX ``synthesize_reference_state``,
then converted by the port must give exactly the state dict that
``mirror_from_jax`` (the YOLO stack) or ``from_jax_variables`` (ReDet)
carries from the same variables, with no leftover key; and the port's own
``synthesize_reference_state`` of that state must give the JAX one, bit
for bit. The models: prototype4 cut to deepen 0.33 / widen 0.125 with 4
classes (``test_torch_live_bn.small_model``), and the tiny ReDet
(``configs/redet/redet_tiny_synth.py``), its backbone's BatchNorm values
one a field (:func:`per_field`)."""

import os
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orientedobjectdetection_tpu.models import build_detector as j_build
from orientedobjectdetection_tpu.utils import Config as JConfig
from orientedobjectdetection_torch.apis import init_detector
from orientedobjectdetection_torch.models import build_detector
from orientedobjectdetection_torch.utils import Config
from orientedobjectdetection_torch.utils.jax_weights import (
    from_jax_variables, mirror_from_jax)
from orientedobjectdetection_torch.utils.reference_weights import (
    convert_checkpoint, filter_from_taps, synthesize_reference_state,
    taps_from_filter)
from test_torch_cspnext import fill_variables
from test_torch_live_bn import small_model

sys.path.insert(0, osp.join(osp.dirname(__file__), '..'))
from tools.model_converters import convert_torch_weights as CT  # noqa: E402

torch.set_num_threads(1)

ROOT = osp.join(osp.dirname(__file__), '..')
YOLO_CONFIG = osp.join(ROOT, 'configs', 'jy', 'prototype4.py')
REDET_CONFIG = osp.join(ROOT, 'configs', 'redet', 'redet_tiny_synth.py')


def seeded_variables(model_cfg, seed, size=64):
    det = j_build(dict(model_cfg))
    shapes = jax.eval_shape(det.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3), jnp.float32))
    return jax.tree_util.tree_map(
        np.asarray, fill_variables(shapes, np.random.default_rng(seed)))


@pytest.fixture(scope='module')
def yolo():
    variables = seeded_variables(small_model(), 3)
    return dict(variables=variables, port=mirror_from_jax(variables),
                reference=CT.synthesize_reference_state(variables,
                                                        'RotatedYOLOv8'))


def per_field(variables):
    """The ReDet backbone's BatchNorm values made equal over each field's
    8 orientations, as e2cnn's InnerBatchNorm keeps them (one value a
    field): the form a reference checkpoint can take."""
    def tie(path, v):
        names = [k.key for k in path]
        if names[1] == 'backbone' and names[-1] in ('scale', 'bias', 'mean',
                                                    'var') and v.ndim == 1:
            return np.repeat(v.reshape(-1, 8)[:, 0], 8)
        return v
    return jax.tree_util.tree_map_with_path(tie, variables)


@pytest.fixture(scope='module')
def redet():
    model = JConfig.fromfile(REDET_CONFIG).model
    variables = per_field(seeded_variables(model, 4))
    return dict(variables=variables, port=from_jax_variables(variables),
                reference=CT.synthesize_reference_state(variables, 'ReDet'))


def assert_same_state(got, ref):
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        assert got[k].dtype == torch.float32, k
        assert got[k].shape == v.shape, (k, got[k].shape, v.shape)
        assert torch.equal(got[k], torch.as_tensor(v)), k


@pytest.mark.parametrize('family', ['yolo', 'redet'])
def test_converter_gives_the_carried_state(family, request):
    """The JAX converter's synthesized reference state, converted by the
    port: the carried state's keys and values, bit for bit; no leftover
    key, and the JAX converter consumes every key too."""
    case = request.getfixturevalue(family)
    kind = 'RotatedYOLOv8' if family == 'yolo' else 'ReDet'
    got, leftovers = convert_checkpoint(case['reference'], kind)
    assert leftovers == []
    assert_same_state(got, case['port'])
    _, j_left = CT.convert_checkpoint(dict(case['reference']), kind)
    assert j_left == []


def test_converter_takes_a_backbone_only_warm_start(yolo):
    """A checkpoint of the backbone alone (a COCO warm-start) converts to
    the backbone's keys, as ``_assemble_yolov8`` does."""
    reference = {k: v for k, v in yolo['reference'].items()
                 if k.startswith('backbone.')}
    got, leftovers = convert_checkpoint(reference, 'RotatedYOLOv8')
    assert leftovers == []
    assert_same_state(got, {k: v for k, v in yolo['port'].items()
                            if k.startswith('backbone.')})
    j_vars, _ = CT.convert_checkpoint(dict(reference), 'RotatedYOLOv8')
    assert sorted(j_vars['params']) == ['backbone']


@pytest.mark.parametrize('family', ['yolo', 'redet'])
def test_synthesized_state_equals_the_jax_package_s(family, request):
    """The port's ``synthesize_reference_state`` of the carried state: the
    JAX one's keys, shapes and values (e2cnn's expanded filters and the
    per-field BatchNorm values for ReDet), bit for bit."""
    case = request.getfixturevalue(family)
    kind = 'RotatedYOLOv8' if family == 'yolo' else 'ReDet'
    got = synthesize_reference_state(case['port'], kind)
    ref = case['reference']
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        v = np.asarray(v)
        assert got[k].shape == v.shape, (k, got[k].shape, v.shape)
        assert np.array_equal(got[k], v), k


def test_redet_filters_are_the_taps_rotated_copies():
    """The expanded filter's block ``o`` is the taps with the 3x3 ring
    rotated by ``o`` steps and the input orientations rolled by ``o``; the
    taps come back from its o_out = 0 block."""
    rng = np.random.default_rng(0)
    w = rng.normal(0, 1, (2, 3, 8, 3, 3)).astype(np.float32)
    full = filter_from_taps(w)
    assert full.shape == (16, 24, 3, 3)
    np.testing.assert_array_equal(taps_from_filter(full), w)
    # copy 2 rotates by 90 degrees: the corner (0, 0) reads the corner
    # (2, 0) of the taps, the centre stays; input orientation i reads i - 2
    copy = full[2::8].reshape(2, 3, 8, 3, 3)
    np.testing.assert_array_equal(copy[..., 1, 1],
                                  np.roll(w[..., 1, 1], 2, axis=2))
    np.testing.assert_array_equal(copy[..., 0, 0],
                                  np.roll(w[..., 2, 0], 2, axis=2))


def test_converter_reports_leftovers_and_refuses_unknown_types(yolo, redet):
    """A key no table maps is a leftover (buffers without weights are not);
    a ReDet checkpoint with e2cnn coefficients but no expanded filter, an
    unknown type and a type whose names are the reference's raise."""
    extra = dict(yolo['reference'])
    extra['bbox_head.extra.weight'] = np.zeros(3, np.float32)
    extra['neck.top_down_layers.0.main_conv.bn.num_batches_tracked'] = \
        np.zeros((), np.int64)
    _, leftovers = convert_checkpoint(extra, 'RotatedYOLOv8')
    assert leftovers == ['bbox_head.extra.weight']
    coeffs = dict(redet['reference'])
    filt = coeffs.pop('backbone.layer1.0.conv2.filter')
    coeffs['backbone.layer1.0.conv2.weights'] = filt.ravel()[:10]
    with pytest.raises(ValueError, match='filter missing'):
        convert_checkpoint(coeffs, 'ReDet')
    with pytest.raises(ValueError, match='no converter'):
        convert_checkpoint(yolo['reference'], 'RotatedYOLOv6')
    with pytest.raises(ValueError, match='loads the checkpoint as it is'):
        convert_checkpoint(yolo['reference'], 'OrientedRCNN')
    with pytest.raises(ValueError, match='no converter'):
        CT.convert_checkpoint(dict(yolo['reference']), 'RotatedYOLOv6')


def run_tool(*args):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run(
        [sys.executable, '-m',
         'orientedobjectdetection_torch.tools.convert_reference_weights',
         *args], capture_output=True, text=True, cwd=ROOT, env=env,
        timeout=300)


@pytest.mark.parametrize('family', ['yolo', 'redet'])
def test_tool_writes_what_init_detector_loads(family, request, tmp_path):
    """The command on a ``.pth`` holding the reference state under
    ``state_dict``: a file that ``init_detector`` loads with strict names
    into the configured detector, every tensor the carried one's."""
    case = request.getfixturevalue(family)
    kind = 'RotatedYOLOv8' if family == 'yolo' else 'ReDet'
    src, out = tmp_path / 'reference.pth', tmp_path / 'converted.pth'
    torch.save(dict(state_dict={k: torch.as_tensor(np.asarray(v))
                                for k, v in case['reference'].items()},
                    meta=dict(epoch=12)), src)
    done = run_tool(str(src), str(out), '--type', kind)
    assert done.returncode == 0, done.stderr
    assert 'unmapped' not in done.stdout and 'converted' in done.stdout
    if family == 'yolo':
        cfg = Config.fromfile(YOLO_CONFIG)
        cfg.model = small_model()
    else:
        cfg = Config.fromfile(REDET_CONFIG)
    bundle = init_detector(cfg, str(out), device='cpu')
    assert_same_state(bundle.detector.state_dict(), case['port'])
    assert set(torch.load(out, weights_only=True)) == set(
        build_detector(dict(cfg.model)).state_dict())


def test_tool_leaves_other_types_alone(tmp_path):
    """For a type whose names are the reference's, the tool says so and
    writes nothing; with leftovers it lists them."""
    out = tmp_path / 'never.pth'
    done = run_tool(str(tmp_path / 'missing.pth'), str(out), '--type',
                    'OrientedRCNN')
    assert done.returncode == 0, done.stderr
    assert 'as it is' in done.stdout and not out.exists()
    src = tmp_path / 'partial.pth'
    torch.save({'backbone.stem.0.conv.weight': torch.zeros(4, 3, 3, 3),
                'backbone.unknown.weight': torch.zeros(2)}, src)
    done = run_tool(str(src), str(out), '--type', 'RotatedYOLOv8')
    assert done.returncode == 0, done.stderr
    assert '1 unmapped source keys' in done.stdout
    assert 'backbone.unknown.weight' in done.stdout
    assert list(torch.load(out, weights_only=True)) == [
        'backbone.stem_0.conv.weight']
