"""The port's small repo tools: ``tools.print_config`` prints what the JAX
package's ``tools/misc/print_config.py`` prints for the same config, and
``tools.publish_model`` keeps a checkpoint's model state alone and names
the file after the SHA-256 of the bytes it writes."""

import hashlib
import os
import os.path as osp
import re
import subprocess
import sys

import pytest
import torch

from orientedobjectdetection_torch.apis import init_detector
from orientedobjectdetection_torch.models import build_detector
from orientedobjectdetection_torch.parallel import (build_optimizer,
                                                    create_train_state)
from orientedobjectdetection_torch.tools import print_config, publish_model
from orientedobjectdetection_torch.utils import Config
from orientedobjectdetection_torch.utils.checkpoint import save_checkpoint

ROOT = osp.join(osp.dirname(__file__), '..')
TINY = osp.join(ROOT, 'configs', 'rotated_retinanet',
                'rotated_retinanet_tiny_synth.py')


def run(args, **env):
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, cwd=ROOT, timeout=300,
                          env=dict(os.environ, PYTHONPATH=ROOT, **env))


@pytest.mark.parametrize('config', [
    osp.join('configs', 'jy', 'prototype4.py'),
    osp.join('configs', 'redet', 'redet_re50_refpn_1x_dota_le90.py')])
def test_print_config_prints_what_the_jax_tool_prints(config):
    """The same text, byte for byte, for a config with three bases and for
    one whose base has a base and ``_delete_`` keys."""
    got = run(['-m', 'orientedobjectdetection_torch.tools.print_config',
               config])
    ref = run([osp.join('tools', 'misc', 'print_config.py'), config],
              JAX_PLATFORMS='cpu')
    assert got.returncode == 0 and ref.returncode == 0, (got.stderr,
                                                         ref.stderr)
    assert got.stdout == ref.stdout
    assert "'type': 'RotatedYOLOv8'" in got.stdout or \
        "'type': 'ReDet'" in got.stdout


def test_print_config_main(capsys):
    assert print_config.main([TINY]) == 0
    assert capsys.readouterr().out == Config.fromfile(TINY).dump() + '\n'


def test_publish_model_keeps_the_model_state_and_names_its_hash(tmp_path):
    """A trainer checkpoint (model, optimizer, step) -> the model's state
    dict alone, in ``<name>-<sha256[:8]>.pth`` whose bytes hash to that
    prefix; ``init_detector`` loads it; the command prints the path."""
    cfg = Config.fromfile(TINY)
    detector = build_detector(dict(cfg.model))
    detector.init_weights(7)
    state = create_train_state(detector, build_optimizer(
        dict(type='sgd', momentum=0.9), 0.01), device='cpu')
    ckpt = save_checkpoint(str(tmp_path / 'work'), state, 12)
    out = publish_model.publish(ckpt, str(tmp_path / 'retinanet_tiny.pth'))
    m = re.fullmatch(r'retinanet_tiny-([0-9a-f]{8})\.pth', osp.basename(out))
    assert m, out
    with open(out, 'rb') as f:
        assert hashlib.sha256(f.read()).hexdigest()[:8] == m.group(1)
    published = torch.load(out, weights_only=True)
    ref = detector.state_dict()
    assert sorted(published) == sorted(ref)
    for k, v in ref.items():
        assert torch.equal(published[k], v), k
    bundle = init_detector(cfg, out, device='cpu')
    for k, v in ref.items():
        assert torch.equal(bundle.detector.state_dict()[k], v), k
    done = run(['-m', 'orientedobjectdetection_torch.tools.publish_model',
                ckpt, str(tmp_path / 'again.pth')])
    assert done.returncode == 0, done.stderr
    assert done.stdout.strip() == \
        f'published to {tmp_path}/again-{m.group(1)}.pth'
