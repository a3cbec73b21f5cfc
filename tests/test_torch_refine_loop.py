"""The refine detectors' tiny-synth configs through the port's entry points
on the CPU: ``s2anet_tiny_synth.py`` and ``r3det_tiny_synth.py`` (ResNet-18,
64-wide, 2 classes) cut to 128 px, on a synthetic DOTA-layout set of 4
images from the port's generator.

- ``DetectorBundle`` / ``batched_eval`` on weights carried from the JAX
  package against the JAX package's bundle and ``batched_eval``: the same
  detections per class, as sets (boxes within 1e-3, scores within 1e-5);
- ``tools.train`` for 2 steps at the configs' 256 px, then ``tools.test
  --eval mAP`` on its checkpoint; without ``--device cpu`` both raise
  here, where there is no card, and so does ``init_detector``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orientedobjectdetection_tpu.apis.eval import \
    batched_eval as jax_batched_eval
from orientedobjectdetection_tpu.apis.inference import \
    DetectorBundle as JBundle
from orientedobjectdetection_tpu.datasets import \
    build_dataset as jax_build_dataset
from orientedobjectdetection_tpu.models import build_detector as jax_build
from orientedobjectdetection_tpu.utils.config import Config as JConfig
from orientedobjectdetection_torch.apis import init_detector
from orientedobjectdetection_torch.apis.eval import (_default_norm,
                                                     batched_eval)
from orientedobjectdetection_torch.datasets import build_dataset
from orientedobjectdetection_torch.tools.generate_synth import generate_synth
from orientedobjectdetection_torch.utils import Config
from orientedobjectdetection_torch.utils.jax_weights import \
    from_jax_variables
from test_torch_refine import fill_variables

torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(__file__), '..')
CONFIGS = {'s2anet': os.path.join(ROOT, 'configs', 's2anet',
                                  's2anet_tiny_synth.py'),
           'r3det': os.path.join(ROOT, 'configs', 'r3det',
                                 'r3det_tiny_synth.py')}
SIZE = 128


@pytest.fixture(scope='module')
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('synth'))
    generate_synth(root, num_images=4, size=SIZE, seed=1)
    return root + '/'


def tiny_cfg(config_cls, key, root):
    cfg = config_cls.fromfile(CONFIGS[key])
    for split in ('train', 'val', 'test'):
        ds = cfg.data[split]
        ds['ann_file'] = root + 'trainval/annfiles/'
        ds['img_prefix'] = root + 'trainval/images/'
        for t in ds['pipeline']:
            if t['type'] == 'RResize':
                t['img_scale'] = (SIZE, SIZE)
    cfg.merge_from_dict({'data.samples_per_gpu': 2, 'data.pad_size':
                         (SIZE, SIZE), 'pad_size': (SIZE, SIZE),
                         'model.test_cfg.nms_pre': 64,
                         'model.test_cfg.max_candidates': 64,
                         'model.test_cfg.max_per_img': 40,
                         'checkpoint_config.interval': 1,
                         'evaluation.interval': 1,
                         'evaluation.samples_per_gpu': 2})
    return cfg


def same_per_class(got, ref, box_atol=1e-3, score_band=1e-5):
    """Per image and class, the same number of detections, each JAX row
    matched by a port row within the tolerances (rows may swap between
    near-tied scores). Returns the number of detections."""
    count = 0
    for g_img, r_img in zip(got, ref):
        for g, r in zip(g_img, r_img):
            assert g.shape == r.shape
            for row in r:
                close = (np.abs(g[:, :5] - row[:5]).max(1) <= box_atol) & \
                    (np.abs(g[:, 5] - row[5]) <= score_band)
                assert close.any(), f'no match for {row}'
            count += len(r)
    return count


@pytest.mark.parametrize('key', list(CONFIGS))
def test_batched_eval_matches_jax(key, data_root):
    jcfg, cfg = tiny_cfg(JConfig, key, data_root), \
        tiny_cfg(Config, key, data_root)
    det = jax_build(dict(jcfg.model))
    shapes = jax.eval_shape(det.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, SIZE, SIZE, 3)))
    variables = fill_variables(shapes, np.random.default_rng(9))
    norm = _default_norm(cfg)
    jbundle = JBundle(jcfg, det, variables, device_norm=norm)
    bundle = init_detector(cfg, from_jax_variables(variables), device='cpu',
                           device_norm=norm)
    assert bundle.num_classes == jbundle.num_classes == 2
    assert not bundle.two_stage
    jdata = jax_build_dataset(dict(jcfg.data['val'], test_mode=True,
                                   filter_empty_gt=False))
    data = build_dataset(dict(cfg.data['val'], test_mode=True,
                              filter_empty_gt=False))
    ref = jax_batched_eval(jbundle, jdata, batch_size=2)
    got = batched_eval(bundle, data, batch_size=2, progress=False)
    assert same_per_class(got, ref) > 20


@pytest.mark.parametrize('key', list(CONFIGS))
def test_command_lines_train_and_test(key, data_root, tmp_path):
    from orientedobjectdetection_torch.tools import test as test_cli
    from orientedobjectdetection_torch.tools import train as train_cli
    config = tmp_path / 'tiny.py'
    config.write_text(
        f'_base_ = [{os.path.abspath(CONFIGS[key])!r}]\n'
        'data = dict(samples_per_gpu=2)\n'
        'model = dict(test_cfg=dict(nms_pre=64, max_candidates=64, '
        'max_per_img=40))\n'
        'checkpoint_config = dict(interval=1)\n'
        'evaluation = dict(interval=1, samples_per_gpu=2)\n')
    options = ['--cfg-options', f'data_root={data_root}']
    work_dir = str(tmp_path / 'work')
    state = train_cli.main([str(config), '--work-dir', work_dir, '--device',
                            'cpu', '--max-steps', '2', '--log-interval',
                            '1'] + options)
    assert state.step == 2
    metrics = test_cli.main([str(config), os.path.join(
        work_dir, 'ckpt_00000002.pth'), '--eval', 'mAP', '--device', 'cpu',
        '--batch-size', '2'] + options)
    assert 0 <= metrics['mAP'] <= 1
    if not torch.cuda.is_available():       # the card is the default
        with pytest.raises(RuntimeError, match='no CUDA device'):
            train_cli.main([str(config), '--work-dir', work_dir] + options)
        with pytest.raises(RuntimeError, match='no CUDA device'):
            test_cli.main([str(config), '--eval', 'mAP'] + options)
        with pytest.raises(RuntimeError, match='no CUDA device'):
            init_detector(str(config))
