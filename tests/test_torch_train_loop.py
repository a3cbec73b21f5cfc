"""The port's config-driven trainer and evaluator on the CPU, at a tiny
size: a synthetic DOTA-layout set of 4 images of 128 px from the port's
generator, ``rotated_retinanet_tiny_synth.py`` (ResNet-18, 64-wide FPN and
head) cut to 128 px and 64 NMS candidates.

- ``train_detector`` for 2 steps: its log lines, checkpoint files, and a
  resume that continues at the same step with equal parameters;
- ``eval_from_state`` on weights carried from the JAX package
  (``utils/jax_weights.py``) against the JAX package's ``eval_from_state``:
  the same detections (labels and valid exact, boxes and scores within
  1e-3, as ``tests/test_torch_slice.py`` holds the slice) and the same
  per-class AP within 1e-6;
- ``inference_detector`` on a PNG path equals it on the decoded array.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orientedobjectdetection_tpu.apis.eval import \
    batched_eval as jax_batched_eval
from orientedobjectdetection_tpu.apis.eval import \
    eval_from_state as jax_eval_from_state
from orientedobjectdetection_tpu.apis.inference import \
    DetectorBundle as JBundle
from orientedobjectdetection_tpu.datasets import \
    build_dataset as jax_build_dataset
from orientedobjectdetection_tpu.models import build_detector as jax_build
from orientedobjectdetection_tpu.utils.config import Config as JConfig
from orientedobjectdetection_torch.apis import (inference_detector,
                                                init_detector)
from orientedobjectdetection_torch.apis.eval import (_default_norm,
                                                     batched_eval,
                                                     eval_from_state)
from orientedobjectdetection_torch.apis.train import train_detector
from orientedobjectdetection_torch.datasets import build_dataset
from orientedobjectdetection_torch.tools.generate_synth import generate_synth
from orientedobjectdetection_torch.utils import Config
from orientedobjectdetection_torch.utils.jax_weights import \
    from_jax_variables

torch.set_num_threads(2)

CONFIG = os.path.join(os.path.dirname(__file__), '..', 'configs',
                      'rotated_retinanet', 'rotated_retinanet_tiny_synth.py')
SIZE = 128


@pytest.fixture(scope='module')
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('synth'))
    generate_synth(root, num_images=4, size=SIZE, seed=0)
    return root + '/'


def tiny_cfg(config_cls, root):
    cfg = config_cls.fromfile(CONFIG)
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
                         'model.test_cfg.max_per_img': 50,
                         'checkpoint_config.interval': 1,
                         'evaluation.interval': 1,
                         'evaluation.samples_per_gpu': 2})
    return cfg


def read_log(work_dir):
    with open(os.path.join(work_dir, 'train_log.jsonl')) as f:
        return [json.loads(line) for line in f]


def test_train_detector_logs_checkpoints_and_resumes(data_root, tmp_path):
    cfg = tiny_cfg(Config, data_root)
    work_dir = str(tmp_path / 'work')
    state = train_detector(cfg, work_dir, max_steps=2, log_interval=1,
                           device='cpu')
    assert state.step == 2
    log = read_log(work_dir)
    train_lines = [r for r in log if 'mode' not in r]
    assert [r['step'] for r in train_lines] == [1, 2]
    for r in train_lines:
        assert {'loss', 'loss_cls', 'loss_bbox', 'grad_norm', 'lr',
                'imgs_per_sec', 'epoch'} <= set(r)
        assert np.isfinite(r['loss'])
    val = [r for r in log if r.get('mode') == 'val']
    assert len(val) == 1 and val[0]['step'] == 2 and 0 <= val[0]['mAP'] <= 1
    assert sorted(os.listdir(work_dir)) == [
        'best_00000002.pth', 'ckpt_00000002.pth', 'train_log.jsonl']
    trained = {k: v.clone() for k, v in state.model.state_dict().items()}

    # the newest checkpoint resumes at its step with its parameters
    resumed = train_detector(cfg, work_dir, resume=True, max_steps=2,
                             device='cpu')
    assert resumed.step == 2
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(v, trained[k]), k
    # and trains on from there
    further = train_detector(cfg, work_dir, resume=True, max_steps=3,
                             log_interval=1, device='cpu')
    assert further.step == 3
    assert read_log(work_dir)[-1]['step'] == 3
    assert 'ckpt_00000003.pth' in os.listdir(work_dir)
    # resume_from an explicit file
    again = train_detector(cfg, str(tmp_path / 'other'), max_steps=2,
                           resume_from=os.path.join(work_dir,
                                                    'ckpt_00000002.pth'),
                           device='cpu')
    for k, v in again.model.state_dict().items():
        assert torch.equal(v, trained[k]), k


def test_train_detector_refuses_what_it_cannot_do(data_root, tmp_path):
    """No card: refused. In a process group (here of one rank, joined by
    name over gloo; two ranks run in ``tests/test_torch_dist_eval.py``)
    the trainer takes the data-parallel path: it steps, rank 0 writes the
    log and the checkpoints, and the evaluation gathers through the work
    directory's ``eval_collect``, which it leaves empty."""
    from orientedobjectdetection_torch.parallel import mesh
    cfg = tiny_cfg(Config, data_root)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            train_detector(cfg, str(tmp_path))
    assert mesh.init_distributed(
        'cpu', init_method=f'file://{tmp_path}/rendezvous', rank=0,
        world_size=1)
    try:
        work_dir = str(tmp_path / 'work')
        state = train_detector(cfg, work_dir, max_steps=2, log_interval=1,
                               device='cpu')
    finally:
        mesh.destroy()
    assert state.step == 2 and not mesh.is_distributed()
    log = read_log(work_dir)
    assert [r['step'] for r in log if 'mode' not in r] == [1, 2]
    assert [r['mode'] for r in log if 'mode' in r] == ['val']
    assert 'ckpt_00000002.pth' in os.listdir(work_dir)
    assert os.listdir(os.path.join(work_dir, 'eval_collect')) == []


def carried_variables(det, seed):
    """JAX init, then random frozen BN, a zero class bias (so that scores
    pass score_thr) and regression weights scaled down (boxes near their
    anchors), as tests/test_torch_slice.py does."""
    variables = jax.jit(det.init)(jax.random.PRNGKey(seed),
                                  jnp.zeros((1, SIZE, SIZE, 3)))
    variables = jax.tree_util.tree_map(np.array, variables)
    rng = np.random.default_rng(seed)
    for path, leaf in jax.tree_util.tree_leaves_with_path(variables):
        name = path[-1].key
        if name in ('scale', 'var'):
            leaf[...] = rng.uniform(0.5, 1.5, leaf.shape)
        elif name in ('bias', 'mean'):
            leaf[...] = rng.normal(0, 0.1, leaf.shape)
    head = variables['params']['bbox_head']
    head['cls_out']['bias'][...] = 0.0
    head['reg_out']['kernel'] *= 0.05
    return variables


def test_eval_from_state_matches_jax(data_root, capsys):
    jcfg, cfg = tiny_cfg(JConfig, data_root), tiny_cfg(Config, data_root)
    det = jax_build(dict(jcfg.model))
    variables = carried_variables(det, 5)
    norm = _default_norm(cfg)
    jbundle = JBundle(jcfg, det, variables, device_norm=norm)
    jdata = jax_build_dataset(dict(jcfg.data['val'], test_mode=True,
                                   filter_empty_gt=False))
    state_dict = from_jax_variables(variables)
    bundle = init_detector(cfg, state_dict, device='cpu', device_norm=norm)
    data = build_dataset(dict(cfg.data['val'], test_mode=True,
                              filter_empty_gt=False))

    ref = jax_batched_eval(jbundle, jdata, batch_size=2)
    got = batched_eval(bundle, data, batch_size=2)
    assert sum(len(c) for r in ref for c in r) > 20
    for r_img, g_img in zip(ref, got):
        for r, g in zip(r_img, g_img):
            assert r.shape == g.shape
            np.testing.assert_allclose(g, r, atol=1e-3)

    jax_eval_from_state(jbundle, variables, jdata, batch_size=2)
    jax_table = capsys.readouterr().out
    got_map = eval_from_state(bundle, state_dict, data, batch_size=2)
    port_table = capsys.readouterr().out
    assert port_table == jax_table             # per-class AP to 3 places
    assert abs(got_map['mAP'] - jdata.evaluate(ref)['mAP']) <= 1e-6
    # random weights match little at IoU 0.5: hold the two at 0.1 too
    loose = [jdata.evaluate(ref, iou_thr=0.1)['mAP'],
             data.evaluate(got, iou_thr=0.1, device='cpu')['mAP']]
    assert loose[0] > 0.01 and abs(loose[0] - loose[1]) <= 1e-6


def test_inference_detector_reads_png_paths(data_root):
    cfg = tiny_cfg(Config, data_root)
    bundle = init_detector(cfg, device='cpu', device_norm=_default_norm(cfg))
    bundle.detector.bbox_head.retina_cls.bias.data.zero_()
    path = data_root + 'trainval/images/P0001.png'
    from orientedobjectdetection_torch.utils.image_io import imread
    by_path = inference_detector(bundle, path)
    by_array = inference_detector(bundle, imread(path))
    assert sum(len(c) for c in by_path) > 0
    for a, b in zip(by_path, by_array):
        np.testing.assert_array_equal(a, b)


TINY_CLI_CONFIG = '''
model = dict(test_cfg=dict(nms_pre=64, max_candidates=64, max_per_img=50))
img_norm_cfg = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12,
                    57.375], to_rgb=True)
train_pipeline = [
    dict(type='LoadImageFromFile'),
    dict(type='LoadAnnotations', with_bbox=True),
    dict(type='RResize', img_scale=(128, 128)),
    dict(type='RRandomFlip', flip_ratio=0.5, version='le90'),
    dict(type='Normalize', **img_norm_cfg),
    dict(type='Pad', size_divisor=32),
    dict(type='Collect', keys=['img', 'gt_bboxes', 'gt_labels'])]
test_pipeline = [
    dict(type='LoadImageFromFile'),
    dict(type='RResize', img_scale=(128, 128)),
    dict(type='Normalize', **img_norm_cfg),
    dict(type='Pad', size_divisor=32),
    dict(type='Collect', keys=['img'])]
data = dict(samples_per_gpu=2, pad_size=(128, 128),
            train=dict(pipeline=train_pipeline),
            val=dict(pipeline=test_pipeline),
            test=dict(pipeline=test_pipeline))
pad_size = (128, 128)
checkpoint_config = dict(interval=1)
evaluation = dict(interval=1, samples_per_gpu=2)
'''


def test_command_lines_train_and_test(data_root, tmp_path):
    from orientedobjectdetection_torch.tools import test as test_cli
    from orientedobjectdetection_torch.tools import train as train_cli
    config = tmp_path / 'tiny.py'
    config.write_text(f'_base_ = [{os.path.abspath(CONFIG)!r}]\n' +
                      TINY_CLI_CONFIG)
    work_dir = str(tmp_path / 'work')
    state = train_cli.main([str(config), '--work-dir', work_dir, '--device',
                            'cpu', '--max-steps', '2', '--log-interval', '1',
                            '--cfg-options', f'data_root={data_root}'])
    assert state.step == 2
    assert 'ckpt_00000002.pth' in os.listdir(work_dir)
    out = str(tmp_path / 'results.pkl')
    metrics = test_cli.main([str(config), os.path.join(
        work_dir, 'ckpt_00000002.pth'), '--eval', 'mAP', '--device', 'cpu',
        '--batch-size', '2', '--out', out,
        '--cfg-options', f'data_root={data_root}'])
    assert 0 <= metrics['mAP'] <= 1 and os.path.getsize(out) > 0
    # data_root moves the paths the config built from it
    cfg = train_cli.load_config(str(config), [f'data_root={data_root}'])
    assert cfg.data['val']['img_prefix'] == data_root + 'trainval/images/'
    # the flags that were refused: two CPU replicas, a gather directory
    # (one process reads none), the drawings
    show = str(tmp_path / 'show')
    again = test_cli.main([str(config), os.path.join(
        work_dir, 'ckpt_00000002.pth'), '--eval', 'mAP', '--device', 'cpu',
        '--batch-size', '2', '--data-parallel', '--collect-dir',
        str(tmp_path / 'collect'), '--show-dir', show,
        '--cfg-options', f'data_root={data_root}'])
    assert 0 <= again['mAP'] <= 1
    assert sorted(os.listdir(show)) == sorted(
        os.listdir(data_root + 'trainval/images'))
    assert not os.path.exists(tmp_path / 'collect')
    # a profiled run leaves a trace
    train_cli.main([str(config), '--work-dir', str(tmp_path / 'prof'),
                    '--device', 'cpu', '--max-steps', '1', '--profile-dir',
                    str(tmp_path), '--cfg-options', f'data_root={data_root}',
                    'evaluation.interval=9'])
    assert os.path.getsize(tmp_path / 'trace.json') > 0
    if not torch.cuda.is_available():       # the card is the default
        with pytest.raises(RuntimeError, match='no CUDA device'):
            train_cli.main([str(config), '--work-dir', work_dir])
        with pytest.raises(RuntimeError, match='no CUDA device'):
            test_cli.main([str(config), '--eval', 'mAP'])
