"""Data-parallel evaluation and training over two ranks on the CPU (gloo),
and data-parallel inference inside one process.

Two ranks, started once for the module (``tests/test_torch_dist_train.py``'s
``start_ranks``), on a synthetic DOTA-layout set of 5 images of 128 px
with ``rotated_retinanet_tiny_synth.py`` cut as
``tests/test_torch_train_loop.py`` cuts it (seeded weights, the class bias
zeroed so that scores pass ``score_thr``):

- ``batched_eval(collect_dir=...)``: rank r detects images ``i % 2 == r``
  (3 and 2 of them), and every rank returns the one-process list: the same
  per-image, per-class arrays; the round's directory is removed; without a
  ``collect_dir`` two ranks are refused;
- ``eval_from_state`` through the same gather: the one-process mAP;
- ``tools.test --data-parallel --collect-dir ... --show-dir ... --eval mAP``
  launched in both ranks: rank 0 writes the pickle and the drawings and
  prints the one-process mAP;
- ``train_detector`` for 2 steps (a global batch of 4, one step an epoch)
  with its evaluation after each: the ranks end with equal parameters,
  and only rank 0 writes the log and the checkpoints.

``DetectorBundle(devices=['cpu', 'cpu'])`` splits a batch over two replicas
and returns the one-device detections (see its test for the CPU's
batch-size rounding).
"""

import os
import os.path as osp
import pickle
import time

import numpy as np
import pytest
import torch

from orientedobjectdetection_torch.apis import init_detector
from orientedobjectdetection_torch.apis.eval import (_default_norm,
                                                     batched_eval,
                                                     eval_from_state)
from orientedobjectdetection_torch.datasets import build_dataset
from orientedobjectdetection_torch.parallel import mesh
from orientedobjectdetection_torch.tools.generate_synth import generate_synth
from orientedobjectdetection_torch.utils import Config
from test_torch_dist_train import join_ranks, start_ranks
from test_torch_train_loop import CONFIG, SIZE, read_log, tiny_cfg

torch.set_num_threads(1)

N_IMAGES = 5


def weights(cfg):
    """Seeded weights with the class bias zeroed (scores near 0.5) and the
    regression zeroed (each box its anchor, some of which overlap the gts:
    an mAP above 0)."""
    from orientedobjectdetection_torch.models import build_detector
    det = build_detector(dict(cfg.model))
    det.init_weights(0)
    state = {k: v.clone() for k, v in det.state_dict().items()}
    for k in ('bbox_head.retina_cls.bias', 'bbox_head.retina_reg.weight',
              'bbox_head.retina_reg.bias'):
        state[k].zero_()
    return state


def setup(workdir):
    cfg = tiny_cfg(Config, osp.join(workdir, 'data') + '/')
    return cfg, torch.load(osp.join(workdir, 'weights.pt'))


def val_set(cfg):
    return build_dataset(dict(cfg.data['val'], test_mode=True,
                              filter_empty_gt=False))


def rank_main(rank, world, init, workdir):
    """A rank: the gather, the in-training evaluation, the test tool and
    the trainer, in that order."""
    from orientedobjectdetection_torch.tools import test as test_tool
    torch.set_num_threads(1)
    mesh.init_distributed('cpu', init_method=init, rank=rank,
                          world_size=world)
    cfg, state = setup(workdir)
    ds = val_set(cfg)
    bundle = init_detector(cfg, state, device='cpu',
                           device_norm=_default_norm(cfg))
    out = {}
    try:
        batched_eval(bundle, ds, batch_size=2, progress=False)
    except ValueError as e:
        out['refused'] = str(e)
    collect = osp.join(workdir, 'collect')
    out['results'] = batched_eval(bundle, ds, batch_size=2, progress=False,
                                  collect_dir=collect)
    mesh.barrier()                       # rank 0 has removed the round
    out['rounds_after'] = sorted(os.listdir(collect))
    out['map'] = eval_from_state(bundle, state, ds, batch_size=2,
                                 collect_dir=collect)['mAP']
    torch.save(state, osp.join(workdir, 'ckpt.pth'))
    out['tool'] = test_tool.main([
        CONFIG, osp.join(workdir, 'ckpt.pth'), '--device', 'cpu',
        '--data-parallel', '--collect-dir', collect, '--batch-size', '2',
        '--eval', 'mAP', '--out', osp.join(workdir, 'tool.pkl'),
        '--show-dir', osp.join(workdir, 'show'),
        '--cfg-options', f'data_root={workdir}/data/',
        f'data.train.ann_file={workdir}/data/trainval/annfiles/',
        f'data.train.img_prefix={workdir}/data/trainval/images/',
        f'data.val.ann_file={workdir}/data/trainval/annfiles/',
        f'data.val.img_prefix={workdir}/data/trainval/images/',
        f'pad_size=({SIZE},{SIZE})', 'model.test_cfg.nms_pre=64',
        'model.test_cfg.max_per_img=50'])
    trained = train_state_after(cfg, osp.join(workdir, 'work'))
    out['trained'] = {k: v.clone() for k, v in trained.items()}
    torch.save(out, osp.join(workdir, f'rank{rank}.pt'))
    mesh.destroy()


def train_state_after(cfg, work_dir):
    from orientedobjectdetection_torch.apis.train import train_detector
    state = train_detector(cfg, work_dir, max_steps=2, log_interval=1,
                           device='cpu')
    return state.model.state_dict()


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp('dist_eval'))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)             # as the ranks: the same sums
    generate_synth(osp.join(workdir, 'data'), num_images=N_IMAGES,
                   size=SIZE, seed=3)
    cfg = tiny_cfg(Config, osp.join(workdir, 'data') + '/')
    torch.save(weights(cfg), osp.join(workdir, 'weights.pt'))
    t0 = time.perf_counter()
    procs = start_ranks('test_torch_dist_eval', 'rank_main', workdir)
    try:
        cfg, state = setup(workdir)
        ds = val_set(cfg)
        bundle = init_detector(cfg, state, device='cpu',
                               device_norm=_default_norm(cfg))
        single = batched_eval(bundle, ds, batch_size=2, progress=False)
        single_map = ds.evaluate(single, device='cpu')['mAP']
        split = init_detector(cfg, state, devices=['cpu', 'cpu'],
                              device_norm=_default_norm(cfg))
        single_split = batched_eval(split, ds, batch_size=2, progress=False)
        split_map = ds.evaluate(single_split, device='cpu')['mAP']
    finally:
        torch.set_num_threads(threads)
        join_ranks(procs, t0)
    ranks = [torch.load(osp.join(workdir, f'rank{r}.pt'), weights_only=False)
             for r in range(2)]
    return dict(workdir=workdir, single=single, single_map=single_map,
                single_split=single_split, split_map=split_map, ranks=ranks,
                n_val=len(ds))


def same_results(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert len(g) == len(r)
        for a, b in zip(g, r):
            np.testing.assert_array_equal(a, b)


def test_two_rank_gather_equals_one_process(runs):
    assert runs['n_val'] == N_IMAGES
    assert sum(len(c) for r in runs['single'] for c in r) > 0
    for rank in runs['ranks']:
        same_results(rank['results'], runs['single'])
        assert rank['rounds_after'] == []


def test_two_ranks_without_collect_dir_are_refused(runs):
    for rank in runs['ranks']:
        assert 'collect_dir' in rank['refused']


def test_eval_from_state_over_two_ranks_is_the_one_process_map(runs):
    assert runs['single_map'] > 0
    for rank in runs['ranks']:
        assert rank['map'] == runs['single_map']


def test_the_test_tool_over_two_ranks(runs):
    """Rank 0 prints and writes; rank 1 returns nothing. With
    ``--data-parallel`` each rank's batches of 2 run as two replicas of 1
    image: the one-process results of such a bundle."""
    workdir = runs['workdir']
    assert runs['ranks'][1]['tool'] is None
    assert runs['ranks'][0]['tool']['mAP'] == runs['split_map'] > 0
    with open(osp.join(workdir, 'tool.pkl'), 'rb') as f:
        same_results(pickle.load(f), runs['single_split'])
    drawn = sorted(os.listdir(osp.join(workdir, 'show')))
    assert len(drawn) == N_IMAGES and all(d.endswith('.png') for d in drawn)


def test_two_rank_training_writes_once_and_agrees(runs):
    workdir = osp.join(runs['workdir'], 'work')
    a, b = (r['trained'] for r in runs['ranks'])
    for k in a:
        assert torch.equal(a[k], b[k]), k
    log = read_log(workdir)              # one writer: no line twice
    assert [r['step'] for r in log if 'mode' not in r] == [1, 2]
    assert [r['step'] for r in log if r.get('mode') == 'val'] == [1, 2]
    assert 'ckpt_00000002.pth' in os.listdir(workdir)
    assert os.listdir(osp.join(workdir, 'eval_collect')) == []


def test_bundle_split_over_two_devices_equals_one(runs):
    """``devices=['cpu', 'cpu']``: two replicas, a batch of 4 split 2 + 2,
    the one-device detections of each half concatenated in order, bit for
    bit, and those of the whole batch within 1e-4 (a CPU convolution's
    sums depend on the batch size) with the same labels and valid masks; a
    state dict reaches both replicas."""
    cfg, state = setup(runs['workdir'])
    one = init_detector(cfg, state, device='cpu')
    two = init_detector(cfg, state, devices=['cpu', 'cpu'])
    assert len(two.replicas) == 2 and two.replicas[1] is not two.detector
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.normal(0, 1, (4, SIZE, SIZE, 3))
                              .astype(np.float32))
    got = two(images)
    halves = [one(images[:2]), one(images[2:])]
    for k in range(3):
        assert torch.equal(got[k], torch.cat([h[k] for h in halves]))
    whole = one(images)
    assert int(whole[2].sum()) > 0
    assert torch.equal(got[1], whole[1]) and torch.equal(got[2], whole[2])
    torch.testing.assert_close(got[0], whole[0], rtol=0, atol=1e-4)
    zeroed = {k: torch.zeros_like(v) if k == 'bbox_head.retina_reg.weight'
              else v for k, v in state.items()}
    two.load_state_dict(zeroed)
    for r in two.replicas:
        assert not r.state_dict()['bbox_head.retina_reg.weight'].any()
    from orientedobjectdetection_torch.apis import DetectorBundle
    with pytest.raises(ValueError, match='devices'):
        DetectorBundle(cfg, one.detector, devices=['meta'])
