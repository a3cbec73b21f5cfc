"""The port's host-side tools on the CPU (``device='cpu'``), on a synthetic
DOTA-layout set of 3 images of 128 px and ``rotated_retinanet_tiny_synth.py``
cut as ``tests/test_torch_train_loop.py`` cuts it, with seeded weights
whose class bias is zeroed (so that scores pass the thresholds):

- ``tools.serve``: the handler answers PNG and JPEG requests, raw and
  base64, with ``inference_detector``'s detections above ``--score-thr``,
  over a real localhost socket; a truncated JPEG and bytes of no image get
  a 400 with the decoder's reason; GIF and lossless WebP bodies are served
  as OpenCV decodes them, and a lossy WebP body gets a 400 naming the
  form;
- ``tools.confusion_matrix`` equals the JAX tool's
  ``calculate_confusion_matrix`` on the same detections;
- ``tools.get_flops``: the parameter count equals the JAX package's
  (``params``), and the FLOPs are ``FlopCounterMode``'s;
- ``tools.browse_dataset``, ``tools.heatmap``, ``tools.image_demo``,
  ``tools.huge_image_demo``, ``tools.image_demo_timed`` and ``tools.test
  --show-dir`` write what they should.
"""

import base64
import http.client
import importlib.util
import json
import os
import os.path as osp
import pickle
import threading

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orientedobjectdetection_torch.apis import (inference_detector,
                                                init_detector)
from orientedobjectdetection_torch.datasets import build_dataset
from orientedobjectdetection_torch.tools.generate_synth import generate_synth
from orientedobjectdetection_torch.utils import Config
from orientedobjectdetection_torch.utils.image_io import imread, imwrite
from test_torch_train_loop import CONFIG, SIZE

torch.set_num_threads(2)

ROOT = osp.join(osp.dirname(osp.abspath(__file__)), '..')


@pytest.fixture(scope='module')
def env(tmp_path_factory):
    """The set, a derived config file pointing at it and a checkpoint."""
    work = tmp_path_factory.mktemp('tools')
    data = str(work / 'data')
    generate_synth(data, num_images=3, size=SIZE, seed=5)
    config = str(work / 'tiny.py')
    with open(config, 'w') as f:
        f.write(f'''_base_ = {osp.abspath(CONFIG)!r}
data_root = {data + '/'!r}
pad_size = ({SIZE}, {SIZE})
_ann = data_root + 'trainval/annfiles/'
_img = data_root + 'trainval/images/'
data = dict(samples_per_gpu=2, pad_size=({SIZE}, {SIZE}),
            train=dict(ann_file=_ann, img_prefix=_img),
            val=dict(ann_file=_ann, img_prefix=_img),
            test=dict(ann_file=_ann, img_prefix=_img))
model = dict(test_cfg=dict(nms_pre=64, max_per_img=50))
''')
    cfg = Config.fromfile(config)
    from orientedobjectdetection_torch.models import build_detector
    det = build_detector(dict(cfg.model))
    det.init_weights(0)
    state = det.state_dict()
    state['bbox_head.retina_cls.bias'].zero_()
    ckpt = str(work / 'ckpt.pth')
    torch.save(state, ckpt)
    img = imread(osp.join(data, 'trainval', 'images',
                          sorted(os.listdir(osp.join(data, 'trainval',
                                                     'images')))[0]))
    return dict(work=work, data=data, config=config, cfg=cfg, ckpt=ckpt,
                img=img)


def test_serve_answers_png_requests(env):
    from orientedobjectdetection_torch.tools import serve
    args = serve.parse_args([env['config'], env['ckpt'], '--device', 'cpu',
                             '--host', '127.0.0.1', '--port', '0',
                             '--score-thr', '0.3'])
    server = serve.build_server(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        bundle = server.RequestHandlerClass.served
        ref = serve.detections_json(inference_detector(bundle, env['img']),
                                    0.3)
        assert ref and all(d['score'] >= 0.3 for d in ref)
        png = cv2.imencode('.png', env['img'])[1].tobytes()
        host, port = server.server_address[:2]
        for body in (png, base64.b64encode(png)):
            conn = http.client.HTTPConnection(host, port, timeout=60)
            conn.request('POST', '/predict', body=body)
            reply = conn.getresponse()
            assert reply.status == 200
            assert json.loads(reply.read()) == ref
            conn.close()
        jpeg = cv2.imencode('.jpg', env['img'])[1].tobytes()
        decoded = cv2.imdecode(np.frombuffer(jpeg, np.uint8), cv2.IMREAD_COLOR)
        ref = serve.detections_json(inference_detector(bundle, decoded), 0.3)
        assert ref
        for body in (jpeg, base64.b64encode(jpeg)):
            conn = http.client.HTTPConnection(host, port, timeout=60)
            conn.request('POST', '/predict', body=body)
            reply = conn.getresponse()
            assert reply.status == 200
            assert json.loads(reply.read()) == ref
            conn.close()
        for body, reason in ((jpeg[:len(jpeg) // 2], 'truncated'),
                             (b'not an image', 'PNG, JPEG, BMP, TIFF, PNM')):
            conn = http.client.HTTPConnection(host, port, timeout=60)
            conn.request('POST', '/predict', body=body)
            reply = conn.getresponse()
            assert reply.status == 400
            assert reason in json.loads(reply.read())['error']
            conn.close()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def test_serve_answers_gif_and_webp_requests(env):
    """A GIF and a lossless WebP body are served as OpenCV decodes them; a
    lossy WebP body gets a 400 that names the form and ROADMAP A.4d."""
    from orientedobjectdetection_torch.tools import serve
    args = serve.parse_args([env['config'], env['ckpt'], '--device', 'cpu',
                             '--host', '127.0.0.1', '--port', '0',
                             '--score-thr', '0.3'])
    server = serve.build_server(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        bundle = server.RequestHandlerClass.served
        host, port = server.server_address[:2]
        lossy = cv2.imencode('.webp', env['img'],
                             [cv2.IMWRITE_WEBP_QUALITY, 80])[1].tobytes()
        for ext in ('.gif', '.webp', 'lossy'):
            body = lossy if ext == 'lossy' else \
                cv2.imencode(ext, env['img'])[1].tobytes()
            conn = http.client.HTTPConnection(host, port, timeout=60)
            conn.request('POST', '/predict', body=body)
            reply = conn.getresponse()
            answer = json.loads(reply.read())
            conn.close()
            if ext == 'lossy':
                assert reply.status == 400
                assert 'lossy WebP' in answer['error']
                assert 'ROADMAP A.4d' in answer['error']
                continue
            decoded = cv2.imdecode(np.frombuffer(body, np.uint8),
                                   cv2.IMREAD_COLOR)
            assert reply.status == 200
            assert answer == serve.detections_json(
                inference_detector(bundle, decoded), 0.3)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def jax_tool(path, name):
    spec = importlib.util.spec_from_file_location(name, osp.join(ROOT, path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_confusion_matrix_equals_the_jax_tool(env, tmp_path):
    """Detections made from the gts (some kept, moved or relabelled) and
    random ones: the port's matrix, and the tool's saved file, equal the
    JAX tool's."""
    from orientedobjectdetection_tpu.datasets import \
        build_dataset as j_build_dataset
    from orientedobjectdetection_torch.tools import confusion_matrix
    cfg = env['cfg']
    ds = build_dataset(dict(cfg.data['val'], test_mode=True,
                            filter_empty_gt=False))
    rng = np.random.default_rng(0)
    n = len(ds.CLASSES)
    results = []
    for i in range(2):              # JAX's IoU runs eagerly: two images
        ann = ds.get_ann_info(i)
        per = [[] for _ in range(n)]
        for box, label in zip(ann['bboxes'], ann['labels']):
            r = rng.uniform()
            if r < 0.2:
                continue                                   # missed
            moved = box.copy()
            if r > 0.8:
                moved[:2] += 40                             # off target
            cls = int(label) if rng.uniform() < 0.8 else \
                int(rng.integers(n))
            per[cls].append(np.append(moved, rng.uniform(0.2, 1.0)))
        for _ in range(3):                                  # background
            per[int(rng.integers(n))].append(np.array(
                [*rng.uniform(10, SIZE - 10, 2), *rng.uniform(5, 30, 2),
                 rng.uniform(-1, 1), rng.uniform(0.2, 1.0)]))
        results.append([np.asarray(p, np.float32).reshape(-1, 6)
                        for p in per])
    got = confusion_matrix.calculate_confusion_matrix(ds, results, 0.3, 0.5,
                                                      device='cpu')
    j_ds = j_build_dataset(dict(cfg.data['val'], test_mode=True,
                                filter_empty_gt=False))
    ref = jax_tool('tools/analysis_tools/confusion_matrix.py',
                   'j_confusion').calculate_confusion_matrix(j_ds, results,
                                                             0.3, 0.5)
    np.testing.assert_array_equal(got, ref)
    assert np.trace(got[:n, :n]) > 0 and got[n].sum() > 0
    pkl = str(tmp_path / 'results.pkl')
    with open(pkl, 'wb') as f:
        pickle.dump(results, f)
    confusion_matrix.main([env['config'], pkl, str(tmp_path / 'cm'),
                           '--device', 'cpu'])
    np.testing.assert_array_equal(
        np.load(tmp_path / 'cm' / 'confusion_matrix.npy'), ref)


@pytest.mark.parametrize('config', [
    'configs/rotated_retinanet/rotated_retinanet_obb_r50_fpn_1x_dota_le90.py',
    'configs/jy/prototype4.py'])
def test_get_flops_parameters_equal_jax(config, capsys):
    from orientedobjectdetection_tpu.models import build_detector as j_build
    from orientedobjectdetection_tpu.utils.config import Config as JConfig
    from orientedobjectdetection_torch.tools import get_flops
    path = osp.join(ROOT, config)
    det = j_build(dict(JConfig.fromfile(path).model))
    shapes = jax.eval_shape(det.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))
    ref = sum(int(np.prod(x.shape))
              for x in jax.tree_util.tree_leaves(shapes['params']))
    params, flops = get_flops.main([path, '--shape', '64', '64',
                                    '--device', 'cpu'])
    assert params == ref
    assert flops > 0
    out = capsys.readouterr().out
    assert f'({ref})' in out and 'FlopCounterMode' in out and \
        'cost_analysis' in out


def test_browse_dataset_draws_the_gts(env, tmp_path):
    from orientedobjectdetection_torch.tools import browse_dataset
    out = str(tmp_path / 'browse')
    assert browse_dataset.main([env['config'], '--output-dir', out,
                                '--num', '2']) == 2
    assert sorted(os.listdir(out)) == ['sample_0.png', 'sample_1.png']
    ds = build_dataset(env['cfg'].data['train'])
    sample = ds[0]
    drawn = imread(osp.join(out, 'sample_0.png'))
    assert drawn.shape == sample['img'].shape
    from orientedobjectdetection_torch.datasets import strip_host_normalize
    norm = strip_host_normalize(env['cfg'].data['train'])[1]
    plain = np.asarray(sample['img'], np.float32)
    plain = np.clip(plain * np.asarray(norm['std'])
                    + np.asarray(norm['mean']), 0, 255)
    if norm.get('to_rgb'):
        plain = plain[..., ::-1]
    assert (drawn != plain.astype(np.uint8)).any(-1).sum() > 100


def test_heatmap_is_the_jet_blend_of_the_backbone_level(env, tmp_path):
    from orientedobjectdetection_torch.tools import heatmap
    from orientedobjectdetection_torch.utils.image_io import resize_bilinear
    path = osp.join(env['data'], 'trainval', 'images',
                    sorted(os.listdir(osp.join(env['data'], 'trainval',
                                               'images')))[0])
    out = heatmap.main([env['config'], path, env['ckpt'], '--out-dir',
                        str(tmp_path), '--level', '1', '--device', 'cpu'])
    got = imread(out)
    assert got.shape == (SIZE, SIZE, 3)
    bundle = init_detector(env['config'], env['ckpt'], device='cpu')
    img = heatmap.IMAGENET_NORM
    x = (imread(path)[..., ::-1].astype(np.float32)
         - np.asarray(img['mean'], np.float32)) / \
        np.asarray(img['std'], np.float32)
    with torch.no_grad():
        feats = bundle.detector.backbone(
            torch.from_numpy(np.ascontiguousarray(x)[None]).permute(
                0, 3, 1, 2))
    fmap = feats[1][0].numpy().mean(0)
    heat = (fmap - fmap.min()) / max(fmap.max() - fmap.min(), 1e-6)
    heat8 = resize_bilinear((heat * 255).astype(np.uint8), (SIZE, SIZE))
    ref = cv2.addWeighted(imread(path), 0.5,
                          cv2.applyColorMap(heat8, cv2.COLORMAP_JET), 0.5, 0)
    np.testing.assert_array_equal(got, ref)


def test_demos_write_their_detections(env, tmp_path, capsys):
    from orientedobjectdetection_torch.tools import (huge_image_demo,
                                                     image_demo,
                                                     image_demo_timed)
    path = str(tmp_path / 'img.png')
    imwrite(path, env['img'])
    bundle = init_detector(env['config'], env['ckpt'], device='cpu')
    ref = inference_detector(bundle, path)
    out = str(tmp_path / 'demo.png')
    got = image_demo.main([path, env['config'], env['ckpt'], '--out-file',
                           out, '--device', 'cpu', '--score-thr', '0.3'])
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert (imread(out) != env['img']).any()
    big = np.concatenate([env['img'], env['img'][:, ::-1]], 1)
    imwrite(path, np.ascontiguousarray(big))
    out = str(tmp_path / 'huge.png')
    got = huge_image_demo.main([path, env['config'], env['ckpt'],
                                '--patch-sizes', str(SIZE), '--patch-steps',
                                '96', '--out-file', out, '--device', 'cpu'])
    assert imread(out).shape == big.shape and sum(len(r) for r in got) > 0
    out = str(tmp_path / 'timed.png')
    got = image_demo_timed.main(['random', env['config'], env['ckpt'],
                                 '--iters', '1', '--out-file', out,
                                 '--device', 'cpu'])
    printed = capsys.readouterr().out
    assert 'steady-state inference' in printed and 'wrote' in printed
    assert imread(out).shape == (1024, 1024, 3)


def test_the_test_tool_draws_into_show_dir(env, tmp_path):
    """One process: ``--show-dir`` draws every image's detections above
    ``--show-score-thr``, as ``imshow_det_rbboxes`` does."""
    from orientedobjectdetection_torch.core.visualization import \
        imshow_det_rbboxes
    from orientedobjectdetection_torch.tools import test as test_tool
    show = str(tmp_path / 'show')
    pkl = str(tmp_path / 'out.pkl')
    test_tool.main([env['config'], env['ckpt'], '--device', 'cpu',
                    '--batch-size', '2', '--out', pkl, '--show-dir', show,
                    '--show-score-thr', '0.4'])
    with open(pkl, 'rb') as f:
        results = pickle.load(f)
    ds = build_dataset(dict(env['cfg'].data['val'], test_mode=True,
                            filter_empty_gt=False))
    names = sorted(os.listdir(show))
    assert names == sorted(i['filename'] for i in ds.data_infos)
    info = ds.data_infos[0]
    ref = imshow_det_rbboxes(osp.join(ds.img_prefix, info['filename']),
                             results[0], class_names=ds.CLASSES,
                             score_thr=0.4)
    np.testing.assert_array_equal(imread(osp.join(show, info['filename'])),
                                  ref)
