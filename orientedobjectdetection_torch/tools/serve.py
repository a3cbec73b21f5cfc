"""A minimal HTTP inference server (counterpart of
``tools/deployment/serve.py``; the reference ships a TorchServe handler,
``tools/deployment/mmrotate_handler.py``).

    python -m orientedobjectdetection_torch.tools.serve <config> [ckpt] \\
        --port 8080 --score-thr 0.3
    curl -X POST --data-binary @image.jpg localhost:8080/predict

A POST body is an image, raw or base64: a JPEG, a PNG, a BMP, a TIFF, a
PNM, PAM or PFM, a Sun raster, a Radiance HDR, a GIF or a lossless WebP
file (``utils/image_io.py:imdecode``, its orientation applied). The answer
is a JSON list of the detections scoring at least ``--score-thr``, each
``{"class_id", "bbox": [cx, cy, w, h, theta], "score"}``, from
``inference_detector``. Anything that does not decode (a truncated or
corrupt file, a form ROADMAP A.4d lists such as lossy WebP, a form OpenCV
does not read either) gets a 400 with the decoder's reason. Serves on the card (``--device cpu`` for the CPU), on
``--host`` (default ``0.0.0.0``).
"""

from __future__ import annotations

import argparse
import base64
import binascii
import json
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np


def decode_body(body: bytes) -> np.ndarray:
    """A request body -> ``(H, W, 3)`` uint8 BGR: base64 when it decodes as
    such, else the raw bytes. Raises ValueError for what
    ``utils/image_io.py:imdecode`` cannot read."""
    from ..utils.image_io import imdecode
    try:
        body = base64.b64decode(body, validate=True)
    except (binascii.Error, ValueError):
        pass
    return imdecode(body, 'the request body')


def detections_json(result, score_thr: float) -> list:
    """Per-class ``(n, 6)`` detections -> the answer's list, class by class
    in the result's order."""
    out = []
    for cls, dets in enumerate(result):
        for d in np.asarray(dets).reshape(-1, 6):
            if d[5] >= score_thr:
                out.append(dict(class_id=int(cls),
                                bbox=[float(v) for v in d[:5]],
                                score=float(d[5])))
    return out


def make_handler(bundle, score_thr: float):
    """The request handler class of a server over ``bundle`` (its
    ``served`` attribute)."""
    from ..apis.inference import inference_detector

    class Handler(BaseHTTPRequestHandler):
        served = bundle

        def _answer(self, code: int, payload) -> None:
            data = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_POST(self):
            length = int(self.headers.get('Content-Length', 0))
            body = self.rfile.read(length)
            try:
                img = decode_body(body)
            except ValueError as e:
                self._answer(400, {'error': f'bad image: {e}'})
                return
            result = inference_detector(self.served, img)
            self._answer(200, detections_json(result, score_thr))

        def log_message(self, *args):
            pass

    return Handler


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Serve a rotated detector')
    p.add_argument('config')
    p.add_argument('checkpoint', nargs='?', default=None)
    p.add_argument('--host', default='0.0.0.0')
    p.add_argument('--port', type=int, default=8080)
    p.add_argument('--score-thr', type=float, default=0.3)
    p.add_argument('--device', default='cuda',
                   help='cuda (the default) or cpu')
    p.add_argument('--bf16', action='store_true')
    return p.parse_args(argv)


def build_server(args) -> HTTPServer:
    """The server of ``args`` (port 0 takes a free one), not yet serving."""
    import torch
    from ..apis.eval import _default_norm
    from ..apis.inference import init_detector
    from .train import load_config
    cfg = load_config(args.config, [])
    device_norm = _default_norm(cfg) if \
        cfg.data.get('normalize_on_device', True) else None
    bundle = init_detector(cfg, args.checkpoint, device=args.device,
                           dtype=torch.bfloat16 if args.bf16
                           else torch.float32, device_norm=device_norm)
    return HTTPServer((args.host, args.port),
                      make_handler(bundle, args.score_thr))


def main(argv=None):
    server = build_server(parse_args(argv))
    host, port = server.server_address[:2]
    print(f'serving on {host}:{port}', flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == '__main__':
    main()
