"""Publish a training checkpoint: keep the model's state dict alone (no
optimizer state, no step) and put the first 8 hex digits of the SHA-256 of
the written bytes into the file name (counterpart of
``tools/model_converters/publish_model.py``).

    python -m orientedobjectdetection_torch.tools.publish_model \\
        work_dir/ckpt_00012000.pth rotated_retinanet.pth

writes ``rotated_retinanet-<sha256[:8]>.pth``, which ``init_detector``
loads. The input is a ``utils/checkpoint.py`` checkpoint (``model``,
``optimizer``, ``step``).
"""

from __future__ import annotations

import argparse
import hashlib
import io
import sys

import torch

from ..utils.checkpoint import SUFFIX


def publish(in_file: str, out_file: str) -> str:
    """Write ``in_file``'s model state dict to ``out_file`` with the hash
    in its name; returns the path written."""
    ckpt = torch.load(in_file, map_location='cpu', weights_only=True)
    buf = io.BytesIO()
    torch.save(ckpt['model'], buf)
    blob = buf.getvalue()
    sha = hashlib.sha256(blob).hexdigest()[:8]
    stem = out_file[:-len(SUFFIX)] if out_file.endswith(SUFFIX) \
        else out_file
    out = f'{stem.rstrip(".-_")}-{sha}{SUFFIX}'
    with open(out, 'wb') as f:
        f.write(blob)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('in_file')
    p.add_argument('out_file')
    args = p.parse_args(argv)
    print(f'published to {publish(args.in_file, args.out_file)}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
