"""Convert a reference (mmyolo / mmrotate) checkpoint into a state dict
that ``init_detector(config, out.pth)`` loads (counterpart of
``tools/model_converters/convert_torch_weights.py``).

    python -m orientedobjectdetection_torch.tools.convert_reference_weights \\
        in.pth out.pth --type RotatedYOLOv8

``in.pth`` holds the state dict under ``state_dict`` or at its top level.
Only ``RotatedYOLOv8`` and ``ReDet`` need converting
(``utils/reference_weights.py``); the leftover source keys, those that no
table maps, are printed. For every other detector type the port's names
are the reference's: the tool says so, writes nothing, and
``init_detector`` loads ``in.pth`` as it is.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..utils.reference_weights import (CONVERTERS, SAME_NAMES,
                                       convert_checkpoint)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('checkpoint')
    p.add_argument('out')
    p.add_argument('--type', required=True,
                   choices=sorted(set(CONVERTERS) | set(SAME_NAMES)),
                   help='the detector type of the checkpoint')
    args = p.parse_args(argv)
    if args.type in SAME_NAMES:
        print(f'{args.type}: the port\'s names are the reference\'s; '
              f'init_detector loads {args.checkpoint} as it is (nothing '
              f'written)')
        return 0
    ckpt = torch.load(args.checkpoint, map_location='cpu',
                      weights_only=False)
    state = ckpt.get('state_dict', ckpt)
    converted, leftovers = convert_checkpoint(state, args.type)
    if leftovers:
        print(f'WARNING: {len(leftovers)} unmapped source keys:')
        for k in leftovers:
            print('  ', k)
    torch.save(converted, args.out)
    n = sum(v.numel() for v in converted.values())
    print(f'converted {len(converted)} tensors ({n} values) -> {args.out}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
