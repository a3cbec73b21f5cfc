"""Parameters and FLOPs of a detector's forward (counterpart of
``tools/analysis_tools/get_flops.py``).

    python -m orientedobjectdetection_torch.tools.get_flops <config> \\
        --shape 1024 1024

The parameter count is every ``nn.Parameter`` of the detector, the JAX
package's ``params`` collection (running statistics are buffers here and
``batch_stats`` there). The FLOPs are ``torch.utils.flop_counter``'s: two
for each multiply-add of the convolutions and matrix products of one
forward of a ``(1, 3, H, W)`` image, and nothing for the other operations
(the NMS of a two-stage detector's proposals, the activations, the
normalizations). The JAX tool prints XLA's cost analysis, which counts
every operation of the compiled program: the two numbers are different
definitions and are not expected to agree. Runs on the card
(``--device cpu`` for the CPU).
"""

from __future__ import annotations

import argparse

import torch

DEFINITION = ('torch.utils.flop_counter.FlopCounterMode: 2 x the '
              'multiply-adds of convolutions and matrix products; the JAX '
              'tool prints XLA cost_analysis flops, every operation')


def count(cfg, shape=(1024, 1024), device='cuda'):
    """``(parameters, flops)`` of ``cfg``'s detector on one ``shape``
    image, with seeded weights."""
    from torch.utils.flop_counter import FlopCounterMode
    from ..models import build_detector
    from ..ops.nms import host_device
    device = host_device(device, 'get_flops')
    detector = build_detector(dict(cfg.model))
    detector.init_weights(0)
    detector.eval().to(device)
    n_params = sum(p.numel() for p in detector.parameters())
    images = torch.zeros((1, 3, shape[0], shape[1]), device=device)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        detector(images)
    return n_params, counter.get_total_flops()


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Count parameters and FLOPs')
    p.add_argument('config')
    p.add_argument('--shape', type=int, nargs=2, default=[1024, 1024])
    p.add_argument('--device', default='cuda',
                   help='cuda (the default) or cpu')
    p.add_argument('--cfg-options', nargs='+', default=[])
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from .train import load_config
    cfg = load_config(args.config, args.cfg_options)
    n_params, flops = count(cfg, tuple(args.shape), args.device)
    print(f'Input shape: (1, 3, {args.shape[0]}, {args.shape[1]})')
    print(f'Params: {n_params / 1e6:.2f} M ({n_params})')
    print(f'FLOPs (fwd): {flops / 1e9:.2f} GFLOPs')
    print(f'FLOPs counted by {DEFINITION}')
    return n_params, flops


if __name__ == '__main__':
    main()
