"""Carry the JAX package's flax variables into the port's ``state_dict``
(:func:`from_jax_variables`) and the port's tensors back into the flax
layout (:func:`to_jax_layout`), so gradients and updated parameters of the
two packages can be compared name by name.

Input: the ``{'params': ..., 'batch_stats': ...}`` tree of a Rotated
RetinaNet built by ``orientedobjectdetection_tpu`` (ResNet + FPN +
RotatedRetinaHead), as nested dicts of numpy arrays. Output: a state dict
with mmrotate names, the same mapping as
``tools/model_converters/convert_torch_weights.py:synthesize_reference_state``:

- convolution kernels HWIO -> OIHW;
- FrozenBatchNorm ``scale/bias`` (params) and ``mean/var`` (batch_stats) ->
  ``weight/bias/running_mean/running_var``;
- ``layer{i}_{j}`` -> ``layer{i}.{j}``, ``downsample_conv/_bn`` ->
  ``downsample.0/.1``;
- FPN ``lateral_i/fpn_i`` -> ``lateral_convs.i.conv/fpn_convs.i.conv`` and
  ``extra_k`` -> ``fpn_convs.{n_lateral + k}.conv``;
- head ``cls_conv_i/reg_conv_i`` -> ``cls_convs.i.conv/reg_convs.i.conv``,
  ``cls_out/reg_out`` -> ``retina_cls/retina_reg``.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

_BN_FIELDS = {'scale': 'weight', 'bias': 'bias', 'mean': 'running_mean',
              'var': 'running_var'}
_RETINA_OUT = {'cls_out': 'retina_cls', 'reg_out': 'retina_reg'}


def _walk(tree, path=()) -> Iterator[Tuple[tuple, np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def _tensor(path, v) -> torch.Tensor:
    if path[-1] == 'kernel':        # HWIO -> OIHW
        v = np.transpose(v, (3, 2, 0, 1))
    return torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))


def _field(leaf: str) -> str:
    return 'weight' if leaf == 'kernel' else _BN_FIELDS[leaf]


def _backbone_name(path) -> str:
    *mods, leaf = path
    m = re.fullmatch(r'layer(\d+)_(\d+)', mods[0])
    if m:
        sub = {'downsample_conv': 'downsample.0',
               'downsample_bn': 'downsample.1'}.get(mods[1], mods[1])
        mods = [f'layer{m.group(1)}.{m.group(2)}.{sub}']
    return f'backbone.{".".join(mods)}.{_field(leaf)}'


def _neck_name(path, n_lateral: int) -> str:
    mod, leaf = path
    kind, idx = mod.rsplit('_', 1)
    if kind == 'lateral':
        base = f'lateral_convs.{idx}'
    elif kind == 'fpn':
        base = f'fpn_convs.{idx}'
    elif kind == 'extra':
        base = f'fpn_convs.{n_lateral + int(idx)}'
    else:
        raise ValueError(f'unknown FPN module {mod!r}')
    return f'neck.{base}.conv.{_field(leaf)}'


def _head_name(path) -> str:
    mod, leaf = path
    m = re.fullmatch(r'(cls|reg)_conv_(\d+)', mod)
    base = f'{m.group(1)}_convs.{m.group(2)}.conv' if m else _RETINA_OUT[mod]
    return f'bbox_head.{base}.{_field(leaf)}'


def from_jax_variables(variables) -> Dict[str, torch.Tensor]:
    """flax variables of a Rotated RetinaNet -> the port's state dict."""
    params = variables['params']
    n_lateral = sum(1 for k in params.get('neck', {})
                    if k.startswith('lateral_'))
    out: Dict[str, torch.Tensor] = {}
    for path, v in _walk(params):
        top, rest = path[0], path[1:]
        if top == 'backbone':
            name = _backbone_name(rest)
        elif top == 'neck':
            name = _neck_name(rest, n_lateral)
        elif top == 'bbox_head':
            name = _head_name(rest)
        else:
            raise ValueError(f'unhandled flax path {path}')
        out[name] = _tensor(path, v)
    for path, v in _walk(variables.get('batch_stats', {}).get('backbone',
                                                              {})):
        out[_backbone_name(path)] = _tensor(path, v)
    return out


_BN_FIELDS_BACK = {v: k for k, v in _BN_FIELDS.items()}
_RETINA_OUT_BACK = {v: k for k, v in _RETINA_OUT.items()}


def _jax_path(name: str, ndim: int, n_lateral: int) -> tuple:
    """Port name -> (collection, module path..., leaf) in the flax tree."""
    top, *mods, field = name.split('.')
    if field == 'weight':
        leaf = 'kernel' if ndim == 4 else 'scale'
    else:
        leaf = _BN_FIELDS_BACK[field]
    collection = 'batch_stats' if leaf in ('mean', 'var') else 'params'
    if top == 'backbone':
        if re.fullmatch(r'layer\d+', mods[0]):
            sub = mods[2:]
            if sub[0] == 'downsample':
                sub = [{'0': 'downsample_conv', '1': 'downsample_bn'}[sub[1]]]
            mods = [f'{mods[0]}_{mods[1]}', *sub]
    elif top == 'neck':
        kind, idx = mods[0], int(mods[1])        # <kind>.<idx>.conv
        if kind == 'lateral_convs':
            mods = [f'lateral_{idx}']
        elif idx < n_lateral:
            mods = [f'fpn_{idx}']
        else:
            mods = [f'extra_{idx - n_lateral}']
    elif top == 'bbox_head':
        if mods[0] in _RETINA_OUT_BACK:
            mods = [_RETINA_OUT_BACK[mods[0]]]
        else:                                    # cls_convs.<i>.conv
            mods = [f'{mods[0][:3]}_conv_{mods[1]}']
    else:
        raise ValueError(f'unhandled parameter name {name!r}')
    return (collection, top, *mods, leaf)


def to_jax_layout(state_dict) -> Dict[str, dict]:
    """The reverse of :func:`from_jax_variables`: a port ``state_dict`` (or
    any ``{port name: tensor}``, such as gradients by parameter name) -> a
    nested ``{'params': ..., 'batch_stats': ...}`` dict of numpy arrays with
    the flax names and layouts (convolution kernels OIHW -> HWIO)."""
    n_lateral = len({k.split('.')[2] for k in state_dict
                     if k.startswith('neck.lateral_convs.')})
    out: Dict[str, dict] = {}
    for name, v in state_dict.items():
        v = torch.as_tensor(v).detach().cpu().numpy()
        if v.ndim == 4:                  # OIHW -> HWIO
            v = np.transpose(v, (2, 3, 1, 0))
        node = out
        *path, leaf = _jax_path(name, v.ndim, n_lateral)
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = np.ascontiguousarray(v)
    return out
