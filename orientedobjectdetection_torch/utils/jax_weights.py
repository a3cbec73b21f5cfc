"""Carry the JAX package's flax variables into the port's ``state_dict``
(:func:`from_jax_variables`) and the port's tensors back into the flax
layout (:func:`to_jax_layout`), so gradients and updated parameters of the
two packages can be compared name by name.

Input: the ``{'params': ..., 'batch_stats': ...}`` tree of a single-stage
detector (ResNet + FPN + a RetinaNet-family head or an FCOS head), an
Oriented R-CNN (ResNet + FPN + OrientedRPNHead + OrientedStandardRoIHead),
an S2ANet or an R3Det built by
``orientedobjectdetection_tpu``, as nested dicts of numpy arrays. Output: a
state dict with mmrotate names, the same mapping as
``tools/model_converters/convert_torch_weights.py:synthesize_reference_state``
(and its ``_assemble_s2anet`` / ``_assemble_r3det``):

- convolution kernels HWIO -> OIHW;
- FrozenBatchNorm ``scale/bias`` (params) and ``mean/var`` (batch_stats) ->
  ``weight/bias/running_mean/running_var``;
- ``layer{i}_{j}`` -> ``layer{i}.{j}``, ``downsample_conv/_bn`` ->
  ``downsample.0/.1``;
- FPN ``lateral_i/fpn_i`` -> ``lateral_convs.i.conv/fpn_convs.i.conv`` and
  ``extra_k`` -> ``fpn_convs.{n_lateral + k}.conv``;
- head ``cls_conv_i/reg_conv_i`` -> ``cls_convs.i.conv/reg_convs.i.conv``,
  ``cls_out/reg_out`` -> ``retina_cls/retina_reg``, CSL's ``angle_out`` ->
  ``retina_angle_cls``; FCOS's GroupNorms ``cls_gn_i/reg_gn_i`` (``scale``,
  ``bias``) -> ``cls_convs.i.gn/reg_convs.i.gn`` (``weight``, ``bias``),
  its ``Scale`` parameters ``scale_{lvl}`` / ``scale_angle_{lvl}`` ->
  ``scales.{lvl}.scale`` / ``scale_angles.{lvl}.scale`` (mmrotate shares
  one ``scale_angle`` over the levels; the JAX package has one a level),
  and ``conv_cls``, ``conv_reg``, ``conv_angle`` and ``conv_centerness``
  keep their names;
- ``rpn_head.{rpn_conv,rpn_cls,rpn_reg}`` keep their names;
- ``roi_head.bbox_head.shared_fc_i`` -> ``shared_fcs.i``, ``fc_cls`` and
  ``fc_reg`` keep theirs; a dense kernel ``(in, out)`` becomes a linear
  weight ``(out, in)`` by a transpose alone (the pooled features are
  flattened ``(7, 7, C)`` in both packages);
- S2ANet: ``fam_head`` and ``odm_head`` take the head mapping (``or_conv``,
  ``odm_cls`` and ``odm_reg`` keep their names; ``or_conv``'s kernel
  ``(9, in, nOr, out)`` <-> mmcv's ``(out, in, nOr, 3, 3)``, the
  converter's ``convert_orconv``); ``align_conv/align_proj_{i}``, a dense
  kernel ``(9 C, C)`` tap-major, <-> ``align_conv.ac.{i}.deform_conv
  .weight`` ``(C, C, 3, 3)`` (``convert_deform_to_dense``);
- R3Det: ``feat_refine_{i}`` <-> ``feat_refine_module.{i}`` (``conv_5_1``,
  ``conv_1_5``, ``conv_1_1``) and ``refine_head_{i}`` <->
  ``refine_head.{i}`` with the head mapping.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

_BN_FIELDS = {'scale': 'weight', 'bias': 'bias', 'mean': 'running_mean',
              'var': 'running_var'}
_RETINA_OUT = {'cls_out': 'retina_cls', 'reg_out': 'retina_reg',
               'angle_out': 'retina_angle_cls'}


def _walk(tree, path=()) -> Iterator[Tuple[tuple, np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def _tensor(path, v) -> torch.Tensor:
    # convolution HWIO -> OIHW, dense (in, out) -> (out, in); ORConv's
    # (9, in, nOr, out) -> (out, in, nOr, 3, 3); an align projection
    # (9 C, out) tap-major -> a (out, C, 3, 3) convolution weight
    if path[-1] == 'kernel' and path[-2] == 'or_conv':
        v = np.transpose(v.reshape((3, 3) + v.shape[1:]), (4, 2, 3, 0, 1))
    elif path[-1] == 'kernel' and path[-2].startswith('align_proj_'):
        v = np.transpose(v.reshape(3, 3, -1, v.shape[-1]), (3, 2, 0, 1))
    elif path[-1] == 'kernel':
        v = np.transpose(v, (3, 2, 0, 1)) if v.ndim == 4 else v.T
    # ascontiguousarray makes a 0-d array (a Scale) 1-d: keep the shape
    return torch.from_numpy(np.ascontiguousarray(
        v, dtype=np.float32).reshape(v.shape))


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


def _head_name(path, prefix: str = 'bbox_head') -> str:
    mod, leaf = path
    m = re.fullmatch(r'(cls|reg)_(conv|gn)_(\d+)', mod)
    s = re.fullmatch(r'scale(_angle)?_(\d+)', mod)
    if m:
        base = f'{m.group(1)}_convs.{m.group(3)}.{m.group(2)}'
    elif s:
        return f'{prefix}.scale{"_angle" if s.group(1) else ""}s.' \
               f'{s.group(2)}.scale'
    else:
        base = _RETINA_OUT.get(mod, mod)
    return f'{prefix}.{base}.{_field(leaf)}'


def _roi_head_name(path) -> str:
    sub, mod, leaf = path
    if sub != 'bbox_head':
        raise ValueError(f'unhandled flax path roi_head/{"/".join(path)}')
    m = re.fullmatch(r'shared_fc_(\d+)', mod)
    base = f'shared_fcs.{m.group(1)}' if m else mod
    return f'roi_head.bbox_head.{base}.{_field(leaf)}'


def from_jax_variables(variables) -> Dict[str, torch.Tensor]:
    """flax variables of a single-stage detector, an Oriented R-CNN, an
    S2ANet or an R3Det -> the port's state dict."""
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
        elif top in ('bbox_head', 'fam_head', 'odm_head'):
            name = _head_name(rest, top)
        elif top.startswith('refine_head_'):
            name = _head_name(rest, f'refine_head.{top.split("_")[-1]}')
        elif top.startswith('feat_refine_'):
            name = f'feat_refine_module.{top.split("_")[-1]}.{rest[0]}.' \
                f'{_field(rest[1])}'
        elif top == 'align_conv':
            name = f'align_conv.ac.{rest[0].split("_")[-1]}.deform_conv.' \
                f'{_field(rest[1])}'
        elif top == 'rpn_head':
            name = f'rpn_head.{rest[0]}.{_field(rest[1])}'
        elif top == 'roi_head':
            name = _roi_head_name(rest)
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
    if top == 'bbox_head' and mods[0] in ('scales', 'scale_angles'):
        lvl = mods[1]
        mod = f'scale_{lvl}' if mods[0] == 'scales' else \
            f'scale_angle_{lvl}'
        return ('params', top, mod, 'scale')
    if field == 'weight':
        leaf = 'kernel' if ndim >= 4 or top == 'roi_head' else 'scale'
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
    elif top in ('bbox_head', 'fam_head', 'odm_head', 'refine_head'):
        if top == 'refine_head':                 # refine_head.<i>.<...>
            top, mods = f'refine_head_{mods[0]}', mods[1:]
        if mods[0] in _RETINA_OUT_BACK:
            mods = [_RETINA_OUT_BACK[mods[0]]]
        elif mods[0] in ('cls_convs', 'reg_convs'):  # <tower>.<i>.conv|gn
            mods = [f'{mods[0][:3]}_{mods[2]}_{mods[1]}']
    elif top == 'feat_refine_module':            # <i>.conv_5_1
        top, mods = f'feat_refine_{mods[0]}', mods[1:]
    elif top == 'align_conv':                    # ac.<i>.deform_conv
        mods = [f'align_proj_{mods[1]}']
    elif top == 'rpn_head':
        pass                                     # rpn_conv / rpn_cls / rpn_reg
    elif top == 'roi_head':
        if mods[1] == 'shared_fcs':              # bbox_head.shared_fcs.<i>
            mods = [mods[0], f'shared_fc_{mods[2]}']
    else:
        raise ValueError(f'unhandled parameter name {name!r}')
    return (collection, top, *mods, leaf)


def to_jax_layout(state_dict) -> Dict[str, dict]:
    """The reverse of :func:`from_jax_variables`: a port ``state_dict`` (or
    any ``{port name: tensor}``, such as gradients by parameter name) -> a
    nested ``{'params': ..., 'batch_stats': ...}`` dict of numpy arrays with
    the flax names and layouts (convolution kernels OIHW -> HWIO, linear
    weights ``(out, in)`` -> ``(in, out)``, ORConv's 5-D weight and the
    align convolutions as :func:`_tensor` says, the other way)."""
    n_lateral = len({k.split('.')[2] for k in state_dict
                     if k.startswith('neck.lateral_convs.')})
    out: Dict[str, dict] = {}
    for name, v in state_dict.items():
        v = torch.as_tensor(v).detach().cpu().numpy()
        *path, leaf = _jax_path(name, v.ndim, n_lateral)
        if v.ndim == 5:                  # (out, in, nOr, 3, 3) ORConv
            v = np.transpose(v, (3, 4, 1, 2, 0)).reshape(
                (9,) + v.shape[1:3] + v.shape[:1])
        elif v.ndim == 4 and path[-1].startswith('align_proj_'):
            v = np.transpose(v, (2, 3, 1, 0)).reshape(-1, v.shape[0])
        elif v.ndim == 4:                # OIHW -> HWIO
            v = np.transpose(v, (2, 3, 1, 0))
        elif v.ndim == 2 and leaf == 'kernel':
            v = v.T
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = np.ascontiguousarray(v).reshape(v.shape)
    return out
