"""Carry the JAX package's flax variables into the port's ``state_dict``
(:func:`from_jax_variables`) and the port's tensors back into the flax
layout (:func:`to_jax_layout`), so gradients and updated parameters of the
two packages can be compared name by name.

Input: the ``{'params': ..., 'batch_stats': ...}`` tree of a single-stage
detector (ResNet + FPN + a RetinaNet-family, FCOS or point-set head), a
two-stage detector (ResNet + FPN + OrientedRPNHead or RotatedRPNHead + the
RoI head of Oriented R-CNN, Rotated Faster R-CNN, Gliding Vertex or RoI
Transformer), an S2ANet or an R3Det built by
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
  ``fc_reg`` (and Gliding Vertex's ``fc_fix`` and ``fc_ratio``) keep
  theirs; a dense kernel ``(in, out)`` becomes a linear weight
  ``(out, in)`` by a transpose alone (the pooled features are flattened
  ``(7, 7, C)`` in both packages); RoI Transformer's stage heads
  ``roi_head/bbox_head_{i}`` <-> ``roi_head.bbox_head.{i}``;
- S2ANet: ``fam_head`` and ``odm_head`` take the head mapping (``or_conv``,
  ``odm_cls`` and ``odm_reg`` keep their names; ``or_conv``'s kernel
  ``(9, in, nOr, out)`` <-> mmcv's ``(out, in, nOr, 3, 3)``, the
  converter's ``convert_orconv``); ``align_conv/align_proj_{i}``, a dense
  kernel ``(9 C, C)`` tap-major, <-> ``align_conv.ac.{i}.deform_conv
  .weight`` ``(C, C, 3, 3)`` (``convert_deform_to_dense``);
- the point-set heads (RepPoints, Oriented RepPoints, SASM, G-RepPoints):
  the towers and their GroupNorms as FCOS's, ``pts_init_conv``,
  ``pts_init_out``, ``cls_out`` and ``pts_refine_out`` <->
  ``reppoints_pts_init_conv``, ``reppoints_pts_init_out``,
  ``reppoints_cls_out`` and ``reppoints_pts_refine_out``, and the
  deformable projections ``cls_dcn`` / ``refine_dcn``, dense kernels ``(9
  C, C)`` tap-major with a bias, <-> ``reppoints_cls_conv`` /
  ``reppoints_pts_refine_conv`` ``(C, C, 3, 3)`` and their biases (the
  align projections' reshape);
- R3Det: ``feat_refine_{i}`` <-> ``feat_refine_module.{i}`` (``conv_5_1``,
  ``conv_1_5``, ``conv_1_1``) and ``refine_head_{i}`` <->
  ``refine_head.{i}`` with the head mapping;
- the other backbones, with the names of the converter's
  ``torch_swin_to_flax``, ``torch_convnext_to_flax`` and ``_synth_re_*``,
  one rule table read both ways (``_MODULES``): Swin (mmdet) ``patch_embed`` /
  ``patch_norm`` <-> ``patch_embed.projection`` / ``.norm``,
  ``stage{i}_block{j}`` <-> ``stages.{i}.blocks.{j}`` (``attn/qkv``,
  ``attn/proj``, ``attn/rel_pos_bias`` <-> ``attn.w_msa.qkv``, ``.proj``,
  ``.relative_position_bias_table``; ``fc1`` / ``fc2`` <-> ``ffn.layers.0.0``
  / ``ffn.layers.1``), the merge at the start of stage i ``merge_norm_{i}``
  / ``merge_reduce_{i}`` <-> ``stages.{i-1}.downsample.norm`` /
  ``.reduction`` with its 4C axis turned from tap-major to mmdet's
  channel-major (the converter's ``_swin_merge_perm``), ``out_norm_{i}``
  <-> ``norm{i}``; a JAX bias table of a window that shrank with its map
  (``(2 ws - 1)^2`` rows) goes to the central block of the port's ``(2
  window_size - 1)^2`` rows, zeros around it, and back to the template's
  shape; ConvNeXt (mmcls) ``stem_conv`` / ``stem_norm`` <->
  ``downsample_layers.0.0`` / ``.0.1``, ``down_norm_{i}`` / ``down_conv_{i}``
  <-> ``downsample_layers.{i}.0`` / ``.{i}.1``, ``stage{i}_block{j}``
  (``dwconv``, ``norm``, ``pwconv1``, ``pwconv2``, ``gamma``) <->
  ``stages.{i}.{j}`` (``depthwise_conv``, ``norm``, ``pointwise_conv1``,
  ``pointwise_conv2``, ``gamma``), ``out_norm_{i}`` <-> ``norm{i}``; LayerNorm
  ``scale`` <-> ``weight``; ReResNet (mmrotate) ``stem_lift`` / ``stem_bn``
  <-> ``conv1`` / ``bn1``, ``layer{i}_{j}`` (``conv1``, ``conv2/orconv``,
  ``conv3``, ``ds_conv``, ``bn*``, ``ds_bn``) <-> ``layer{i}.{j}``
  (``conv1``, ``conv2``, ``conv3``, ``downsample.0``, ``bn*``,
  ``downsample.1``) and ReFPN ``lateral_{i}``, ``fpn_{i}/orconv`` (its bias
  on ``fpn_{i}``) <-> ``lateral_convs.{i}.conv``, ``fpn_convs.{i}.conv``: the
  tied tensors, a group convolution's taps ``(k*k, in, in_or, out)`` <->
  ``(out, in, in_or, k, k)`` and steerable coefficients ``(17, in, in_or,
  out)`` <-> ``coeff`` ``(out, in, in_or, 17)``;
- the YOLO detectors (a CSPNeXt or YOLOv8 CSPDarknet backbone, a YOLOv8
  PAFPN or YOLOv6 Rep-PAFPN, the jy heads) and the blocks of
  ``models/yolo_blocks.py``, whose port modules keep the flax names: the
  path joined by dots, each leaf renamed (``kernel`` -> ``weight``, a
  norm's ``scale`` -> ``weight``, ``mean`` / ``var`` -> ``running_mean`` /
  ``running_var`` of every BN of the detector; a ``Scale``'s ``scale``, the
  free ``scale`` of the MaxSigmoid and image-pooling blocks, the blocks'
  ``id_scale``, ``id_bias``, ``alpha``, ``beta`` and ``layer_scale_*``,
  and the adaptive rotated convolution's raw ``kernel`` kept), convolution
  kernels HWIO -> OIHW and dense kernels transposed (:func:`mirror_from_jax`,
  :func:`mirror_to_jax`).
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
# the point-set heads' layers, told apart by ``pts_init_conv``
_REPPOINTS = {'pts_init_conv': 'reppoints_pts_init_conv',
              'pts_init_out': 'reppoints_pts_init_out',
              'cls_dcn': 'reppoints_cls_conv', 'cls_out': 'reppoints_cls_out',
              'refine_dcn': 'reppoints_pts_refine_conv',
              'pts_refine_out': 'reppoints_pts_refine_out'}
# dense kernels (9 C, out), tap-major, that are (out, C, 3, 3) convolution
# weights in the port: S2ANet's align projections, the point-set heads'
# deformable projections
_TAP_DENSE = ('align_proj_', 'cls_dcn', 'refine_dcn')


def _walk(tree, path=()) -> Iterator[Tuple[tuple, np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def _tensor(path, v) -> torch.Tensor:
    # convolution HWIO -> OIHW, dense (in, out) -> (out, in); ORConv's
    # (9, in, nOr, out) -> (out, in, nOr, 3, 3); an align or deformable
    # projection (9 C, out) tap-major -> a (out, C, 3, 3) convolution weight
    if path[-1] == 'kernel' and path[-2] == 'or_conv':
        v = np.transpose(v.reshape((3, 3) + v.shape[1:]), (4, 2, 3, 0, 1))
    elif path[-1] == 'kernel' and path[-2].startswith(_TAP_DENSE):
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


def _head_name(path, prefix: str = 'bbox_head', outs=None) -> str:
    mod, leaf = path
    m = re.fullmatch(r'(cls|reg)_(conv|gn)_(\d+)', mod)
    s = re.fullmatch(r'scale(_angle)?_(\d+)', mod)
    if m:
        base = f'{m.group(1)}_convs.{m.group(3)}.{m.group(2)}'
    elif s:
        return f'{prefix}.scale{"_angle" if s.group(1) else ""}s.' \
               f'{s.group(2)}.scale'
    else:
        base = (outs or _RETINA_OUT).get(mod, mod)
    return f'{prefix}.{base}.{_field(leaf)}'


def _roi_head_name(path) -> str:
    sub, mod, leaf = path
    stage = re.fullmatch(r'bbox_head(?:_(\d+))?', sub)
    if not stage:
        raise ValueError(f'unhandled flax path roi_head/{"/".join(path)}')
    m = re.fullmatch(r'shared_fc_(\d+)', mod)
    base = f'shared_fcs.{m.group(1)}' if m else mod
    head = 'bbox_head' if stage.group(1) is None else \
        f'bbox_head.{stage.group(1)}'
    return f'roi_head.{head}.{base}.{_field(leaf)}'


# ---- Swin, ConvNeXt, ReResNet and ReFPN -------------------------------------
# (flax module path, port module path, kind[, leaves]) for each backbone
# other than ResNet and for ReFPN; ``{i}`` stands for a number and ``{i-1}``
# for one less; ``leaves`` limits a rule to those flax leaves
_MODULES = {
    'swin': [
        ('patch_embed', 'patch_embed.projection', 'conv'),
        ('patch_norm', 'patch_embed.norm', 'norm'),
        ('merge_norm_{i}', 'stages.{i-1}.downsample.norm', 'merge_norm'),
        ('merge_reduce_{i}', 'stages.{i-1}.downsample.reduction',
         'merge_dense'),
        ('stage{i}_block{j}/norm{k}', 'stages.{i}.blocks.{j}.norm{k}',
         'norm'),
        ('stage{i}_block{j}/attn/qkv', 'stages.{i}.blocks.{j}.attn.w_msa.qkv',
         'dense'),
        ('stage{i}_block{j}/attn/proj',
         'stages.{i}.blocks.{j}.attn.w_msa.proj', 'dense'),
        ('stage{i}_block{j}/attn', 'stages.{i}.blocks.{j}.attn.w_msa',
         'table'),
        ('stage{i}_block{j}/fc1', 'stages.{i}.blocks.{j}.ffn.layers.0.0',
         'dense'),
        ('stage{i}_block{j}/fc2', 'stages.{i}.blocks.{j}.ffn.layers.1',
         'dense'),
        ('out_norm_{i}', 'norm{i}', 'norm'),
    ],
    'convnext': [
        ('stem_conv', 'downsample_layers.0.0', 'conv'),
        ('stem_norm', 'downsample_layers.0.1', 'norm'),
        ('down_norm_{i}', 'downsample_layers.{i}.0', 'norm'),
        ('down_conv_{i}', 'downsample_layers.{i}.1', 'conv'),
        ('stage{i}_block{j}/dwconv', 'stages.{i}.{j}.depthwise_conv', 'conv'),
        ('stage{i}_block{j}/norm', 'stages.{i}.{j}.norm', 'norm'),
        ('stage{i}_block{j}/pwconv{k}', 'stages.{i}.{j}.pointwise_conv{k}',
         'dense'),
        ('stage{i}_block{j}', 'stages.{i}.{j}', 'gamma'),
        ('out_norm_{i}', 'norm{i}', 'norm'),
    ],
    're': [
        ('stem_lift', 'conv1', 'group'),
        ('stem_bn', 'bn1', 'bn'),
        ('layer{i}_{j}/conv2/orconv', 'layer{i}.{j}.conv2', 'group'),
        ('layer{i}_{j}/conv{k}', 'layer{i}.{j}.conv{k}', 'group'),
        ('layer{i}_{j}/bn{k}', 'layer{i}.{j}.bn{k}', 'bn'),
        ('layer{i}_{j}/ds_conv', 'layer{i}.{j}.downsample.0', 'group'),
        ('layer{i}_{j}/ds_bn', 'layer{i}.{j}.downsample.1', 'bn'),
    ],
    'refpn': [
        ('lateral_{i}', 'lateral_convs.{i}.conv', 'group'),
        ('fpn_{i}/orconv', 'fpn_convs.{i}.conv', 'group',
         ('kernel', 'coeff')),
        ('fpn_{i}', 'fpn_convs.{i}.conv', 'group', ('bias',)),
    ],
}
# flax leaf -> port field, by kind of module
_LEAVES = {
    'conv': {'kernel': 'weight', 'bias': 'bias'},
    'dense': {'kernel': 'weight', 'bias': 'bias'},
    'merge_dense': {'kernel': 'weight'},
    'norm': {'scale': 'weight', 'bias': 'bias'},
    'merge_norm': {'scale': 'weight', 'bias': 'bias'},
    'table': {'rel_pos_bias': 'relative_position_bias_table'},
    'gamma': {'gamma': 'gamma'},
    'group': {'kernel': 'weight', 'coeff': 'coeff', 'bias': 'bias'},
    'bn': _BN_FIELDS,
}


_NUMBER = re.compile(r'\{(\w)(-1)?\}')


def _pattern(template: str) -> str:
    """A module template -> a regex with a group a number (``{i-1}`` as
    ``i_less``)."""
    out = re.escape(template).replace(r'\{', '{').replace(r'\}', '}') \
        .replace(r'\-', '-')
    return _NUMBER.sub(lambda m: f'(?P<{m.group(1)}'
                       f'{"_less" if m.group(2) else ""}>\\d+)', out)


def _fill(template: str, numbers: dict) -> str:
    def number(m):
        key = m.group(1)
        if m.group(2):                     # {i-1}
            return str(int(numbers[key]) - 1)
        if key in numbers:
            return numbers[key]
        return str(int(numbers[key + '_less']) + 1)
    return _NUMBER.sub(number, template)


def _rule(kind: str, module: str, leaf: str, to_port: bool):
    """The rule of ``_MODULES[kind]`` for a flax module path (``/``) and
    leaf (``to_port``), or for a port module path (``.``) and field.
    Returns (the other side's module path, the flax leaf, the rule's kind
    of module)."""
    for flax, port, mod_kind, *only in _MODULES[kind]:
        leaves = _LEAVES[mod_kind]
        if not to_port:
            leaves = {v: k for k, v in leaves.items()}
        if leaf not in leaves:
            continue
        flax_leaf = leaf if to_port else leaves[leaf]
        if only and flax_leaf not in only[0]:
            continue
        src, dst = (flax, port) if to_port else (port, flax)
        m = re.fullmatch(_pattern(src), module)
        if m:
            return _fill(dst, m.groupdict()), flax_leaf, mod_kind
    raise ValueError(f'unhandled {kind} module {module!r} ({leaf})')


def backbone_kind(names) -> str:
    """'swin', 'convnext', 're' or 'resnet' from the backbone's flax module
    names."""
    names = set(names)
    for kind, mark in (('swin', 'patch_embed'), ('convnext', 'stem_conv'),
                       ('re', 'stem_lift')):
        if mark in names:
            return kind
    return 'resnet'


def _merge_perm(c4: int) -> np.ndarray:
    """mmdet's channel-major index ``c * 4 + tap`` -> the JAX package's
    tap-major ``tap * C + c`` (``perm[port] = jax``)."""
    c = c4 // 4
    return (np.arange(4)[None, :] * c + np.arange(c)[:, None]).reshape(-1)


def _to_port(v: np.ndarray, mod_kind: str, leaf: str,
             window_size: int) -> np.ndarray:
    """A flax tensor -> the port's layout."""
    if mod_kind == 'group' and leaf == 'coeff':   # (17, in, in_or, out)
        return np.transpose(v, (3, 1, 2, 0))
    if mod_kind == 'group' and leaf == 'kernel':  # (k*k, in, in_or, out)
        k = int(round(np.sqrt(v.shape[0])))
        return np.transpose(v.reshape((k, k) + v.shape[1:]), (4, 2, 3, 0, 1))
    if mod_kind == 'conv' and leaf == 'kernel':   # HWIO -> OIHW
        return np.transpose(v, (3, 2, 0, 1))
    if mod_kind in ('merge_norm', 'merge_dense'):
        v = v[_merge_perm(v.shape[0])]
    if leaf == 'kernel':                          # dense (in, out)
        return v.T
    if mod_kind == 'table':     # a (2 ws - 1)^2-row table: central block
        n, side = 2 * window_size - 1, int(round(np.sqrt(v.shape[0])))
        out = np.zeros((n, n, v.shape[1]), v.dtype)
        lo = (n - side) // 2
        out[lo:lo + side, lo:lo + side] = v.reshape(side, side, -1)
        return out.reshape(n * n, -1)
    return v


def _to_flax(v: np.ndarray, mod_kind: str, leaf: str, rows=None):
    """The inverse of :func:`_to_port`; ``rows``: a bias table's rows in
    the template."""
    if mod_kind == 'group' and leaf == 'coeff':
        return np.transpose(v, (3, 1, 2, 0))
    if mod_kind == 'group' and leaf == 'kernel':
        return np.transpose(v, (3, 4, 1, 2, 0)).reshape(
            (v.shape[-1] ** 2,) + v.shape[1:3] + v.shape[:1])
    if mod_kind == 'conv' and leaf == 'kernel':
        return np.transpose(v, (2, 3, 1, 0))
    if leaf == 'kernel':
        v = v.T
    if mod_kind in ('merge_norm', 'merge_dense'):
        back = np.empty_like(v)
        back[_merge_perm(v.shape[0])] = v
        return back
    if mod_kind == 'table' and rows is not None:
        n, side = int(round(np.sqrt(v.shape[0]))), int(round(np.sqrt(rows)))
        lo = (n - side) // 2
        return v.reshape(n, n, -1)[lo:lo + side, lo:lo + side].reshape(
            rows, -1)
    return v


# ---- the YOLO detectors: the port keeps the flax names --------------------
def _is_yolo(backbone_names) -> bool:
    return 'stage1_csp' in set(backbone_names)


def _raw_kernel(mods) -> bool:
    """The adaptive rotated convolution's experts ``(n, 9, in, out)`` (an
    ``arc_d{d}`` module's, or a lone one's at the root): a parameter named
    ``kernel`` in both packages, its layout unchanged."""
    return not mods or re.fullmatch(r'arc_d\d+', mods[-1]) is not None


# a ``scale`` beside one of these children is a free parameter of its
# module (``MaxSigmoidAttnBlock``'s per-head scale beside ``guide_fc``,
# ``ImagePoolingAttentionModule``'s beside ``query``), not a norm's weight
_FREE_SCALE_SIBLINGS = ('guide_fc', 'query')


def _free_scale(params, mods) -> bool:
    node = params
    for key in mods:
        node = node[key]
    return any(k in node for k in _FREE_SCALE_SIBLINGS)


def mirror_from_jax(variables) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for collection in ('params', 'batch_stats'):
        for path, v in _walk(variables.get(collection, {})):
            *mods, leaf = path
            if leaf == 'kernel' and not _raw_kernel(mods):
                field = 'weight'
                v = np.transpose(v, (3, 2, 0, 1)) if v.ndim == 4 else v.T
            elif leaf == 'scale' and not (
                    mods and mods[-1].startswith('scale_')) and not \
                    _free_scale(variables[collection], mods):
                field = 'weight'
            else:
                field = {'mean': 'running_mean',
                         'var': 'running_var'}.get(leaf, leaf)
            out['.'.join(mods + [field])] = torch.from_numpy(
                np.array(v, dtype=np.float32).reshape(v.shape))
    return out


def mirror_to_jax(state_dict) -> Dict[str, dict]:
    out: Dict[str, dict] = {}
    for name, v in state_dict.items():
        v = torch.as_tensor(v).detach().cpu().numpy()
        *mods, field = name.split('.')
        collection = 'params'
        if field in ('running_mean', 'running_var'):
            collection, leaf = 'batch_stats', field[len('running_'):]
        elif field == 'weight' and v.ndim == 1:
            leaf = 'scale'                       # a BatchNorm
        elif field == 'weight':
            leaf = 'kernel'
            v = np.transpose(v, (2, 3, 1, 0)) if v.ndim == 4 else v.T
        else:
            leaf = field                         # bias, scale, raw kernel
        node = out
        for key in [collection, *mods]:
            node = node.setdefault(key, {})
        node[leaf] = np.ascontiguousarray(v).reshape(v.shape)
    return out


def from_jax_variables(variables,
                       window_size: int = 7) -> Dict[str, torch.Tensor]:
    """flax variables of a single-stage detector, a two-stage detector, an
    S2ANet or an R3Det -> the port's state dict. ``window_size``: the Swin
    window the port's bias tables are built for (7 in every config)."""
    params = variables['params']
    if _is_yolo(params.get('backbone', {})):
        return mirror_from_jax(variables)
    n_lateral = sum(1 for k in params.get('neck', {})
                    if k.startswith('lateral_'))
    kinds = {'backbone': backbone_kind(params.get('backbone', {})),
             'neck': 'refpn' if any(
                 isinstance(v, dict) and 'orconv' in v
                 for v in params.get('neck', {}).values()) else 'fpn'}
    out: Dict[str, torch.Tensor] = {}
    stats = [(('batch_stats', 'backbone') + p, v) for p, v in _walk(
        variables.get('batch_stats', {}).get('backbone', {}))]
    for path, v in [(('params',) + p, v) for p, v in _walk(params)] + stats:
        top, rest = path[1], path[2:]
        if kinds.get(top) in _MODULES:
            module, leaf, mod_kind = _rule(kinds[top], '/'.join(rest[:-1]),
                                           rest[-1], True)
            out[f'{top}.{module}.{_LEAVES[mod_kind][leaf]}'] = \
                torch.from_numpy(np.ascontiguousarray(
                    _to_port(v, mod_kind, leaf, window_size),
                    dtype=np.float32))
            continue
        path = path[1:]
        if top == 'backbone':
            name = _backbone_name(rest)
        elif top == 'neck':
            name = _neck_name(rest, n_lateral)
        elif top in ('bbox_head', 'fam_head', 'odm_head'):
            name = _head_name(rest, top, _REPPOINTS if 'pts_init_conv' in
                              params[top] else None)
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
    return out


_BN_FIELDS_BACK = {v: k for k, v in _BN_FIELDS.items()}
_RETINA_OUT_BACK = {v: k for k, v in _RETINA_OUT.items()}
_REPPOINTS_BACK = {v: k for k, v in _REPPOINTS.items()}


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
        elif mods[0] in _REPPOINTS_BACK:
            mods = [_REPPOINTS_BACK[mods[0]]]
        elif mods[0] in ('cls_convs', 'reg_convs'):  # <tower>.<i>.conv|gn
            mods = [f'{mods[0][:3]}_{mods[2]}_{mods[1]}']
    elif top == 'feat_refine_module':            # <i>.conv_5_1
        top, mods = f'feat_refine_{mods[0]}', mods[1:]
    elif top == 'align_conv':                    # ac.<i>.deform_conv
        mods = [f'align_proj_{mods[1]}']
    elif top == 'rpn_head':
        pass                                     # rpn_conv / rpn_cls / rpn_reg
    elif top == 'roi_head':
        if mods[1].isdigit():                    # bbox_head.<stage>.<...>
            mods = [f'{mods[0]}_{mods[1]}', *mods[2:]]
        if mods[1] == 'shared_fcs':              # bbox_head.shared_fcs.<i>
            mods = [mods[0], f'shared_fc_{mods[2]}']
    else:
        raise ValueError(f'unhandled parameter name {name!r}')
    return (collection, top, *mods, leaf)


def to_jax_layout(state_dict, template=None) -> Dict[str, dict]:
    """The reverse of :func:`from_jax_variables`: a port ``state_dict`` (or
    any ``{port name: tensor}``, such as gradients by parameter name) -> a
    nested ``{'params': ..., 'batch_stats': ...}`` dict of numpy arrays with
    the flax names and layouts (convolution kernels OIHW -> HWIO, linear
    weights ``(out, in)`` -> ``(in, out)``, ORConv's 5-D weight and the
    align convolutions as :func:`_tensor` says, the other way).
    ``template``: flax variables (or their shapes) of the same detector;
    a Swin bias table is cut to the template's rows, where the JAX
    package's window shrank with its map."""
    if _is_yolo(k.split('.')[1] for k in state_dict
                if k.startswith('backbone.')):
        return mirror_to_jax(state_dict)
    n_lateral = len({k.split('.')[2] for k in state_dict
                     if k.startswith('neck.lateral_convs.')})
    # a group convolution's tensors are 5-D (or steerable coefficients)
    group = {k.split('.')[0] for k, v in state_dict.items()
             if torch.as_tensor(v).dim() == 5 or k.endswith('.coeff')}
    names = {k.split('.')[1] for k in state_dict}
    kinds = {'backbone': 'swin' if 'patch_embed' in names else
             'convnext' if 'downsample_layers' in names else
             're' if 'backbone' in group else 'resnet',
             'neck': 'refpn' if 'neck' in group else 'fpn'}
    out: Dict[str, dict] = {}
    for name, v in state_dict.items():
        v = torch.as_tensor(v).detach().cpu().numpy()
        top, *mods, field = name.split('.')
        if kinds.get(top) in _MODULES:
            module, leaf, mod_kind = _rule(kinds[top], '.'.join(mods), field,
                                           False)
            path = ['batch_stats' if leaf in ('mean', 'var') else 'params',
                    top, *module.split('/')]
            rows = None
            if mod_kind == 'table' and template is not None:
                node = template
                for key in path:
                    node = node[key]
                rows = node[leaf].shape[0]
            v = _to_flax(v, mod_kind, leaf, rows)
        else:
            *path, leaf = _jax_path(name, v.ndim, n_lateral)
            if v.ndim == 5:              # (out, in, nOr, 3, 3) ORConv
                v = np.transpose(v, (3, 4, 1, 2, 0)).reshape(
                    (9,) + v.shape[1:3] + v.shape[:1])
            elif v.ndim == 4 and path[-1].startswith(_TAP_DENSE):
                v = np.transpose(v, (2, 3, 1, 0)).reshape(-1, v.shape[0])
            elif v.ndim == 4:            # OIHW -> HWIO
                v = np.transpose(v, (2, 3, 1, 0))
            elif v.ndim == 2 and leaf == 'kernel':
                v = v.T
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = np.ascontiguousarray(v).reshape(v.shape)
    return out
