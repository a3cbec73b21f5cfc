"""Reference checkpoints (mmyolo / mmrotate names) -> the port's state
dicts, for the two families whose port names are not the reference's
(counterpart of ``tools/model_converters/convert_torch_weights.py``'s
``convert_checkpoint`` and ``synthesize_reference_state`` for them):

- ``RotatedYOLOv8`` (CSPNeXt, YOLOv8PAFPN, the RotatedYOLOv8 head; the
  jy prototypes): the port keeps the flax names (``stem_0``,
  ``stage2_csp.block_0.conv2.dw``, ``top_down_0``, ``cls_conv_1_0``,
  ``scale_2``). The tensors keep the reference's layout; only the names
  change, and the head's ``scales.{i}.scale`` (1,) becomes ``scale_{i}.
  scale`` (). A checkpoint with only ``backbone.*`` keys (a COCO
  warm-start) converts to the backbone's keys. The YOLOv6 Rep-PAFPN has no
  mapping, as in the JAX converter.
- ``ReDet`` (ReResNet, ReFPN, the RPN and the RoI head): e2cnn stores each
  group convolution's expanded ``.filter`` (out_base x 8, in_base x in_or,
  k, k) and each InnerBatchNorm's per-field values (``batch_norm_[8]``);
  the port keeps the tied base taps ``(out_base, in_base, in_or, k, k)``
  (the o_out = 0 block of the filter) and BatchNorm values repeated over
  the 8 orientations. The heads' names are the reference's.

Every other detector type of the JAX converter has the reference's names
in the port already: ``apis/inference.py:init_detector`` loads such a
checkpoint as it is, and :func:`convert_checkpoint` refuses it (and any
unknown type) with a ``ValueError``.

A conversion consumes each source key it maps; ``leftover_keys`` lists
the others that carry weights (the buffers that carry none are ignored,
as the JAX converter ignores them), so an exact conversion has none.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..models.utils_rotation import _rotation_perms

# the source keys that carry no weights (buffers and bookkeeping), as the
# JAX converter's ``_IGNORED``
_IGNORED = re.compile(
    r'(num_batches_tracked$|\.indices$|anchor_generator|prior_generator'
    r'|\.filter$|_iter$|relative_position_index$)')
NUM_ORIENTATIONS = 8
# the detector types of the JAX converter whose port names are the
# reference's
SAME_NAMES = ('RotatedRetinaNet', 'RotatedATSS', 'KFIoU', 'RotatedFCOS',
              'OrientedRCNN', 'RotatedFasterRCNN', 'GlidingVertex',
              'RoITransformer', 'S2ANet', 'R3Det')


class _Source(dict):
    """A reference state dict that records the keys each table takes."""

    def __init__(self, state):
        super().__init__(state)
        self.consumed = set()

    def under(self, prefix):
        return [(k, k[len(prefix):]) for k in list(self)
                if k.startswith(prefix)]

    def leftovers(self) -> List[str]:
        return sorted(k for k in self
                      if k not in self.consumed and not _IGNORED.search(k))


def _tensor(v) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v, dtype=np.float32)).clone()


# ---- the YOLO stack ---------------------------------------------------------
_CM_FROM = {None: 'conv', 'depthwise': 'dw', 'pointwise': 'pw'}
_CM_TO = {'conv': 'conv', 'bn': 'bn', 'dw': 'depthwise_conv.conv',
          'dw_bn': 'depthwise_conv.bn', 'pw': 'pointwise_conv.conv',
          'pw_bn': 'pointwise_conv.bn'}
_BN = ('weight', 'bias', 'running_mean', 'running_var')


def _under(head, sub):
    """``head.sub``, or None where ``sub`` has no port name."""
    return None if sub is None else f'{head}.{sub}'


def _cm_name(sub):
    """An mmcv ConvModule (or depthwise-separable one) sub-key -> the
    port's ``YOLOConvModule`` sub-key, or None when ``sub`` is not one."""
    m = re.match(r'(?:(depthwise|pointwise)_conv\.)?(conv|bn)\.(\w+)$', sub)
    if not m:
        return None
    kind, mod, field = m.groups()
    return f'{_CM_FROM[kind]}{"_bn" if mod == "bn" else ""}.{field}' \
        if kind else f'{mod}.{field}'


def _csp_name(sub):
    """A CSPLayer / CSPLayerWithTwoConv sub-key -> the port's."""
    m = re.match(r'(main_conv|short_conv|final_conv)\.(.*)$', sub)
    if m:
        return _under(m.group(1), _cm_name(m.group(2)))
    m = re.match(r'blocks\.(\d+)\.(conv1|conv2)\.(.*)$', sub)
    if m:
        return _under(f'block_{m.group(1)}.{m.group(2)}',
                      _cm_name(m.group(3)))
    m = re.match(r'attention\.fc\.(weight|bias)$', sub)
    return f'attn.fc.{m.group(1)}' if m else None


def _cspnext_name(name):
    m = re.match(r'stem\.(\d)\.(.*)$', name)
    if m:
        return _under(f'stem_{m.group(1)}', _cm_name(m.group(2)))
    m = re.match(r'stage(\d+)\.(\d+)\.(.*)$', name)
    if not m:
        return None
    s, rest = m.group(1), m.group(3)
    if re.match(r'(conv|bn)\.', rest):           # the stride-2 conv
        return _under(f'stage{s}_conv', _cm_name(rest))
    if re.match(r'conv[12]\.', rest):            # the SPPF bottleneck
        c, tail = rest.split('.', 1)
        return _under(f'stage{s}_spp.{c}', _cm_name(tail))
    return _under(f'stage{s}_csp', _csp_name(rest))


def _pafpn_name(name, levels):
    m = re.match(r'(top_down|bottom_up|downsample)_layers\.(\d+)\.(.*)$',
                 name)
    if not m:
        return None
    kind, i, sub = m.groups()
    if kind == 'top_down':        # the reference's run from the coarsest
        return _under(f'top_down_{levels - 2 - int(i)}', _csp_name(sub))
    if kind == 'bottom_up':
        return _under(f'bottom_up_{i}', _csp_name(sub))
    return _under(f'downsample_{i}', _cm_name(sub))


def _yolov8_head_name(name):
    m = re.match(r'(reg|cls|ang)_preds\.(\d+)\.([012])\.(.*)$', name)
    if m:
        t, i, j, sub = m.groups()
        if j in '01':
            return _under(f'{t}_conv_{i}_{j}', _cm_name(sub))
        return f'{t}_pred_{i}.{sub}' if sub in ('weight', 'bias') else None
    m = re.match(r'scales\.(\d+)\.scale$', name)
    return f'scale_{m.group(1)}.scale' if m else None


def _convert_yolov8(src: _Source) -> Dict[str, torch.Tensor]:
    levels = 1 + len({k.split('.')[2] for k in src
                      if k.startswith('neck.top_down_layers.')})
    out = {}
    tables = [('backbone.', _cspnext_name)]
    if levels > 1:
        tables.append(('neck.', lambda n: _pafpn_name(n, levels)))
    tables.append(('bbox_head.', _yolov8_head_name))
    for prefix, table in tables:
        for key, name in src.under(prefix):
            ours = table(name)
            if ours is None:
                continue
            src.consumed.add(key)
            if not ours.endswith('num_batches_tracked'):
                v = _tensor(src[key])
                out[prefix + ours] = v.reshape(()) if ours.startswith(
                    'scale_') else v
    return out


def _synth_cm(sub):
    child, field = sub.split('.')
    return f'{_CM_TO[child]}.{field}'


def _synth_csp(sub):
    m = re.match(r'block_(\d+)\.(conv1|conv2)\.(.*)$', sub)
    if m:
        return f'blocks.{m.group(1)}.{m.group(2)}.{_synth_cm(m.group(3))}'
    m = re.match(r'attn\.fc\.(weight|bias)$', sub)
    if m:
        return f'attention.fc.{m.group(1)}'
    m = re.match(r'(main_conv|short_conv|final_conv)\.(.*)$', sub)
    if m:
        return f'{m.group(1)}.{_synth_cm(m.group(2))}'
    raise ValueError(f'synthesize: no reference name for CSP key {sub!r}')


def _synth_yolov8(state) -> Dict[str, np.ndarray]:
    spp = {m.group(1) for k in state
           for m in [re.match(r'backbone\.stage(\d+)_spp\.', k)] if m}
    levels = 1 + len({k.split('.')[1] for k in state
                      if re.match(r'neck\.top_down_\d+\.', k)})
    out = {}
    for key, v in state.items():
        top, name = key.split('.', 1)
        ref = None
        if top == 'backbone':
            m = re.match(r'stem_(\d)\.(.*)$', name)
            s = re.match(r'stage(\d+)_(conv|spp|csp)\.(.*)$', name)
            if m:
                ref = f'stem.{m.group(1)}.{_synth_cm(m.group(2))}'
            elif s and s.group(2) == 'conv':
                ref = f'stage{s.group(1)}.0.{_synth_cm(s.group(3))}'
            elif s and s.group(2) == 'spp':
                c, tail = s.group(3).split('.', 1)
                ref = f'stage{s.group(1)}.1.{c}.{_synth_cm(tail)}'
            elif s:
                idx = 2 if s.group(1) in spp else 1
                ref = f'stage{s.group(1)}.{idx}.{_synth_csp(s.group(3))}'
        elif top == 'neck':
            m = re.match(r'(top_down|bottom_up|downsample)_(\d+)\.(.*)$',
                         name)
            if m and m.group(1) == 'top_down':
                ref = (f'top_down_layers.{levels - 2 - int(m.group(2))}.'
                       f'{_synth_csp(m.group(3))}')
            elif m and m.group(1) == 'bottom_up':
                ref = f'bottom_up_layers.{m.group(2)}.{_synth_csp(m.group(3))}'
            elif m:
                ref = (f'downsample_layers.{m.group(2)}.'
                       f'{_synth_cm(m.group(3))}')
        elif top == 'bbox_head':
            m = re.match(r'(reg|cls|ang)_conv_(\d+)_(\d+)\.(.*)$', name)
            p = re.match(r'(reg|cls|ang)_pred_(\d+)\.(weight|bias)$', name)
            s = re.match(r'scale_(\d+)\.scale$', name)
            if m:
                t, i, j, sub = m.groups()
                ref = f'{t}_preds.{i}.{j}.{_synth_cm(sub)}'
            elif p:
                ref = f'{p.group(1)}_preds.{p.group(2)}.2.{p.group(3)}'
            elif s:
                ref = f'scales.{s.group(1)}.scale'
                v = v.reshape(1)
        if ref is None:
            raise ValueError(f'synthesize RotatedYOLOv8: no reference name '
                             f'for {key!r}')
        out[f'{top}.{ref}'] = v
    return out


# ---- ReDet ------------------------------------------------------------------
def taps_from_filter(filt, in_orientations: int = NUM_ORIENTATIONS):
    """e2cnn's expanded filter (out_base x 8, in_base x in_or, k, k) -> the
    port's tied taps (out_base, in_base, in_or, k, k): the o_out = 0 block
    (both channel axes are orientation-minor)."""
    out8, cin, kh, kw = filt.shape
    n = NUM_ORIENTATIONS
    return filt.reshape(out8 // n, n, cin // in_orientations,
                        in_orientations, kh, kw)[:, 0]


def filter_from_taps(w):
    """The port's tied taps (out_base, in_base, in_or, k, k) -> e2cnn's
    expanded filter: copy ``o`` rotates the taps by ``o`` ring steps (a 3x3
    filter) and rolls the input orientations by ``o`` (a regular input),
    at output channels ``base * 8 + o``."""
    out, cin_b, in_or, k, _ = w.shape
    n = NUM_ORIENTATIONS
    perms = _rotation_perms(n)
    full = np.zeros((out * n, cin_b * in_or, k, k), np.float32)
    for o in range(n):
        wo = w
        if k == 3:
            wo = wo.reshape(out, cin_b, in_or, 9)[..., perms[o]].reshape(
                w.shape)
        if in_or == n:
            wo = np.roll(wo, o, axis=2)
        full[o::n] = wo.reshape(out, cin_b * in_or, k, k)
    return full


_RE_CONV = re.compile(r'(conv\d|downsample\.0|(?:lateral|fpn)_convs\.\d+\.'
                      r'conv)$')
_RE_BN = re.compile(r'(bn\d|downsample\.1)$')


def _convert_redet(src: _Source) -> Dict[str, torch.Tensor]:
    out = {}
    for prefix in ('backbone.', 'neck.'):
        for key, name in src.under(prefix):
            base, _, field = name.rpartition('.')
            if _RE_CONV.search(base) and field == 'filter':
                in_or = 1 if base == 'conv1' else NUM_ORIENTATIONS
                out[f'{prefix}{base}.weight'] = _tensor(
                    taps_from_filter(np.asarray(src[key]), in_or))
                src.consumed.add(key)
                for aux in ('.weights', '.expanded_bias'):
                    if prefix + base + aux in src:
                        src.consumed.add(prefix + base + aux)
            elif _RE_CONV.search(base) and field == 'weights' and \
                    prefix + base + '.filter' not in src:
                raise ValueError(
                    f'{prefix}{base}.filter missing but .weights present: '
                    'the checkpoint was saved without expanded e2cnn '
                    'filters; save it again after model.eval()')
            elif prefix == 'neck.' and _RE_CONV.search(base) and \
                    field == 'bias':
                out[key] = _tensor(src[key])
                src.consumed.add(key)
            m = re.match(r'(.*)\.batch_norm_\[8\]\.(\w+)$', name)
            if m and prefix == 'backbone.' and m.group(2) in _BN:
                out[f'{prefix}{m.group(1)}.{m.group(2)}'] = _tensor(
                    np.repeat(np.asarray(src[key]), NUM_ORIENTATIONS))
                src.consumed.add(key)
            elif m and prefix == 'backbone.' and \
                    m.group(2) == 'num_batches_tracked':
                src.consumed.add(key)
    for key, name in src.under('rpn_head.'):
        if re.match(r'(rpn_conv|rpn_cls|rpn_reg)\.(weight|bias)$', name):
            out[key] = _tensor(src[key])
            src.consumed.add(key)
    for key, name in src.under('roi_head.bbox_head.'):
        if re.match(r'(shared_fcs\.\d+|fc_cls|fc_reg|fc_fix|fc_ratio)\.'
                    r'(weight|bias)$', name):
            out[key] = _tensor(src[key])
            src.consumed.add(key)
    return out


def _synth_redet(state) -> Dict[str, np.ndarray]:
    out = {}
    for key, v in state.items():
        base, _, field = key.rpartition('.')
        if key.startswith(('backbone.', 'neck.')) and field == 'weight' \
                and v.ndim == 5:
            out[f'{base}.filter'] = filter_from_taps(v)
        elif key.startswith(('backbone.', 'neck.')) and field == 'coeff':
            raise ValueError(f'synthesize ReDet: {key}: a steerable '
                             f'convolution has no reference filter here')
        elif key.startswith('backbone.') and field in _BN:
            out[f'{base}.batch_norm_[8].{field}'] = \
                v.reshape(-1, NUM_ORIENTATIONS)[:, 0]
        else:
            out[key] = v
    return out


CONVERTERS = {'RotatedYOLOv8': (_convert_yolov8, _synth_yolov8),
              'ReDet': (_convert_redet, _synth_redet)}


def _check_type(detector_type):
    if detector_type in CONVERTERS:
        return CONVERTERS[detector_type]
    if detector_type in SAME_NAMES:
        raise ValueError(
            f'{detector_type}: the port\'s names are the reference\'s; '
            f'init_detector loads the checkpoint as it is')
    raise ValueError(f'no converter for detector type {detector_type!r}; '
                     f'known: {sorted(set(CONVERTERS) | set(SAME_NAMES))}')


def convert_checkpoint(state_dict, detector_type: str
                       ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """A reference state dict (tensors or numpy arrays) -> ``(the port's
    state dict, leftover_keys)``: float32 tensors under the port's names,
    and the source keys that carry weights and that no table mapped."""
    convert, _ = _check_type(detector_type)
    src = _Source({k: v.detach().cpu().numpy() if torch.is_tensor(v) else v
                   for k, v in state_dict.items()})
    return convert(src), src.leftovers()


def synthesize_reference_state(state_dict, detector_type: str
                               ) -> Dict[str, np.ndarray]:
    """The inverse of :func:`convert_checkpoint`: the port's state dict ->
    a state dict under the reference's names and layouts, numpy float32
    (e2cnn's expanded filters and per-field BatchNorm values for ReDet).
    Raises ``ValueError`` on a key the reference has no name for."""
    _, synth = _check_type(detector_type)
    return synth({k: np.asarray(torch.as_tensor(v).detach().cpu().float())
                  for k, v in state_dict.items()})
