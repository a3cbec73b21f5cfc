"""jy head variants, the MSDCN and decoupled-objectness YOLOv8 heads
(counterpart of ``orientedobjectdetection_tpu/models/dense_heads/
jy_heads.py``; reference ``rotated_msdeform_head.py:24-282`` and
``rotated_objectness_head.py:23,385``).

The deformable block samples its 3x3 taps with
``ops/feature_align.py:deform_conv_sample`` (four corner gathers, plain
PyTorch). The JAX package flattens the taps tap-major, ``(B, H, W, 9,
C)``, before its dense projection; the port's sampler returns ``(B, C, 9,
H, W)``, which is permuted to that order, so ``proj`` is the JAX dense
layer as it is.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from ...ops.feature_align import deform_conv_sample
from ...utils.registry import HEADS, LOSSES
from ..blocks import YOLOConvModule
from .rotated_fcos_head import Scale, _flat
from .rotated_yolov8_head import RotatedYOLOv8Head


class MSDeformConvBlock(nn.Module):
    """18-channel 3x3 ``offset`` conv (mmcv's DCN order: y then x a tap),
    the 3x3 taps sampled at those offsets, a biased dense ``proj`` over
    the tap-major taps, SiLU."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.offset = nn.Conv2d(cin, 18, 3, padding=1)
        self.proj = nn.Linear(9 * cin, cout)

    def forward(self, x):
        b, c, h, w = x.shape
        with record_function('yolov8.dcn_sample'):
            taps = deform_conv_sample(x, self.offset(x))   # (B, C, 9, H, W)
        taps = taps.permute(0, 3, 4, 2, 1).reshape(b, h, w, 9 * c)
        out = self.proj(taps.to(x.dtype))
        return F.silu(out).permute(0, 3, 1, 2)


@HEADS.register_module()
class RotatedMSDCNHead(RotatedYOLOv8Head):
    """YOLOv8 head whose cls and reg towers start with a deformable block
    (``cls_dcn_{i}`` / ``reg_dcn_{i}``) followed by one conv module
    (``cls_conv_{i}`` / ``reg_conv_{i}``); the angle tower is one conv
    module (``ang_conv_{i}``). No DFL: the reg tower is ``max(16,
    width // 4)`` wide."""

    def __init__(self, **kwargs):
        kwargs.pop('reg_max', None)
        super().__init__(**kwargs)

    def build_level(self, i, cin):
        self.add_module(f'cls_dcn_{i}', MSDeformConvBlock(cin, self.cls_out))
        self.add_module(f'cls_conv_{i}',
                        YOLOConvModule(self.cls_out, self.cls_out, 3))
        self.add_module(f'cls_pred_{i}',
                        nn.Conv2d(self.cls_out, self.num_classes, 1))
        self.add_module(f'reg_dcn_{i}', MSDeformConvBlock(cin, self.reg_out))
        self.add_module(f'reg_conv_{i}',
                        YOLOConvModule(self.reg_out, self.reg_out, 3))
        self.add_module(f'reg_pred_{i}', nn.Conv2d(self.reg_out, 4, 1))
        self.add_module(f'scale_{i}', Scale())
        self.add_module(f'ang_conv_{i}', YOLOConvModule(cin, self.cls_out, 3))
        self.add_module(f'ang_pred_{i}', nn.Conv2d(self.cls_out, 1, 1))

    @torch.no_grad()
    def init_cls_prior(self):
        """The JAX package's initializers: the output biases
        (:meth:`prior_biases`) and zero offsets (the deformable blocks'
        ``offset`` kernels start at 0: a regular 3x3 sampling)."""
        super().init_cls_prior()
        for i in range(len(self.featmap_strides)):
            for tower in ('cls', 'reg'):
                getattr(self, f'{tower}_dcn_{i}').offset.weight.zero_()

    def forward_level(self, i, x):
        c = getattr(self, f'cls_conv_{i}')(getattr(self, f'cls_dcn_{i}')(x))
        r = getattr(self, f'reg_conv_{i}')(getattr(self, f'reg_dcn_{i}')(x))
        a = getattr(self, f'ang_conv_{i}')(x)
        return (getattr(self, f'cls_pred_{i}')(c), self.regression(i, r),
                getattr(self, f'ang_pred_{i}')(a))


@HEADS.register_module()
class RotatedDecoupledObjHead(RotatedYOLOv8Head):
    """Decoupled objectness head: an objectness tower of its own
    (``obj_conv_{i}_{0,1}``, ``obj_pred_{i}``); the angle tower is one conv
    module (``ang_conv_{i}_0``). ``forward`` returns (cls_scores,
    bbox_preds, angle_preds, obj_preds). The classification loss is
    ``loss_cls`` (by default ``ObjectnessLoss3``) over (objectness, class
    logits); the detections are scored by ``cls + log_sigmoid(obj)``."""

    def __init__(self, **kwargs):
        kwargs.pop('reg_max', None)
        if kwargs.get('loss_cls') is None:
            kwargs['loss_cls'] = dict(type='ObjectnessLoss3')
        super().__init__(**kwargs)

    def build_level(self, i, cin):
        self.tower(f'cls_conv_{i}', cin, self.cls_out)
        self.add_module(f'cls_pred_{i}',
                        nn.Conv2d(self.cls_out, self.num_classes, 1))
        self.tower(f'obj_conv_{i}', cin, self.cls_out)
        self.add_module(f'obj_pred_{i}', nn.Conv2d(self.cls_out, 1, 1))
        self.tower(f'reg_conv_{i}', cin, self.reg_out)
        self.add_module(f'reg_pred_{i}', nn.Conv2d(self.reg_out, 4, 1))
        self.add_module(f'scale_{i}', Scale())
        self.add_module(f'ang_conv_{i}_0',
                        YOLOConvModule(cin, self.cls_out, 3))
        self.add_module(f'ang_pred_{i}', nn.Conv2d(self.cls_out, 1, 1))

    def forward_level(self, i, x):
        c = self.run_tower(f'cls_conv_{i}', x)
        o = self.run_tower(f'obj_conv_{i}', x)
        r = self.run_tower(f'reg_conv_{i}', x)
        a = getattr(self, f'ang_conv_{i}_0')(x)
        return (getattr(self, f'cls_pred_{i}')(c), self.regression(i, r),
                getattr(self, f'ang_pred_{i}')(a),
                getattr(self, f'obj_pred_{i}')(o))

    def prior_biases(self) -> dict:
        out = super().prior_biases()
        out.update({f'obj_pred_{i}': 1.0
                    for i in range(len(self.featmap_strides))})
        return out

    def cls_term(self, outputs, cls_flat, labels, num_pos):
        obj_flat = _flat(outputs[3], cls_flat.shape[0], 1).float()
        return self.cls_loss(obj_flat, cls_flat, labels, self.num_classes,
                             weight=torch.ones_like(labels,
                                                    dtype=torch.float),
                             avg_factor=num_pos)

    def score_logits(self, outputs):
        return tuple(c + F.logsigmoid(o)
                     for c, o in zip(outputs[0], outputs[3]))


@HEADS.register_module()
class RotatedDecoupledBGHead(RotatedDecoupledObjHead):
    """The coupled background-slot variant: the same network and loss
    wiring (the config picks ``ObjectnessLoss2``)."""


@HEADS.register_module()
class RotatedDecoupled1x1ObjHead(RotatedDecoupledObjHead):
    """Objectness and class share the two-conv class tower and part at the
    1x1 convs: ``fg_pred_{i}`` (the class logits) and ``obj_pred_{i}``; the
    angle tower has two conv modules."""

    def build_level(self, i, cin):
        self.tower(f'cls_conv_{i}', cin, self.cls_out)
        self.add_module(f'fg_pred_{i}',
                        nn.Conv2d(self.cls_out, self.num_classes, 1))
        self.add_module(f'obj_pred_{i}', nn.Conv2d(self.cls_out, 1, 1))
        self.tower(f'reg_conv_{i}', cin, self.reg_out)
        self.add_module(f'reg_pred_{i}', nn.Conv2d(self.reg_out, 4, 1))
        self.add_module(f'scale_{i}', Scale())
        self.tower(f'ang_conv_{i}', cin, self.cls_out)
        self.add_module(f'ang_pred_{i}', nn.Conv2d(self.cls_out, 1, 1))

    def forward_level(self, i, x):
        c = self.run_tower(f'cls_conv_{i}', x)
        r = self.run_tower(f'reg_conv_{i}', x)
        a = self.run_tower(f'ang_conv_{i}', x)
        return (getattr(self, f'fg_pred_{i}')(c), self.regression(i, r),
                getattr(self, f'ang_pred_{i}')(a),
                getattr(self, f'obj_pred_{i}')(c))

    def prior_biases(self) -> dict:
        return {k.replace('cls_pred_', 'fg_pred_'): v
                for k, v in super().prior_biases().items()}
