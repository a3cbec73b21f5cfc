"""Shared building blocks (counterpart of
``orientedobjectdetection_tpu/models/blocks.py``)."""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn


class ConvModule(nn.Module):
    """mmcv's ConvModule without a norm: holds ``conv`` (so checkpoints
    name it ``<parent>.conv.weight``), optionally followed by ReLU."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int = 0, relu: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride=stride, padding=padding)
        self.relu = relu

    def forward(self, x):
        x = self.conv(x)
        return F.relu(x) if self.relu else x
