"""torchvision-keyed ResNet (NCHW), the backbone of the pixel-space
valence/arousal regressor. Port of ``rgie_tpu/models/resnet.py``.

Bottleneck v1.5 (stride on ``conv2``), a projection shortcut on the first
block of every stage, and the plain stem only: 7x7 stride-2 conv, BatchNorm
(eps 1e-5), ReLU, ``MaxPool2d(3, 2, 1)``. The JAX package's space-to-depth
stems are TPU layout levers with the same numbers and have no counterpart.
Parameter names are torchvision's, so a ``va_pred_all`` state dict loads
with ``load_state_dict(strict=True)``.

``dtype`` is Flax's compute type, as in the JAX package: the convolutions
and the head hold their weights rounded once to it and take their input in
it; BatchNorm keeps float32 statistics and affine parameters, normalizes in
float32 and returns ``dtype``, as Flax's ``BatchNorm(dtype=...)`` does.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


class Bottleneck(nn.Module):
    """torchvision Bottleneck: expansion 4, stride on the 3x3 conv."""

    def __init__(self, inplanes: int, features: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, features, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(features, eps=1e-5)
        self.conv2 = nn.Conv2d(features, features, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(features, eps=1e-5)
        self.conv3 = nn.Conv2d(features, features * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(features * 4, eps=1e-5)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, features * 4, 1, stride, bias=False),
                nn.BatchNorm2d(features * 4, eps=1e-5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        return F.relu(self.bn3(self.conv3(y)) + residual)


class ResNet(nn.Module):
    """torchvision-compatible ResNet; ``stage_sizes=(3, 4, 6, 3)`` is
    ResNet-50. Takes NCHW (``channels_last`` works too), returns logits."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int,
                 num_filters: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = nn.Conv2d(3, num_filters, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(num_filters, eps=1e-5)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        inplanes = num_filters
        for i, blocks in enumerate(stage_sizes):
            features = num_filters * 2 ** i
            layer = []
            for j in range(blocks):
                stride = 2 if (i > 0 and j == 0) else 1
                layer.append(Bottleneck(inplanes, features, stride, downsample=(j == 0)))
                inplanes = features * 4
            self.add_module(f"layer{i + 1}", nn.Sequential(*layer))
        self.num_stages = len(stage_sizes)
        self.fc = nn.Linear(inplanes, num_classes)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                m.to(dtype)

    @property
    def compute_dtype(self) -> torch.dtype:
        """The type the convolutions compute in (follows ``.to(dtype)``)."""
        return self.conv1.weight.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.maxpool(F.relu(self.bn1(self.conv1(x.to(self.compute_dtype)))))
        for i in range(self.num_stages):
            x = getattr(self, f"layer{i + 1}")(x)
        return self.fc(x.mean(dim=(2, 3)))


def resnet50(num_classes: int, dtype: torch.dtype = torch.float32) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), num_classes=num_classes, dtype=dtype)
