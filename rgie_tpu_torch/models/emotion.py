"""Pixel-space valence/arousal regressor: frozen ResNet-50 + ten-crop wrapper.
Port of ``rgie_tpu/models/emotion.py`` (reference:
EmotionPredictionModel.py:10-54 — Resize(480), ReplicateAndCrop(448) x10,
resnet50(4), MeanReplicatedCrops, Sigmoid).

The crops are the JAX package's deterministic grid by default (its
documented deviation from the reference's RandomCrop in the loss path);
pass a ``torch.Generator`` for stochastic crops. Only the plain-crop branch
is ported: the JAX package's ten-crop-in-space-to-depth forms compute the
same numbers on a TPU-friendly layout.

The compute type is the network's (``resnet50(dtype=...)``): the images are
cast to it before the resize, so the resize, the crops and the
normalization run in it, and the prediction and its sigmoid stay in it.
PyTorch's CPU has no bfloat16 antialiased resize, so there a bfloat16 image
is resized in float32 and rounded once (the CUDA kernel accumulates in
float32 and rounds once too).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from rgie_tpu_torch.models.init import freeze_, random_init_
from rgie_tpu_torch.models.resnet import ResNet, resnet50
from rgie_tpu_torch.ops import geometry as G


class EmotionRegressor(nn.Module):
    """Frozen VA regressor pipeline. Images NHWC in [0, 1] (normalize=True)
    or [-1, 1] (normalize=False, the GAN path)."""

    def __init__(self, net: ResNet, num_classes: int = 4, input_size: int = 480,
                 crop_size: int = 448, normalize: bool = True,
                 num_replications: int = 10, use_sigmoid: bool = True):
        super().__init__()
        self.net = net
        self.num_classes = num_classes
        self.input_size = input_size
        self.crop_size = crop_size
        self.normalize = normalize
        self.num_replications = num_replications
        self.use_sigmoid = use_sigmoid

    def forward(self, images: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, H, W, 3) -> (B, num_classes), the mean prediction over crops."""
        dtype = self.net.compute_dtype
        x = images.to(dtype)
        if dtype == torch.bfloat16 and x.device.type == "cpu":
            x = x.float()
        x = G.resize_shorter_side(x, self.input_size, antialias=True).to(dtype)
        x = G.replicate_and_crop(x, self.crop_size, self.num_replications,
                                 generator=generator)
        if self.normalize:
            x = (x - 0.5) / 0.5
        # NHWC permuted to NCHW is a channels_last tensor: cuDNN runs it as is.
        out = self.net(x.permute(0, 3, 1, 2))
        out = G.mean_replicated(out, self.num_replications)
        return torch.sigmoid(out) if self.use_sigmoid else out


def create_regressor(generator: torch.Generator, num_classes: int = 4,
                     normalize: bool = True, input_size: int = 480,
                     crop_size: int = 448, use_sigmoid: bool = True,
                     dtype: torch.dtype = torch.float32) -> EmotionRegressor:
    """Random-weight ResNet-50 regressor (stand-in for the external
    ``va_pred_all`` checkpoint), frozen, on the CPU, computing in ``dtype``
    (the float32 draws rounded once to it)."""
    net = random_init_(resnet50(num_classes, dtype), generator)
    return freeze_(EmotionRegressor(net, num_classes=num_classes, input_size=input_size,
                                    crop_size=crop_size, normalize=normalize,
                                    use_sigmoid=use_sigmoid))
