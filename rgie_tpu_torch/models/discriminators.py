"""The pixel-space multi-scale discriminator of the ``--weight-dis`` realism
term. Port of ``PixelDiscriminator`` in ``rgie_tpu/models/discriminators.py``
with the reference's module names (src/baselines/models/Discriminator.py:
38-68), so its checkpoint (``imagenet_w0_high_lookhere_dis``) loads as is.
The MUNIT patch discriminators come with the GAN slice.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


def avg_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """torch avg_pool2d(kernel=3, stride=2, padding=1), count_include_pad."""
    return F.avg_pool2d(x, 3, 2, 1, count_include_pad=True)


def pixel_discriminator_arch(size_w: int, size_h: int) -> Tuple[int, int]:
    """(conv layers, channel cap) for the supported input sizes."""
    if size_w in (620, 480) and size_h == 480:
        return 6, 1024
    if size_w in (160, 120) and size_h == 120:
        return 4, 256
    raise ValueError("image input dimension not supported")


def final_conv_dim(dim_len: int, scale: int, n_dis: int) -> int:
    """compute_final_conv_layer_dim (Discriminator.py:92-104)."""
    return int((dim_len / 2) / (2 ** (n_dis - 1 + scale)))


class PixelDiscriminator(nn.Module):
    """n_scale conv towers (reflect pad 1, 4x4 stride-2 conv, leaky ReLU 0.2)
    with a per-scale MLP logit; the mean logit over scales goes through a
    sigmoid. Takes NHWC, returns (B, 1)."""

    def __init__(self, num_features: int = 64, n_scale: int = 3,
                 size_w: int = 480, size_h: int = 480):
        super().__init__()
        n_dis, max_channels = pixel_discriminator_arch(size_w, size_h)
        self.n_scale = n_scale
        self.modules_features = nn.ModuleList()
        self.modules_logs = nn.ModuleList()
        for scale in range(n_scale):
            ch, cin = num_features, 3
            layers = []
            for i in range(n_dis):
                cout = ch if i == 0 else ch * 2
                layers.append(nn.Sequential(nn.ReflectionPad2d(1), nn.Conv2d(cin, cout, 4, 2),
                                            nn.LeakyReLU(0.2)))
                if i > 0 and ch < max_channels:
                    ch = ch * 2
                cin = cout
            self.modules_features.append(nn.Sequential(*layers))
            flat = cin * final_conv_dim(size_h, scale, n_dis) * final_conv_dim(size_w, scale, n_dis)
            self.modules_logs.append(nn.Sequential(
                nn.Flatten(1), nn.Linear(flat, 128), nn.LeakyReLU(0.2), nn.Linear(128, 1)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        im = x.permute(0, 3, 1, 2)
        logits = []
        for scale in range(self.n_scale):
            logits.append(self.modules_logs[scale](self.modules_features[scale](im)))
            if scale != self.n_scale - 1:
                im = avg_pool_3x3_s2(im)
        return torch.sigmoid(torch.mean(torch.stack(logits), dim=0))
