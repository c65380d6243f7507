"""The pixel-space multi-scale discriminator of the ``--weight-dis`` realism
term. Port of ``PixelDiscriminator`` in ``rgie_tpu/models/discriminators.py``
with the reference's module names (src/baselines/models/Discriminator.py:
38-68), so its checkpoint (``imagenet_w0_high_lookhere_dis``) loads as is;
and the MUNIT multi-resolution patch discriminator of the GAN edit's
``--weight-dis`` term, with imaginaire's names.
"""

from __future__ import annotations

from typing import List, Tuple

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


# ---------------------------------------------------------------------------
# The MUNIT multi-resolution patch discriminator (imaginaire
# discriminators/multires_patch.py; MUNIT config: patch-wise, 48 filters, max
# 1024, 5 layers, 3 scales, spectral norm folded into the kernels on load).
# ---------------------------------------------------------------------------


def bilinear_half(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NHWC at half size, ``F.interpolate(bilinear, align_corners=
    True)`` (multires_patch.py:169-171); half-pixel centres would be the
    wrong convention here."""
    h, w = x.shape[1], x.shape[2]
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(h // 2, w // 2), mode="bilinear",
                      align_corners=True)
    return y.permute(0, 2, 3, 1)


class PatchConv(nn.Module):
    """One layer of the patch discriminator with imaginaire's keys
    (``layers.conv.*``): zero-padded conv, then leaky ReLU 0.2 unless it is
    the head."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, stride: int,
                 padding: int, activation: bool = True):
        super().__init__()
        self.layers = nn.ModuleDict({"conv": nn.Conv2d(in_channels, out_channels, kernel,
                                                       stride, padding)})
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.layers["conv"](x)
        return F.leaky_relu(x, 0.2) if self.activation else x


class NLayerPatchDiscriminator(nn.Module):
    """Patch discriminator (multires_patch.py:244-313): stride-2 conv stack
    (the last hidden layer stride 1) and a 1-channel 3x3 head. Layer n is
    ``layer{n}.0``. Takes NCHW; returns the NCHW logits and the hidden
    features."""

    def __init__(self, num_filters: int = 48, num_layers: int = 5, max_num_filters: int = 1024,
                 kernel_size: int = 3, in_channels: int = 3):
        super().__init__()
        pad = (kernel_size - 1) // 2
        nf = num_filters
        self.layer0 = nn.Sequential(PatchConv(in_channels, nf, kernel_size, 2, pad))
        for n in range(num_layers):
            nf_next = min(nf * 2, max_num_filters)
            stride = 2 if n < num_layers - 1 else 1
            self.add_module(f"layer{n + 1}",
                            nn.Sequential(PatchConv(nf, nf_next, kernel_size, stride, pad)))
            nf = nf_next
        self.add_module(f"layer{num_layers + 1}",
                        nn.Sequential(PatchConv(nf, 1, 3, 1, pad, activation=False)))
        self.num_layers = num_layers

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        features = []
        for n in range(self.num_layers + 1):
            x = getattr(self, f"layer{n}")(x)
            features.append(x)
        return getattr(self, f"layer{self.num_layers + 1}")(x), features


class MultiResPatchDiscriminator(nn.Module):
    """N patch discriminators over a bilinear 0.5x pyramid
    (multires_patch.py:103-172). Takes NHWC; returns the per-scale NHWC
    logits, the per-scale NHWC features and the per-scale NHWC inputs, as
    the JAX package's module does."""

    def __init__(self, num_discriminators: int = 3, num_filters: int = 48,
                 num_layers: int = 5, max_num_filters: int = 1024):
        super().__init__()
        self.discriminators = nn.ModuleList([
            NLayerPatchDiscriminator(num_filters, num_layers, max_num_filters)
            for _ in range(num_discriminators)])

    def forward(self, x: torch.Tensor):
        outputs, features_all, inputs = [], [], []
        im = x
        for i, dis in enumerate(self.discriminators):
            inputs.append(im)
            out, feats = dis(im.permute(0, 3, 1, 2))
            outputs.append(out.permute(0, 2, 3, 1))
            features_all.append([f.permute(0, 2, 3, 1) for f in feats])
            if i != len(self.discriminators) - 1:
                im = bilinear_half(im)
        return outputs, features_all, inputs
