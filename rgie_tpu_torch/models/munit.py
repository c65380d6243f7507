"""MUNIT autoencoder, the GAN backend of the style-code edit. Port of
``rgie_tpu/models/munit.py`` (reference: imaginaire's generators/munit.py,
generators/unit.py:166-238 and layers/{conv,residual,activation_norm}.py),
at the shipped ``imagenet2imagenet.yaml`` hyper-parameters by default.

Module and key names are imaginaire's (``autoencoder_a.content_encoder.
model.{k}.layers.conv.weight``, ...), so a ``net_G`` state dict whose
spectral norms are folded into the kernels (``utils.checkpoint``) loads with
``strict=True``. The public functions take and return NHWC tensors like the
JAX package's; inside, the convolutions run on NCHW views of them.

``dtype`` is Flax's compute type, and the JAX package's mixed precision is
kept as it is, not "fixed":

* each convolution holds its weights rounded once to ``dtype`` and casts its
  input to it; the output convolution is float32 whatever ``dtype`` is;
* ``instance_norm`` runs in its input's type, so after a convolution in
  bfloat16; the affine ``InstanceNorm`` parameters, the AdaIN projections
  and the style MLP are float32, so their outputs promote to float32 and the
  next convolution casts back;
* the style encoder's 1x1 head is float32 (Flax's ``Dense`` without a
  ``dtype`` promotes the bfloat16 pooled features).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from rgie_tpu_torch.config import MunitGenConfig
from rgie_tpu_torch.models.init import freeze_


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d(affine=False) on NCHW: normalize over (H, W) per channel
    with the biased variance, in ``x``'s type."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), correction=0, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    """(C,) or (B, C) -> broadcastable against NCHW."""
    return v[..., None, None]


class InstanceNorm(nn.Module):
    """InstanceNorm2d(affine=True), imaginaire's 'instance' norm
    (activation_norm.py:590-592): keys ``weight``, ``bias``."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(x, self.eps) * _per_channel(self.weight) + _per_channel(self.bias)


class LinearBlock(nn.Module):
    """imaginaire LinearBlock: ``layers.conv`` is the linear layer, then an
    optional ReLU. Always float32."""

    def __init__(self, in_features: int, out_features: int, activation: str = "relu"):
        super().__init__()
        self.layers = nn.ModuleDict({"conv": nn.Linear(in_features, out_features)})
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.layers["conv"](x)
        return F.relu(x) if self.activation == "relu" else x


class AdaIN(nn.Module):
    """Adaptive instance norm (imaginaire AdaptiveNorm, activation_norm.py:
    20-129): instance_norm(x) * (1 + gamma) + beta, (gamma, beta) =
    fc(style).chunk(2), fc in float32."""

    def __init__(self, channels: int, style_dim: int):
        super().__init__()
        self.fc = LinearBlock(style_dim, channels * 2, activation="none")

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        gamma, beta = self.fc(style).chunk(2, dim=-1)
        return instance_norm(x) * (1.0 + _per_channel(gamma)) + _per_channel(beta)


class ConvBlock(nn.Module):
    """imaginaire Conv2dBlock: reflect pad + conv, norm and activation in the
    order of ``order`` (conv.py:104-117). ``norm`` is none, instance or
    adaptive (``style_dim`` wide conditioning)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, stride: int = 1,
                 pad: int = 0, order: str = "CNA", norm: str = "none",
                 activation: str = "relu", style_dim: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pad, self.order, self.norm, self.activation = pad, order, norm, activation
        conv = nn.Conv2d(in_channels, out_channels, kernel, stride).to(dtype)
        self.layers = nn.ModuleDict({"conv": conv})
        norm_channels = in_channels if order.index("N") < order.index("C") else out_channels
        if norm == "instance":
            self.layers["norm"] = InstanceNorm(norm_channels)
        elif norm == "adaptive":
            self.layers["norm"] = AdaIN(norm_channels, style_dim)

    def forward(self, x: torch.Tensor, style: Optional[torch.Tensor] = None) -> torch.Tensor:
        for op in self.order:
            if op == "C":
                if self.pad:
                    x = F.pad(x, (self.pad,) * 4, mode="reflect")
                conv = self.layers["conv"]
                x = conv(x.to(conv.weight.dtype))
            elif op == "N" and self.norm == "instance":
                x = self.layers["norm"](x)
            elif op == "N" and self.norm == "adaptive":
                x = self.layers["norm"](x, style)
            elif op == "A" and self.activation == "relu":
                x = F.relu(x)
            elif op == "A" and self.activation == "tanh":
                x = torch.tanh(x)
        return x


class ResBlock(nn.Module):
    """Two 3x3 conv blocks and the identity shortcut (imaginaire
    _BaseResBlock, residual.py:18-264); ``order`` 'NACNAC' is pre-activation
    (the shipped config), 'CNACNA' post."""

    def __init__(self, channels: int, order: str = "NACNAC", norm: str = "instance",
                 style_dim: Optional[int] = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv_block_0 = ConvBlock(channels, channels, 3, 1, 1, order[0:3], norm, "relu",
                                      style_dim, dtype)
        self.conv_block_1 = ConvBlock(channels, channels, 3, 1, 1, order[3:6], norm, "relu",
                                      style_dim, dtype)

    def forward(self, x: torch.Tensor, style: Optional[torch.Tensor] = None) -> torch.Tensor:
        return x + self.conv_block_1(self.conv_block_0(x, style), style)


class StyleEncoder(nn.Module):
    """NCHW image -> (B, latent_dim) style code (munit.py:294-339):
    ``model`` = conv blocks, global average pool, plain 1x1 conv."""

    def __init__(self, cfg: MunitGenConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        nf = cfg.num_filters
        blocks = [ConvBlock(cfg.num_image_channels, nf, 7, 1, 3, dtype=dtype)]
        for _ in range(2):
            blocks.append(ConvBlock(nf, nf * 2, 4, 2, 1, dtype=dtype))
            nf *= 2
        for _ in range(cfg.num_downsamples_style - 2):
            blocks.append(ConvBlock(nf, nf, 4, 2, 1, dtype=dtype))
        blocks += [nn.AdaptiveAvgPool2d(1), nn.Conv2d(nf, cfg.latent_dim, 1)]
        self.model = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.model[:-1]:
            x = block(x)
        head = self.model[-1]
        return head(x.to(head.weight.dtype)).flatten(1)


class ContentEncoder(nn.Module):
    """NCHW image -> NCHW content code at 1 / 2^d the size (unit.py:166-238)."""

    def __init__(self, cfg: MunitGenConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        order = "NACNAC" if cfg.pre_act else "CNACNA"
        nf = cfg.num_filters
        blocks = [ConvBlock(cfg.num_image_channels, nf, 7, 1, 3, norm="instance", dtype=dtype)]
        for _ in range(cfg.num_downsamples_content):
            nf_next = min(nf * 2, cfg.max_num_filters)
            blocks.append(ConvBlock(nf, nf_next, 4, 2, 1, norm="instance", dtype=dtype))
            nf = nf_next
        blocks += [ResBlock(nf, order, "instance", dtype=dtype) for _ in range(cfg.num_res_blocks)]
        self.model = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.model:
            x = block(x)
        return x


class StyleMLP(nn.Module):
    """Style code -> AdaIN conditioning vector (munit.py:430-465), float32."""

    def __init__(self, cfg: MunitGenConfig):
        super().__init__()
        dims = [cfg.latent_dim] + [cfg.num_filters_mlp] * cfg.num_mlp_blocks
        self.model = nn.ModuleList([LinearBlock(dims[i], dims[i + 1])
                                    for i in range(cfg.num_mlp_blocks)])

    def forward(self, style: torch.Tensor) -> torch.Tensor:
        for block in self.model:
            style = block(style)
        return style


def nearest_upsample(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    return F.interpolate(x, scale_factor=factor, mode="nearest")


class Decoder(nn.Module):
    """(NCHW content, mlp(style)) -> NCHW image (munit.py:342-427): AdaIN res
    blocks, nearest-upsample 5x5 conv blocks (AdaIN too), the 7x7 output
    conv in float32. ``decoder`` keeps imaginaire's indices: res blocks, then
    (upsample, conv block) pairs, then the output block at
    num_res_blocks + 2 * num_downsamples + 1, where the JAX package's
    converter reads it (the index before it holds no parameters)."""

    def __init__(self, cfg: MunitGenConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        order = "NACNAC" if cfg.pre_act else "CNACNA"
        nf = min(cfg.num_filters * 2 ** cfg.num_downsamples_content, cfg.max_num_filters)
        style_dim = cfg.num_filters_mlp
        blocks = [ResBlock(nf, order, "adaptive", style_dim, dtype)
                  for _ in range(cfg.num_res_blocks)]
        for _ in range(cfg.num_downsamples_content):
            blocks += [nn.Upsample(scale_factor=2, mode="nearest"),
                       ConvBlock(nf, nf // 2, 5, 1, 2, norm="adaptive", style_dim=style_dim,
                                 dtype=dtype)]
            nf //= 2
        blocks += [nn.Identity(),
                   ConvBlock(nf, cfg.num_image_channels, 7, 1, 3, activation="none")]
        self.decoder = nn.ModuleList(blocks)

    def forward(self, content: torch.Tensor, style_vec: torch.Tensor) -> torch.Tensor:
        x = content
        for block in self.decoder:
            if isinstance(block, (ResBlock, ConvBlock)):
                x = block(x, style_vec)
            elif isinstance(block, nn.Upsample):
                x = nearest_upsample(x, 2)
        return x


class AutoEncoder(nn.Module):
    """One MUNIT domain (munit.py:159-291): ``encode`` NHWC images to (NHWC
    content, (B, latent_dim) style), ``decode`` them back."""

    def __init__(self, cfg: MunitGenConfig = MunitGenConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.style_encoder = StyleEncoder(cfg, dtype)
        self.content_encoder = ContentEncoder(cfg, dtype)
        self.decoder = Decoder(cfg, dtype)
        self.mlp = StyleMLP(cfg)

    def encode_content(self, images: torch.Tensor) -> torch.Tensor:
        """The content code alone (what the edit's reconstruction term reads)."""
        return self.content_encoder(images.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def encode_style(self, images: torch.Tensor) -> torch.Tensor:
        return self.style_encoder(images.permute(0, 3, 1, 2))

    def encode(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.encode_content(images), self.encode_style(images)

    def decode(self, content: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        out = self.decoder(content.permute(0, 3, 1, 2), self.mlp(style))
        return out.permute(0, 2, 3, 1)


class MunitGenerator(nn.Module):
    """imaginaire's ``net_G``: one autoencoder per domain (munit.py:16-27).
    The edit only uses domain a (optimize_image_imaginaire.py:114,126)."""

    def __init__(self, cfg: MunitGenConfig = MunitGenConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.autoencoder_a = AutoEncoder(cfg, dtype)
        self.autoencoder_b = AutoEncoder(cfg, dtype)

    def encode_a(self, images):
        return self.autoencoder_a.encode(images)

    def decode_a(self, content, style):
        return self.autoencoder_a.decode(content, style)

    def encode_b(self, images):
        return self.autoencoder_b.encode(images)

    def decode_b(self, content, style):
        return self.autoencoder_b.decode(content, style)


@torch.no_grad()
def orthogonal_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """imaginaire's trainer init (yaml:37-39), as the JAX package draws it:
    orthogonal kernels (over the fan-in), zero biases, unit norm scales.
    Drawn in float32 and rounded to each weight's type."""
    for name, p in module.named_parameters():
        if p.ndim >= 2:
            w = torch.empty(p.shape, dtype=torch.float32)
            p.copy_(nn.init.orthogonal_(w, generator=generator))
        elif name.endswith("bias"):
            p.zero_()
    return module


def create_generator(generator: torch.Generator, cfg: MunitGenConfig = MunitGenConfig(),
                     image_size: int = 64, dtype: torch.dtype = torch.float32) -> MunitGenerator:
    """Random-weight frozen generator on the CPU (the real
    ``imaginaire_munit_200000_s5.pt`` loads through ``utils.checkpoint``).
    ``image_size`` is the JAX signature's: Flax needs an example input to
    make its parameters, torch does not."""
    del image_size
    return freeze_(orthogonal_init_(MunitGenerator(cfg, dtype), generator))
