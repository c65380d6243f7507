"""Extended GAN layer library on PyTorch (port of ``rgie_tpu/models/layers.py``):
the layers of the vendored imaginaire zoo beyond what MUNIT itself uses
(``src/external/imaginaire/layers/``). Nothing in either package calls them
yet; they are kept for the reference's other generators.

  * NonLocal2dBlock   self-attention over H*W tokens (non_local.py:13-88)
  * ModulatedConv2d   StyleGAN2 weight modulation/demodulation (conv.py:208-378),
                      as input scaling + output demodulation: one convolution
                      for the batch instead of per-sample grouped kernels
  * PartialConv2d     mask-aware convolution (conv.py:890-1368)
  * HyperConv2d       convolution with per-sample weights given as input
                      (conv.py:695-887)
  * ApplyNoise, ConstantInput, pixel_norm (misc.py, activation_norm.py)
  * UnitDecoder, UnitAutoEncoder: the style-free UNIT autoencoder
    (generators/unit.py:13-312), on ``models/munit.py``'s blocks
  * LayerNorm2d, ScaleNorm, SpatiallyAdaptiveNorm (SPADE), EqualizedDense,
    ConvNdBlock, ResNdBlock, EmbeddingBlock

Like the JAX package's, every layer takes and returns channels-last tensors
(NHWC, or (B, *spatial, C)); the convolutions run on channels-first views.
Submodules and parameters carry Flax's names, so
``utils.from_jax.layer_state_dict`` (and ``unit_autoencoder_state_dict``)
move a JAX layer's weights here with ``strict=True``. Unlike Flax, a torch
layer is told its input widths when it is made.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from rgie_tpu_torch.config import MunitGenConfig
from rgie_tpu_torch.models.munit import (ContentEncoder, ConvBlock, ResBlock, instance_norm,
                                         nearest_upsample)


def _cf(x: torch.Tensor) -> torch.Tensor:
    """Channels-last -> channels-first."""
    return x.movedim(-1, 1)


def _cl(x: torch.Tensor) -> torch.Tensor:
    """Channels-first -> channels-last."""
    return x.movedim(1, -1)


class NonLocal2dBlock(nn.Module):
    """Self-attention block (non_local.py:13-88): theta/phi/g 1x1 convs,
    attention over the HW tokens with 2x2-max-pooled keys and values, a
    learnable residual gain (zero at init)."""

    def __init__(self, channels: int, scale: bool = True):
        super().__init__()
        ic = max(1, channels // 2)
        self.scale = scale
        self.theta = nn.Conv2d(channels, ic, 1, bias=False)
        self.phi = nn.Conv2d(channels, ic, 1, bias=False)
        self.g = nn.Conv2d(channels, ic, 1, bias=False)
        self.out_conv = nn.Conv2d(ic, channels, 1, bias=False)
        self.gamma = nn.Parameter(torch.zeros(()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        xc = _cf(x)
        theta = self.theta(xc).flatten(2).transpose(1, 2)                 # (B, HW, ic)
        phi = F.max_pool2d(self.phi(xc), 2).flatten(2)                      # (B, ic, M)
        g = F.max_pool2d(self.g(xc), 2).flatten(2).transpose(1, 2)          # (B, M, ic)
        attn = torch.softmax(theta @ phi, dim=-1)
        out = (attn @ g).transpose(1, 2).reshape(b, -1, h, w)
        out = _cl(self.out_conv(out))
        return x + self.gamma * out if self.scale else x + out


class ModulatedConv2d(nn.Module):
    """StyleGAN2 modulated convolution (conv.py:208-378): the kernel scaled
    per sample by a projection of the style, optionally demodulated; done as
    input scaling, one convolution, output demodulation."""

    def __init__(self, in_channels: int, features: int, style_dim: int, kernel: int = 3,
                 demodulate: bool = True, eps: float = 1e-8):
        super().__init__()
        self.demodulate, self.eps = demodulate, eps
        self.modulation = nn.Linear(style_dim, in_channels)
        nn.init.ones_(self.modulation.bias)
        self.weight = nn.Parameter(torch.randn(features, in_channels, kernel, kernel)
                                   / (in_channels * kernel * kernel) ** 0.5)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        s = self.modulation(style)                                          # (B, C_in)
        y = F.conv2d(_cf(x * s[:, None, None, :]), self.weight,
                     padding=self.weight.shape[-1] // 2)
        if self.demodulate:
            # sigma_o = sqrt(sum_{i,k} (w_{o,i,k} * s_i)^2)
            w2 = torch.einsum("oihw,bi->bo", self.weight ** 2, s ** 2)
            y = y * torch.rsqrt(w2 + self.eps)[:, :, None, None]
        return _cl(y) + self.bias


class PartialConv2d(nn.Module):
    """Mask-aware convolution (conv.py:890-1368): convolve x * mask, rescale by
    the window's valid fraction, propagate the grown mask."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3, stride: int = 1):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        self.conv = nn.Conv2d(in_channels, features, kernel, stride, padding=kernel // 2,
                              bias=False)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if mask is None:
            mask = torch.ones(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
        y = _cl(self.conv(_cf(x * mask)))
        ones = torch.ones((1, 1, self.kernel, self.kernel), dtype=x.dtype, device=x.device)
        mask_sum = _cl(F.conv2d(_cf(mask), ones, stride=self.stride, padding=self.kernel // 2))
        ratio = torch.where(mask_sum > 0, self.kernel * self.kernel / mask_sum.clamp_min(1e-8),
                            torch.zeros_like(mask_sum))
        return y * ratio + self.bias, (mask_sum > 0).to(x.dtype)


class HyperConv2d(nn.Module):
    """Convolution whose weights arrive as an input (conv.py:695-887):
    weights (B, kh, kw, C_in, C_out) and optional bias (B, C_out), applied per
    sample (one grouped convolution over the batch)."""

    def __init__(self, kernel: int = 3, stride: int = 1):
        super().__init__()
        self.kernel, self.stride = kernel, stride

    def forward(self, x: torch.Tensor, weights: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, h, w, c_in = x.shape
        c_out = weights.shape[-1]
        kernels = weights.permute(0, 4, 3, 1, 2).reshape(b * c_out, c_in, *weights.shape[1:3])
        y = F.conv2d(_cf(x).reshape(1, b * c_in, h, w), kernels, stride=self.stride,
                     padding=self.kernel // 2, groups=b)
        y = _cl(y.reshape(b, c_out, *y.shape[2:]))
        return y if bias is None else y + bias[:, None, None, :]


class ApplyNoise(nn.Module):
    """Gaussian noise injection with a learnable magnitude (misc.py:9-30),
    zero at init. The noise is given, or drawn from ``generator`` (one value
    per pixel, shared over the channels); with neither, the input passes."""

    def __init__(self):
        super().__init__()
        self.scale = nn.Parameter(torch.zeros(()))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        if noise is None:
            if generator is None:
                return x
            noise = torch.randn(x.shape[:-1] + (1,), generator=generator, dtype=x.dtype,
                                device=generator.device).to(x.device)
        return x + self.scale * noise


class ConstantInput(nn.Module):
    """A learned constant input (misc.py:51-61): (batch, size, size, C)."""

    def __init__(self, channels: int, size: int = 4):
        super().__init__()
        self.const = nn.Parameter(torch.randn(1, size, size, channels))

    def forward(self, batch: int) -> torch.Tensor:
        return self.const.expand(batch, -1, -1, -1)


def pixel_norm(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """PixelNorm (activation_norm.py:474-525): normalize along the channels."""
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)


class UnitDecoder(nn.Module):
    """Style-free UNIT decoder (generators/unit.py:241-312): instance-norm res
    blocks, then nearest upsampling and 5x5 conv blocks, then the 7x7 output
    conv. Submodules ``res_{i}``, ``up_{i}``, ``out``."""

    def __init__(self, cfg: MunitGenConfig):
        super().__init__()
        order = "NACNAC" if cfg.pre_act else "CNACNA"
        nf = min(cfg.num_filters * 2 ** cfg.num_downsamples_content, cfg.max_num_filters)
        self.num_res, self.num_up = cfg.num_res_blocks, cfg.num_downsamples_content
        for i in range(self.num_res):
            self.add_module(f"res_{i}", ResBlock(nf, order, "instance"))
        for i in range(self.num_up):
            self.add_module(f"up_{i}", ConvBlock(nf, nf // 2, 5, 1, 2, norm="instance"))
            nf //= 2
        self.out = ConvBlock(nf, cfg.num_image_channels, 7, 1, 3, activation="none")

    def forward(self, content: torch.Tensor) -> torch.Tensor:
        x = _cf(content)
        for i in range(self.num_res):
            x = getattr(self, f"res_{i}")(x)
        for i in range(self.num_up):
            x = getattr(self, f"up_{i}")(nearest_upsample(x, 2))
        return _cl(self.out(x))


class UnitAutoEncoder(nn.Module):
    """UNIT autoencoder (generators/unit.py:13-312): MUNIT's content encoder
    and the style-free decoder."""

    def __init__(self, cfg: MunitGenConfig = MunitGenConfig()):
        super().__init__()
        self.content_encoder = ContentEncoder(cfg)
        self.decoder = UnitDecoder(cfg)

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        return _cl(self.content_encoder(_cf(images)))

    def decode(self, content: torch.Tensor) -> torch.Tensor:
        return self.decoder(content)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(images))


class LayerNorm2d(nn.Module):
    """Per-sample layer norm over (H, W, C) with a channel affine
    (activation_norm.py:425-472)."""

    def __init__(self, channels: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=(1, 2, 3), keepdim=True)
        var = x.var(dim=(1, 2, 3), correction=0, keepdim=True)
        return (x - mean) * torch.rsqrt(var + self.epsilon) * self.scale + self.bias


class ScaleNorm(nn.Module):
    """One learned scale over the channel norm (activation_norm.py:474-525)."""

    def __init__(self, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        return x / norm.clamp_min(self.epsilon) * self.scale


class SpatiallyAdaptiveNorm(nn.Module):
    """SPADE (activation_norm.py:132-263): instance norm, then a FiLM whose
    gamma and beta vary in space, computed from a conditioning map resized
    (nearest, half-pixel centers as ``jax.image.resize``) to the activation."""

    def __init__(self, features: int, cond_channels: int, hidden: int = 128, kernel: int = 3):
        super().__init__()
        pad = kernel // 2
        self.mlp_shared = nn.Conv2d(cond_channels, hidden, kernel, padding=pad)
        self.mlp_gamma = nn.Conv2d(hidden, features, kernel, padding=pad)
        self.mlp_beta = nn.Conv2d(hidden, features, kernel, padding=pad)

    def forward(self, x: torch.Tensor, cond_map: torch.Tensor) -> torch.Tensor:
        cm = F.interpolate(_cf(cond_map), size=x.shape[1:3], mode="nearest-exact")
        actv = F.relu(self.mlp_shared(cm))
        gamma, beta = self.mlp_gamma(actv), self.mlp_beta(actv)
        return _cl(instance_norm(_cf(x)) * (1.0 + gamma) + beta)


class EqualizedDense(nn.Module):
    """Equalized-learning-rate linear (weight_norm.py ScaledLR:76-227): unit
    variance at init, the He constant applied at run time."""

    def __init__(self, in_features: int, features: int, lr_mul: float = 1.0):
        super().__init__()
        self.lr_mul = lr_mul
        self.weight = nn.Parameter(torch.randn(features, in_features) / lr_mul)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.lr_mul / self.weight.shape[1] ** 0.5
        return F.linear(x, self.weight * scale, self.bias * self.lr_mul)


_CONVS = {1: nn.Conv1d, 2: nn.Conv2d, 3: nn.Conv3d}


class ConvNdBlock(nn.Module):
    """Dimension-generic reflect-padded conv, optional instance norm and
    activation, the reference's Conv1dBlock/Conv3dBlock (conv.py:489-692);
    ``spatial_dims`` in {1, 2, 3}, inputs (B, *spatial, C)."""

    def __init__(self, in_channels: int, features: int, kernel: int, spatial_dims: int = 2,
                 stride: int = 1, pad: int = 0, norm: str = "none", activation: str = "relu"):
        super().__init__()
        self.nd, self.pad, self.norm, self.activation = spatial_dims, pad, norm, activation
        self.conv = _CONVS[spatial_dims](in_channels, features, kernel, stride)
        if norm == "instance":
            self.norm_scale = nn.Parameter(torch.ones(features))
            self.norm_bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _cf(x)
        if self.pad:
            x = F.pad(x, (self.pad,) * (2 * self.nd), mode="reflect")
        x = _cl(self.conv(x))
        if self.norm == "instance":
            axes = tuple(range(1, 1 + self.nd))
            mean = x.mean(dim=axes, keepdim=True)
            var = x.var(dim=axes, correction=0, keepdim=True)
            x = (x - mean) * torch.rsqrt(var + 1e-5) * self.norm_scale + self.norm_bias
        if self.activation == "relu":
            x = F.relu(x)
        elif self.activation == "tanh":
            x = torch.tanh(x)
        return x


class ResNdBlock(nn.Module):
    """Dimension-generic residual block (Res1dBlock/Res3dBlock,
    residual.py:450-640)."""

    def __init__(self, features: int, spatial_dims: int = 2, norm: str = "instance"):
        super().__init__()
        self.conv_block_0 = ConvNdBlock(features, features, 3, spatial_dims, 1, 1, norm, "relu")
        self.conv_block_1 = ConvNdBlock(features, features, 3, spatial_dims, 1, 1, norm, "none")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv_block_1(self.conv_block_0(x))


class EmbeddingBlock(nn.Module):
    """Embedding and an optional ReLU (conv.py:441-486)."""

    def __init__(self, num_embeddings: int, features: int, activation: str = "none"):
        super().__init__()
        self.activation = activation
        self.embed = nn.Embedding(num_embeddings, features)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        x = self.embed(ids)
        return F.relu(x) if self.activation == "relu" else x
