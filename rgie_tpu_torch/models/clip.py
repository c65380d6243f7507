"""CLIP ViT image encoder with OpenAI-CLIP parameter names. Port of the visual
half of ``rgie_tpu/models/clip.py`` (reference: optimize_image.py:151-183
uses ``clip.load("ViT-B/32")`` for its reconstruction loss).

Attention is written out (scaled QK^T, softmax, V) with the parameter names
of ``nn.MultiheadAttention`` (``in_proj_weight``, ``in_proj_bias``,
``out_proj``), so OpenAI state dicts load and the numerics follow Flax's
``MultiHeadDotProductAttention``. The text tower comes with the diffusion
slice.

``dtype`` is Flax's compute type, as in the JAX package: the patch kernel,
the class and positional embeddings, the projection and every dense layer
hold their weights rounded once to it; the LayerNorms keep float32
parameters, normalize in float32 and return ``dtype``. The float32 patch
product and the embedding sums follow JAX's type promotion.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn as nn
import torch.nn.functional as F

from rgie_tpu_torch.models.init import freeze_, random_init_
from rgie_tpu_torch.ops import geometry as G


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class QuickGELU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return quick_gelu(x)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` (eps 1e-5) as Flax's ``LayerNorm(dtype=...)``:
    statistics and affine in float32, the result in ``compute_dtype``."""

    def __init__(self, width: int, compute_dtype: torch.dtype = torch.float32):
        super().__init__(width, eps=1e-5)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(self.compute_dtype)


class SelfAttention(nn.Module):
    """Multi-head self-attention with ``nn.MultiheadAttention``'s names."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, w = x.shape
        d = w // self.heads
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = qkv.reshape(b, n, 3, self.heads, d).permute(2, 0, 3, 1, 4)
        attn = torch.softmax((q / d ** 0.5) @ k.transpose(-1, -2), dim=-1)
        y = (attn @ v).transpose(1, 2).reshape(b, n, w)
        return self.out_proj(y)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ln_1 = LayerNorm(width, dtype)
        self.attn = SelfAttention(width, heads)
        self.ln_2 = LayerNorm(width, dtype)
        self.mlp = nn.Sequential(OrderedDict([
            ("c_fc", nn.Linear(width, width * 4)),
            ("gelu", QuickGELU()),
            ("c_proj", nn.Linear(width * 4, width)),
        ]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.resblocks = nn.ModuleList(
            [ResidualAttentionBlock(width, heads, dtype) for _ in range(layers)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.resblocks:
            x = block(x)
        return x


class VisionTransformer(nn.Module):
    """CLIP visual tower. ViT-B/32: width 768, layers 12, heads 12, patch 32,
    input 224, output_dim 512. Takes NHWC, already CLIP-normalized."""

    def __init__(self, width: int = 768, layers: int = 12, heads: int = 12,
                 patch_size: int = 32, input_resolution: int = 224,
                 output_dim: int = 512, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.input_resolution = input_resolution
        self.conv1 = nn.Conv2d(3, width, patch_size, patch_size, bias=False)
        n_tok = (input_resolution // patch_size) ** 2 + 1
        self.class_embedding = nn.Parameter(torch.zeros(width))
        self.positional_embedding = nn.Parameter(torch.zeros(n_tok, width))
        self.ln_pre = LayerNorm(width, dtype)
        self.transformer = Transformer(width, layers, heads, dtype)
        self.ln_post = LayerNorm(width, dtype)
        self.proj = nn.Parameter(torch.zeros(width, output_dim))
        for m in self.modules():
            if not isinstance(m, nn.LayerNorm):
                for p in m.parameters(recurse=False):
                    p.data = p.data.to(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # The patch product in the promoted type (float32 for a float32 image
        # and a bfloat16 kernel), as JAX promotes ``patches @ kernel``.
        kernel = self.conv1.weight
        ptype = torch.promote_types(x.dtype, kernel.dtype)
        x = F.conv2d(x.permute(0, 3, 1, 2).to(ptype), kernel.to(ptype),
                     stride=self.conv1.stride)            # (B, width, grid, grid)
        x = x.flatten(2).transpose(1, 2)                 # (B, grid*grid, width)
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        x = torch.cat([cls.to(x.dtype), x], dim=1) + self.positional_embedding
        x = self.transformer(self.ln_pre(x))
        return self.ln_post(x[:, 0, :]) @ self.proj


class ClipImageEncoder(nn.Module):
    """Frozen CLIP image tower with the reference's 0.5-normalization
    (optimize_image.py:155-165 uses Normalize(0.5, 0.5), not CLIP's
    mean/std) after a non-antialiased bilinear resize."""

    def __init__(self, model: VisionTransformer):
        super().__init__()
        self.model = model

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) in [0, 1] -> (B, output_dim)."""
        res = self.model.input_resolution
        x = G.resize(images, (res, res), antialias=False)
        return self.model((x - 0.5) / 0.5)

    def embed_normalized(self, images: torch.Tensor) -> torch.Tensor:
        feats = self(images)
        return feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True)


def create_clip_image_encoder(generator: torch.Generator, dtype: torch.dtype = torch.float32,
                              **kw) -> ClipImageEncoder:
    """Random-weight frozen encoder (Flax's initializers: embeddings N(0,
    0.02), projection N(0, width^-0.5)), on the CPU, computing in ``dtype``
    (the float32 draws rounded once to it)."""
    model = VisionTransformer(dtype=dtype, **kw)
    width = model.class_embedding.shape[0]
    random_init_(model, generator, stds={"class_embedding": 0.02,
                                         "positional_embedding": 0.02,
                                         "proj": width ** -0.5})
    return freeze_(ClipImageEncoder(model))


def clip_loss(encoder: ClipImageEncoder, image1_features_normed: torch.Tensor,
              image2: torch.Tensor) -> torch.Tensor:
    """1 - cosine(e1, e2), one loss per image: (B,). The original image's
    features are computed once per edit (the reference re-encodes the
    constant original every step)."""
    f2 = encoder.embed_normalized(image2)
    return 1.0 - torch.sum(image1_features_normed * f2, dim=-1)
