"""Conditional diffusion UNet for the SD family. Port of
``rgie_tpu/diffusion/unet.py``.

Parameter names follow diffusers' ``UNet2DConditionModel`` (with
``use_linear_projection=True``), so a real checkpoint's state dict loads
directly; ``utils/from_jax.unet_state_dict`` carries the JAX package's tree
over. Public tensors are NHWC as in the JAX package (``sample`` ``(B, h, w,
4)``, the returned ``eps`` and mid-block features); inside, the convolutions
run NCHW.

The UNet RETURNS the mid-block activations as a second output: the midu
guidance classifier reads them, and the gradient with respect to the latents
flows through them for classifier guidance.

Self-attention over 8192 and more positions goes through the flash-attention
kernels (``ops/kernels/flash_attention.py``); everything else (the 77-key
cross-attention, the shorter levels) is matmul, float32 softmax, matmul.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from rgie_tpu_torch.ops.kernels.flash_attention import flash_attention, flash_self_attention_ok
from rgie_tpu_torch.utils.spans import attention_span


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    down_block_types: Tuple[str, ...] = ("CrossAttnDownBlock2D",) * 3 + ("DownBlock2D",)
    up_block_types: Tuple[str, ...] = ("UpBlock2D",) + ("CrossAttnUpBlock2D",) * 3
    layers_per_block: int = 2
    transformer_layers_per_block: Tuple[int, ...] = (1, 1, 1, 1)
    attention_head_dim: Tuple[int, ...] = (5, 10, 20, 20)
    cross_attention_dim: int = 1024
    addition_embed_type: Optional[str] = None      # None | "text_time" (SDXL)
    addition_time_embed_dim: int = 256
    addition_pooled_dim: int = 1280                # pooled text-embed width
    projection_class_embeddings_input_dim: int = 2816
    norm_num_groups: int = 32

    @staticmethod
    def sd21() -> "UNetConfig":
        """stabilityai/stable-diffusion-2-1-base (also sd-turbo)."""
        return UNetConfig()

    @staticmethod
    def sdxl() -> "UNetConfig":
        """stabilityai/stable-diffusion-xl-base-1.0."""
        return UNetConfig(
            block_out_channels=(320, 640, 1280),
            down_block_types=("DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"),
            up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"),
            transformer_layers_per_block=(1, 2, 10),
            attention_head_dim=(5, 10, 20),
            cross_attention_dim=2048,
            addition_embed_type="text_time",
        )

    @staticmethod
    def tiny(cross_dim: int = 32) -> "UNetConfig":
        """Test-size config with the SD block structure."""
        return UNetConfig(
            block_out_channels=(8, 16),
            down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
            up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
            layers_per_block=1,
            transformer_layers_per_block=(1, 1),
            attention_head_dim=(2, 2),
            cross_attention_dim=cross_dim,
            norm_num_groups=4,
        )

    @staticmethod
    def tiny_xl(cross_dim: int = 32) -> "UNetConfig":
        """Test-size config with the SDXL block structure + added text_time
        conditioning (pooled embeds + 6 micro-conditioning time ids)."""
        return dataclasses.replace(
            UNetConfig.tiny(cross_dim),
            addition_embed_type="text_time",
            addition_time_embed_dim=8,
            addition_pooled_dim=16,
        )


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: float = 10000.0,
                       flip_sin_to_cos: bool = True, downscale_freq_shift: float = 0.0
                       ) -> torch.Tensor:
    """Sinusoidal embedding, diffusers convention (Timesteps module): float32,
    cosines first."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                    device=timesteps.device)
    exponent = exponent / (half - downscale_freq_shift)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    sin, cos = torch.sin(emb), torch.cos(emb)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


class GroupNorm32(nn.GroupNorm):
    """GroupNorm (NCHW) with float32 statistics whatever the activation type.
    ``eps`` follows diffusers: 1e-5 for UNet resnets and ``conv_norm_out``,
    1e-6 for Transformer2D's input norm and everything inside the VAE."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float(), self.num_groups, self.weight.float(), self.bias.float(),
                         self.eps)
        return y.to(x.dtype)


class Float32Conv2d(nn.Conv2d):
    """A convolution that runs in float32 whatever the type of its weights and
    input (the output convolutions of the UNet and the VAE decoder)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x.float(), self.weight.float(), self.bias.float(), self.stride,
                        self.padding, self.dilation, self.groups)


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, temb_dim: int, groups: int = 32):
        super().__init__()
        self.norm1 = GroupNorm32(groups, in_channels, eps=1e-5)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_dim, out_channels)
        self.norm2 = GroupNorm32(groups, out_channels, eps=1e-5)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.conv_shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class CrossAttention(nn.Module):
    def __init__(self, query_dim: int, context_dim: int, heads: int, dim_head: int):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        context = x if context is None else context
        b, n, _ = x.shape
        m = context.shape[1]
        q = self.to_q(x).view(b, n, self.heads, self.dim_head)
        k = self.to_k(context).view(b, m, self.heads, self.dim_head)
        v = self.to_v(context).view(b, m, self.heads, self.dim_head)
        flash = flash_self_attention_ok(n, m, self.dim_head)
        with attention_span("k2" if flash else "matmul", q.dtype, b, self.heads, n, m,
                            self.dim_head):
            if flash:
                # The kernels read the (b, n, heads, d) projections in place
                # and write their result in the same layout: no transposed
                # copies.
                out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                      sm_scale=1.0 / math.sqrt(self.dim_head))
                out = out.transpose(1, 2).reshape(b, n, -1)
            else:
                attn = torch.matmul(q.permute(0, 2, 1, 3), k.permute(0, 2, 3, 1))
                attn = attn / math.sqrt(self.dim_head)
                attn = torch.softmax(attn.float(), dim=-1).to(q.dtype)
                out = torch.matmul(attn, v.permute(0, 2, 1, 3)).permute(0, 2, 1, 3)
                out = out.reshape(b, n, -1)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Linear(dim, dim * 8)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, gate = self.proj(x).chunk(2, dim=-1)
        # diffusers GEGLU uses exact (erf) gelu, not the tanh approximation.
        return a * F.gelu(gate)


class FeedForwardGEGLU(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim), nn.Identity(), nn.Linear(dim * 4, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, context_dim: int, heads: int, dim_head: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = CrossAttention(dim, dim, heads, dim_head)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForwardGEGLU(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    def __init__(self, channels: int, context_dim: int, heads: int, dim_head: int, depth: int,
                 groups: int = 32):
        super().__init__()
        self.norm = GroupNorm32(groups, channels, eps=1e-6)
        self.proj_in = nn.Linear(channels, channels)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(channels, context_dim, heads, dim_head) for _ in range(depth)])
        self.proj_out = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        y = self.proj_in(y)
        for block in self.transformer_blocks:
            y = block(y, context)
        y = self.proj_out(y)
        return y.reshape(b, h, w, c).permute(0, 3, 1, 2) + x


class Downsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample(nn.Module):
    """Nearest x2 by repetition, then a 3x3 convolution."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        return self.conv(x)


class _Block(nn.Module):
    """Container with diffusers' child names for a down, mid or up block."""

    def __init__(self, resnets, attentions=None, downsamplers=None, upsamplers=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        if downsamplers:
            self.downsamplers = nn.ModuleList(downsamplers)
        if upsamplers:
            self.upsamplers = nn.ModuleList(upsamplers)

    def pairs(self):
        attns = list(getattr(self, "attentions", [])) or [None] * len(self.resnets)
        return zip(self.resnets, attns)


class _TimeEmbedding(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(x)))


class UNet2DCondition(nn.Module):
    """Returns (eps_prediction, mid_block_features), both NHWC.

    ``block_remat=True`` recomputes each ResnetBlock / Transformer2D on the
    backward pass (``torch.utils.checkpoint`` per block): the backward then
    holds the block-boundary activations plus ONE block's intermediates at a
    time. It is the memory lever of the differentiated paths (the null-text
    inner loss, classifier guidance); parameter names do not change."""

    def __init__(self, cfg: UNetConfig = UNetConfig(), block_remat: bool = False):
        super().__init__()
        self.cfg, self.block_remat = cfg, block_remat
        ch0 = cfg.block_out_channels[0]
        temb_dim = ch0 * 4
        g, ctx = cfg.norm_num_groups, cfg.cross_attention_dim
        n = len(cfg.block_out_channels)
        self.conv_in = nn.Conv2d(cfg.in_channels, ch0, 3, padding=1)
        self.time_embedding = _TimeEmbedding(ch0, temb_dim)
        if cfg.addition_embed_type == "text_time":
            self.add_embedding = _TimeEmbedding(
                cfg.addition_pooled_dim + 6 * cfg.addition_time_embed_dim, temb_dim)

        # diffusers SD2.x/SDXL configs name per-block HEAD COUNTS in
        # `attention_head_dim` (5/10/20 heads -> 64-wide heads at 320/640/1280
        # channels); the tiny test configs follow suit.
        self.down_blocks = nn.ModuleList()
        in_ch = ch0
        skip_chs = [ch0]
        for bi, (btype, out_ch) in enumerate(zip(cfg.down_block_types, cfg.block_out_channels)):
            heads = cfg.attention_head_dim[bi]
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block):
                resnets.append(ResnetBlock(in_ch, out_ch, temb_dim, g))
                in_ch = out_ch
                skip_chs.append(out_ch)
                if btype == "CrossAttnDownBlock2D":
                    attns.append(Transformer2D(out_ch, ctx, heads, out_ch // heads,
                                               cfg.transformer_layers_per_block[bi], g))
            downs = None
            if bi < n - 1:
                downs = [Downsample(out_ch)]
                skip_chs.append(out_ch)
            self.down_blocks.append(_Block(resnets, attns, downsamplers=downs))

        mid_ch = cfg.block_out_channels[-1]
        heads = cfg.attention_head_dim[-1]
        self.mid_block = _Block(
            [ResnetBlock(mid_ch, mid_ch, temb_dim, g), ResnetBlock(mid_ch, mid_ch, temb_dim, g)],
            [Transformer2D(mid_ch, ctx, heads, mid_ch // heads,
                           cfg.transformer_layers_per_block[-1], g)])

        rev_channels = tuple(reversed(cfg.block_out_channels))
        rev_heads = tuple(reversed(cfg.attention_head_dim))
        rev_tf = tuple(reversed(cfg.transformer_layers_per_block))
        self.up_blocks = nn.ModuleList()
        x_ch = mid_ch
        for bi, (btype, out_ch) in enumerate(zip(cfg.up_block_types, rev_channels)):
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(ResnetBlock(x_ch + skip_chs.pop(), out_ch, temb_dim, g))
                x_ch = out_ch
                if btype == "CrossAttnUpBlock2D":
                    attns.append(Transformer2D(out_ch, ctx, rev_heads[bi], out_ch // rev_heads[bi],
                                               rev_tf[bi], g))
            ups = [Upsample(out_ch)] if bi < n - 1 else None
            self.up_blocks.append(_Block(resnets, attns, upsamplers=ups))

        self.conv_norm_out = GroupNorm32(g, ch0, eps=1e-5)
        self.conv_out = Float32Conv2d(ch0, cfg.out_channels, 3, padding=1)

    @property
    def dtype(self) -> torch.dtype:
        return self.conv_in.weight.dtype

    def _run(self, block: nn.Module, x: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
        if self.block_remat and torch.is_grad_enabled():
            return checkpoint(block, x, other, use_reentrant=False)
        return block(x, other)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor,
                added_text_embeds: Optional[torch.Tensor] = None,
                added_time_ids: Optional[torch.Tensor] = None,
                down_residuals: Optional[Sequence[torch.Tensor]] = None,
                mid_residual: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg, dtype = self.cfg, self.dtype
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(sample.shape[0])

        temb = timestep_embedding(timesteps, cfg.block_out_channels[0])
        temb = self.time_embedding(temb.to(dtype))
        # SDXL added conditioning (text_embeds + time_ids -> temb add).
        if cfg.addition_embed_type == "text_time":
            tids = timestep_embedding(added_time_ids.reshape(-1), cfg.addition_time_embed_dim)
            tids = tids.reshape(sample.shape[0], -1)
            add = torch.cat([added_text_embeds.to(dtype), tids.to(dtype)], dim=-1)
            temb = temb + self.add_embedding(add)

        context = encoder_hidden_states.to(dtype)
        x = self.conv_in(sample.to(dtype).permute(0, 3, 1, 2))

        skips = [x]
        for block in self.down_blocks:
            for res, attn in block.pairs():
                x = self._run(res, x, temb)
                if attn is not None:
                    x = self._run(attn, x, context)
                skips.append(x)
            if hasattr(block, "downsamplers"):
                x = block.downsamplers[0](x)
                skips.append(x)

        # Mid block (the tap the midu classifier reads).
        x = self._run(self.mid_block.resnets[0], x, temb)
        x = self._run(self.mid_block.attentions[0], x, context)
        x = self._run(self.mid_block.resnets[1], x, temb)
        # ControlNet residuals (diffusers ControlNetModel semantics: one
        # residual per skip entry, added where the up path consumes them, plus
        # one on the mid-block output), NHWC like every public tensor. The
        # guidance tap sees the control-conditioned mid features.
        if mid_residual is not None:
            x = x + mid_residual.permute(0, 3, 1, 2)
        if down_residuals is not None:
            skips = [s + r.permute(0, 3, 1, 2) for s, r in zip(skips, down_residuals)]
        mid_features = x.permute(0, 2, 3, 1)

        for block in self.up_blocks:
            for res, attn in block.pairs():
                x = self._run(res, torch.cat([x, skips.pop()], dim=1), temb)
                if attn is not None:
                    x = self._run(attn, x, context)
            if hasattr(block, "upsamplers"):
                x = block.upsamplers[0](x)

        # conv_out runs in float32 whatever the working type.
        x = self.conv_out(F.silu(self.conv_norm_out(x)))
        return x.permute(0, 2, 3, 1), mid_features


def create_unet(generator: torch.Generator, cfg: UNetConfig = UNetConfig.tiny(),
                dtype: torch.dtype = torch.float32, block_remat: bool = False
                ) -> UNet2DCondition:
    """A frozen random-weight UNet on the CPU, drawn from ``generator``."""
    from rgie_tpu_torch.models.init import freeze_, random_init_

    model = random_init_(UNet2DCondition(cfg, block_remat=block_remat), generator)
    return freeze_(model.to(dtype))
