"""ControlNet for the SD/SDXL UNet: spatially conditioned residuals. Port of
``rgie_tpu/diffusion/controlnet.py``.

Reference: ``src/pipelines/diff_utils.py:47-72`` ships ControlNet pipeline
loaders (canny/depth SD and SDXL variants) that its entry points never call;
the JAX package rebuilds the module for parity, and so does the port. The
architecture is diffusers' ``ControlNetModel``: a copy of the UNet's down and
mid path whose input is the noisy latents plus an embedded control image, and
whose outputs go through zero-initialized 1x1 convolutions, one residual per
UNet skip connection and one for the mid block. The UNet takes them as
``down_residuals`` / ``mid_residual`` (``diffusion/unet.py``).

Parameter names are diffusers' (``controlnet_cond_embedding``,
``controlnet_down_blocks``, ``controlnet_mid_block``, the UNet's own names for
the copied blocks); the conditioning embedding's last convolution is 1x1 as
in the JAX package, where diffusers' is 3x3, so a diffusers ControlNet state
dict differs from this module at that one weight.
``utils/from_jax.controlnet_state_dict`` carries the JAX package's tree over.
Public tensors are NHWC, as the UNet's.

The zero convolutions make the module an exact no-op at initialization (every
residual is zero), so wiring it into a pipeline never perturbs an
unconditioned edit. The ControlNet's self-attention goes through the
flash-attention kernels where the UNet's does (256 positions and more).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from rgie_tpu_torch.diffusion.unet import (Downsample, ResnetBlock, Transformer2D, UNetConfig,
                                           UNet2DCondition, _Block, _TimeEmbedding,
                                           timestep_embedding)


def _zero_conv(channels: int) -> nn.Conv2d:
    return nn.Conv2d(channels, channels, 1)


class ControlNetConditioningEmbedding(nn.Module):
    """Control image (B, H, W, 3) in [0, 1] -> (B, ch0, H/8, W/8) NCHW features
    (diffusers ControlNetConditioningEmbedding: a 16-32-96-256 conv ladder
    with three stride-2 stages, a zero conv out: 1x1 as in the JAX package,
    where diffusers' is 3x3). The ladder shrinks for tiny test configs (ch0 <
    64), as in the JAX package."""

    def __init__(self, ch0: int):
        super().__init__()
        ladder = (16, 32, 96, 256) if ch0 >= 64 else (4, 4, 8, 8)
        self.conv_in = nn.Conv2d(3, ladder[0], 3, padding=1)
        blocks = []
        for cin, cout in zip(ladder[:-1], ladder[1:]):
            blocks += [nn.Conv2d(cin, cin, 3, padding=1),
                       nn.Conv2d(cin, cout, 3, stride=2, padding=1)]
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = nn.Conv2d(ladder[-1], ch0, 1)

    def forward(self, cond: torch.Tensor) -> torch.Tensor:
        x = F.silu(self.conv_in(cond.to(self.conv_in.weight.dtype).permute(0, 3, 1, 2)))
        for conv in self.blocks:
            x = F.silu(conv(x))
        return self.conv_out(x)


class ControlNet(nn.Module):
    """The down and mid path of ``UNet2DCondition`` emitting zero-conv
    residuals. ``forward(sample, timesteps, encoder_hidden_states,
    control_cond, added_*)`` -> (down_residuals: one per UNet skip entry,
    mid_residual), NHWC, scaled by ``conditioning_scale``."""

    def __init__(self, cfg: UNetConfig = UNetConfig(), conditioning_scale: float = 1.0):
        super().__init__()
        self.cfg, self.conditioning_scale = cfg, conditioning_scale
        ch0 = cfg.block_out_channels[0]
        temb_dim = ch0 * 4
        g, ctx = cfg.norm_num_groups, cfg.cross_attention_dim
        n = len(cfg.block_out_channels)
        self.conv_in = nn.Conv2d(cfg.in_channels, ch0, 3, padding=1)
        self.time_embedding = _TimeEmbedding(ch0, temb_dim)
        if cfg.addition_embed_type == "text_time":
            self.add_embedding = _TimeEmbedding(
                cfg.addition_pooled_dim + 6 * cfg.addition_time_embed_dim, temb_dim)
        self.controlnet_cond_embedding = ControlNetConditioningEmbedding(ch0)

        self.down_blocks = nn.ModuleList()
        zero_convs = [_zero_conv(ch0)]
        in_ch = ch0
        for bi, (btype, out_ch) in enumerate(zip(cfg.down_block_types, cfg.block_out_channels)):
            heads = cfg.attention_head_dim[bi]
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block):
                resnets.append(ResnetBlock(in_ch, out_ch, temb_dim, g))
                in_ch = out_ch
                if btype == "CrossAttnDownBlock2D":
                    attns.append(Transformer2D(out_ch, ctx, heads, out_ch // heads,
                                               cfg.transformer_layers_per_block[bi], g))
                zero_convs.append(_zero_conv(out_ch))
            downs = None
            if bi < n - 1:
                downs = [Downsample(out_ch)]
                zero_convs.append(_zero_conv(out_ch))
            self.down_blocks.append(_Block(resnets, attns, downsamplers=downs))
        self.controlnet_down_blocks = nn.ModuleList(zero_convs)

        mid_ch = cfg.block_out_channels[-1]
        heads = cfg.attention_head_dim[-1]
        self.mid_block = _Block(
            [ResnetBlock(mid_ch, mid_ch, temb_dim, g), ResnetBlock(mid_ch, mid_ch, temb_dim, g)],
            [Transformer2D(mid_ch, ctx, heads, mid_ch // heads,
                           cfg.transformer_layers_per_block[-1], g)])
        self.controlnet_mid_block = _zero_conv(mid_ch)

    @property
    def dtype(self) -> torch.dtype:
        return self.conv_in.weight.dtype

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor, control_cond: torch.Tensor,
                added_text_embeds: Optional[torch.Tensor] = None,
                added_time_ids: Optional[torch.Tensor] = None
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        cfg, dtype = self.cfg, self.dtype
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(sample.shape[0])
        temb = self.time_embedding(timestep_embedding(timesteps, cfg.block_out_channels[0])
                                   .to(dtype))
        if cfg.addition_embed_type == "text_time":
            tids = timestep_embedding(added_time_ids.reshape(-1), cfg.addition_time_embed_dim)
            tids = tids.reshape(sample.shape[0], -1)
            add = torch.cat([added_text_embeds.to(dtype), tids.to(dtype)], dim=-1)
            temb = temb + self.add_embedding(add)

        context = encoder_hidden_states.to(dtype)
        x = self.conv_in(sample.to(dtype).permute(0, 3, 1, 2))
        x = x + self.controlnet_cond_embedding(control_cond)

        features = [x]
        for block in self.down_blocks:
            for res, attn in block.pairs():
                x = res(x, temb)
                if attn is not None:
                    x = attn(x, context)
                features.append(x)
            if hasattr(block, "downsamplers"):
                x = block.downsamplers[0](x)
                features.append(x)
        x = self.mid_block.resnets[0](x, temb)
        x = self.mid_block.attentions[0](x, context)
        x = self.mid_block.resnets[1](x, temb)

        s = self.conditioning_scale
        down = [conv(f).permute(0, 2, 3, 1) * s
                for conv, f in zip(self.controlnet_down_blocks, features)]
        return down, self.controlnet_mid_block(x).permute(0, 2, 3, 1) * s


def create_controlnet(generator: torch.Generator, cfg: UNetConfig = UNetConfig.tiny(),
                      conditioning_scale: float = 1.0, dtype: torch.dtype = torch.float32
                      ) -> ControlNet:
    """A frozen random-weight ControlNet for a UNet of ``cfg`` on the CPU, drawn
    from ``generator``, its zero convolutions zero (kernels and biases)."""
    from rgie_tpu_torch.models.init import freeze_, random_init_

    model = random_init_(ControlNet(cfg, conditioning_scale), generator)
    with torch.no_grad():
        for conv in [*model.controlnet_down_blocks, model.controlnet_mid_block,
                     model.controlnet_cond_embedding.conv_out]:
            conv.weight.zero_()
            conv.bias.zero_()
    return freeze_(model.to(dtype))


def controlled_unet_apply(unet: UNet2DCondition, controlnet: ControlNet, latents: torch.Tensor,
                          t, context: torch.Tensor, control_cond: torch.Tensor, **added
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One UNet forward with ControlNet conditioning, the functional analog of
    diffusers' StableDiffusionControlNetPipeline UNet step (reference loaders:
    diff_utils.py:47-72). ``added`` are SDXL's ``added_text_embeds`` and
    ``added_time_ids``. Returns (eps, mid_features)."""
    down, mid = controlnet(latents, t, context, control_cond, **added)
    return unet(latents, t, context, down_residuals=down, mid_residual=mid, **added)
