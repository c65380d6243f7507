"""VAE (AutoencoderKL) for the SD family, and its tiled transport. Port of
``rgie_tpu/diffusion/vae.py``.

Parameter names follow diffusers' ``AutoencoderKL`` (``encoder.*``,
``decoder.*``, ``quant_conv``, ``post_quant_conv``; the mid attention as
``group_norm`` / ``to_q`` / ``to_k`` / ``to_v`` / ``to_out.0``). Public
tensors are NHWC: images ``(B, H, W, 3)`` in [-1, 1], latents ``(B, h, w,
4)``. Scaling factors: 0.18215 (SD), 0.13025 (SDXL).

Encoding returns the posterior mode by default (reproducible edits); with a
``torch.Generator`` it samples, as the reference does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, List, Optional, Tuple

import numpy as np

import torch
import torch.nn as nn
import torch.nn.functional as F

from rgie_tpu_torch.diffusion.unet import Float32Conv2d, GroupNorm32, _Block
from rgie_tpu_torch.ops.kernels.flash_attention import flash_attention, flash_self_attention_ok
from rgie_tpu_torch.utils.spans import attention_span

SD_SCALING = 0.18215
SDXL_SCALING = 0.13025


@dataclasses.dataclass(frozen=True)
class VaeConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = SD_SCALING

    @staticmethod
    def sd() -> "VaeConfig":
        return VaeConfig()

    @staticmethod
    def sdxl() -> "VaeConfig":
        return VaeConfig(scaling_factor=SDXL_SCALING)

    @staticmethod
    def tiny() -> "VaeConfig":
        return VaeConfig(block_out_channels=(8, 16), layers_per_block=1, norm_num_groups=4)


class VaeResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, groups: int = 32):
        super().__init__()
        self.norm1 = GroupNorm32(groups, in_channels, eps=1e-6)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = GroupNorm32(groups, out_channels, eps=1e-6)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.conv_shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class VaeAttention(nn.Module):
    """Single-head self-attention over the positions of an NCHW map, head
    width = channels. At 1024 px (16384 positions) the matmul form would hold
    a 16384 x 16384 score matrix per image; there the flash kernels run. At
    512 px (4096 positions) the 512-wide head stays on the matmul form, which
    the wide kernels do not beat there."""

    def __init__(self, channels: int, groups: int = 32):
        super().__init__()
        self.group_norm = GroupNorm32(groups, channels, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        n = h * w
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, n, c)
        q, k, v = self.to_q(y), self.to_k(y), self.to_v(y)
        flash = flash_self_attention_ok(n, n, c)
        with attention_span("k2" if flash else "matmul", q.dtype, b, 1, n, n, c):
            if flash:
                y = flash_attention(q[:, None], k[:, None], v[:, None],
                                    sm_scale=1.0 / math.sqrt(c))[:, 0]
            else:
                attn = torch.softmax(torch.matmul(q, k.transpose(1, 2)) / math.sqrt(c), dim=-1)
                y = torch.matmul(attn, v)
        y = self.to_out[0](y)
        return x + y.reshape(b, h, w, c).permute(0, 3, 1, 2)


class _VaeDownsample(nn.Module):
    """diffusers VAE downsample: asymmetric (0, 1) pad, then a stride-2 conv
    without padding."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class _VaeUpsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        return self.conv(x)


def _mid_block(channels: int, groups: int) -> _Block:
    return _Block([VaeResnetBlock(channels, channels, groups),
                   VaeResnetBlock(channels, channels, groups)],
                  [VaeAttention(channels, groups)])


def _run_mid(block: _Block, x: torch.Tensor) -> torch.Tensor:
    x = block.resnets[0](x)
    x = block.attentions[0](x)
    return block.resnets[1](x)


class Encoder(nn.Module):
    """NCHW image -> the 2 * latent_channels moments map (before quant_conv)."""

    def __init__(self, cfg: VaeConfig):
        super().__init__()
        g, chs = cfg.norm_num_groups, cfg.block_out_channels
        self.conv_in = nn.Conv2d(cfg.in_channels, chs[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        in_ch = chs[0]
        for bi, ch in enumerate(chs):
            resnets = []
            for _ in range(cfg.layers_per_block):
                resnets.append(VaeResnetBlock(in_ch, ch, g))
                in_ch = ch
            downs = [_VaeDownsample(ch)] if bi < len(chs) - 1 else None
            self.down_blocks.append(_Block(resnets, downsamplers=downs))
        self.mid_block = _mid_block(chs[-1], g)
        self.conv_norm_out = GroupNorm32(g, chs[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(chs[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for block in self.down_blocks:
            for res in block.resnets:
                x = res(x)
            if hasattr(block, "downsamplers"):
                x = block.downsamplers[0](x)
        x = _run_mid(self.mid_block, x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class Decoder(nn.Module):
    """NCHW latent (after post_quant_conv) -> NCHW image, float32."""

    def __init__(self, cfg: VaeConfig):
        super().__init__()
        g, chs = cfg.norm_num_groups, cfg.block_out_channels
        mid = chs[-1]
        self.conv_in = nn.Conv2d(cfg.latent_channels, mid, 3, padding=1)
        self.mid_block = _mid_block(mid, g)
        self.up_blocks = nn.ModuleList()
        in_ch = mid
        for bi, ch in enumerate(reversed(chs)):
            resnets = []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(VaeResnetBlock(in_ch, ch, g))
                in_ch = ch
            ups = [_VaeUpsample(ch)] if bi < len(chs) - 1 else None
            self.up_blocks.append(_Block(resnets, upsamplers=ups))
        self.conv_norm_out = GroupNorm32(g, chs[0], eps=1e-6)
        self.conv_out = Float32Conv2d(chs[0], cfg.in_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(z)
        x = _run_mid(self.mid_block, x)
        for block in self.up_blocks:
            for res in block.resnets:
                x = res(x)
            if hasattr(block, "upsamplers"):
                x = block.upsamplers[0](x)
        # The image comes out in float32 whatever the working type.
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VaeConfig = VaeConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = nn.Conv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(cfg.latent_channels, cfg.latent_channels, 1)

    @property
    def upscale_factor(self) -> int:
        """Image px per latent px (8 for the SD family)."""
        return 2 ** (len(self.cfg.block_out_channels) - 1)

    @property
    def dtype(self) -> torch.dtype:
        return self.quant_conv.weight.dtype

    def encode_moments(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, H, W, 3) in [-1, 1] -> (mean, logvar) of the latent posterior,
        each (B, h, w, latent_channels)."""
        x = images.to(self.dtype).permute(0, 3, 1, 2)
        moments = self.quant_conv(self.encoder(x)).permute(0, 2, 3, 1)
        mean, logvar = moments.chunk(2, dim=-1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def encode(self, images: torch.Tensor, generator: Optional[torch.Generator] = None
               ) -> torch.Tensor:
        """Scaled latents; the posterior mode unless a generator is given."""
        mean, logvar = self.encode_moments(images)
        if generator is not None:
            noise = torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                                device=generator.device).to(mean.device)
            mean = mean + torch.exp(0.5 * logvar) * noise
        return self.cfg.scaling_factor * mean

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Scaled latents (B, h, w, 4) -> images (B, H, W, 3) in [-1, 1],
        float32."""
        z = (latents / self.cfg.scaling_factor).to(self.dtype).permute(0, 3, 1, 2)
        return self.decoder(self.post_quant_conv(z)).permute(0, 2, 3, 1)

    def forward(self, images: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        return self.decode(self.encode(images, generator))


def create_vae(generator: torch.Generator, cfg: VaeConfig = VaeConfig.tiny(),
               dtype: torch.dtype = torch.float32) -> AutoencoderKL:
    """A frozen random-weight VAE on the CPU, drawn from ``generator``."""
    from rgie_tpu_torch.models.init import freeze_, random_init_

    return freeze_(random_init_(AutoencoderKL(cfg), generator).to(dtype))


# ---------------------------------------------------------------------------
# Tiled VAE transport (the diffusers ``enable_tiling`` analog, diffusers
# autoencoder_kl.py tiled_decode/tiled_encode): the VAE runs over fixed-size
# tiles one after another and tile borders are crossfaded. The tile grid is
# fixed by the shapes (the last tile is clamped to the canvas, never smaller),
# and blending is a symmetric linear crossfade through a per-tile weight mask
# accumulated into the canvas; pixels on a tile's cut edge (polluted by the
# convolutions' zero padding) get weight exactly 0. As in diffusers this is
# an approximation at seams: each tile runs its own mid-block attention. The
# defaults are diffusers' 512 px tiles with 25% overlap (tile_latent_min_size
# 64, overlap_factor 0.25).
# ---------------------------------------------------------------------------


def tile_positions(extent: int, tile: int, stride: int) -> List[int]:
    """Tile start offsets covering [0, extent); the last tile is clamped."""
    if extent <= tile:
        return [0]
    ps = list(range(0, extent - tile + 1, stride))
    if ps[-1] + tile < extent:
        ps.append(extent - tile)
    return ps


def _edge_ramp(length: int, edge: int, ramp_lo: bool, ramp_hi: bool) -> np.ndarray:
    w = np.ones((length,), np.float32)
    e = min(edge, length)
    if e == 0:
        return w
    # Linear 0 -> 1 over the overlap; the cut-edge pixel gets weight exactly
    # 0 (the neighbouring tile covers it at full weight). e == 1 uses 0.5 so
    # that the two single-pixel ramps never sum to zero.
    ramp = (np.arange(e, dtype=np.float32) / e) if e > 1 else np.array([0.5], np.float32)
    if ramp_lo:
        w[:e] = np.minimum(w[:e], ramp)
    if ramp_hi:
        w[-e:] = np.minimum(w[-e:], ramp[::-1])
    return w


def _stitch(tiles: Iterable[torch.Tensor], positions, tile: int, edge: int, extent_hw,
            factor: int, out_channels: int) -> torch.Tensor:
    """Accumulate the tiles, in the order of ``positions``, into a weighted
    canvas. ``tiles`` may be a generator: each tile is added as it comes, so
    one tile and the canvas are held at a time."""
    h, w = extent_hw
    acc = wacc = None
    for (y, x), t in zip(positions, tiles):
        if acc is None:
            acc = torch.zeros((t.shape[0], h * factor, w * factor, out_channels), dtype=t.dtype,
                              device=t.device)
            wacc = torch.zeros((1, h * factor, w * factor, 1), dtype=t.dtype, device=t.device)
        wy = _edge_ramp(tile * factor, edge * factor, y > 0, y + tile < h)
        wx = _edge_ramp(tile * factor, edge * factor, x > 0, x + tile < w)
        mask = torch.from_numpy((wy[:, None] * wx[None, :])[None, :, :, None]).to(
            device=t.device, dtype=t.dtype)
        rows = slice(y * factor, (y + tile) * factor)
        cols = slice(x * factor, (x + tile) * factor)
        acc[:, rows, cols] += t * mask
        wacc[:, rows, cols] += mask
    return acc / wacc


def decode_tiled(model: AutoencoderKL, latents: torch.Tensor, tile: int = 64,
                 stride: int = 48) -> torch.Tensor:
    """Scaled latents -> [-1, 1] images, decoding (tile, tile) latent tiles
    one after another. Equal to ``decode`` when the latent fits one tile."""
    _, h, w, _ = latents.shape
    if h <= tile and w <= tile:
        return model.decode(latents)
    pos = [(y, x) for y in tile_positions(h, tile, stride) for x in tile_positions(w, tile, stride)]
    tiles = (model.decode(latents[:, y:y + tile, x:x + tile, :]) for y, x in pos)
    return _stitch(tiles, pos, tile, tile - stride, (h, w), model.upscale_factor,
                   model.cfg.in_channels)


def encode_tiled(model: AutoencoderKL, images: torch.Tensor,
                 generator: Optional[torch.Generator] = None, tile: int = 64,
                 stride: int = 48) -> torch.Tensor:
    """[-1, 1] images -> scaled latents over (tile*f, tile*f) image tiles;
    ``tile`` and ``stride`` are in LATENT units (as in ``decode_tiled``). With
    a generator, each tile samples its posterior with its own draw (the next
    one from the generator, in tile order)."""
    f = model.upscale_factor
    _, hi, wi, _ = images.shape
    h, w = hi // f, wi // f
    if h <= tile and w <= tile:
        return model.encode(images, generator)
    pos = [(y, x) for y in tile_positions(h, tile, stride) for x in tile_positions(w, tile, stride)]
    tiles = (model.encode(images[:, y * f:(y + tile) * f, x * f:(x + tile) * f, :], generator)
             for y, x in pos)
    return _stitch(tiles, pos, tile, tile - stride, (h, w), 1, model.cfg.latent_channels)
