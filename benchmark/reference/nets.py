"""Plain float32 networks of the edit and of midu training: the SD-family
UNet and VAE, the two midu regressors and the ten-crop ResNet-50 teacher.

They follow the published architectures (diffusers' ``UNet2DConditionModel``
with linear projections and ``AutoencoderKL``; torchvision's ResNet-50) and
use their parameter names, so the benchmark fills them and the program's
modules from one draw. No kernel, no cache, no batching trick: attention is
matmul, softmax, matmul at every length. Public tensors are NHWC, as the
program's are. Every layer that multiplies goes through ``precision`` so that
the control can lower it.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.precision import FLOAT32, QConv2d, QLinear, matmul


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers' sinusoidal embedding: cosines first, no frequency shift."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                        device=t.device) / half)
    emb = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)


class Attention(nn.Module):
    """Multi-head attention with diffusers' names; the UNet's (self or
    cross) and, with one head as wide as the channels, the VAE's."""

    precision = FLOAT32

    def __init__(self, query_dim: int, context_dim: int, heads: int, dim_head: int,
                 qkv_bias: bool = False):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = QLinear(query_dim, inner, bias=qkv_bias)
        self.to_k = QLinear(context_dim, inner, bias=qkv_bias)
        self.to_v = QLinear(context_dim, inner, bias=qkv_bias)
        self.to_out = nn.ModuleList([QLinear(inner, query_dim)])

    def attend(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        m = context.shape[1]
        q = self.to_q(x).view(b, n, self.heads, self.dim_head).transpose(1, 2)
        k = self.to_k(context).view(b, m, self.heads, self.dim_head).transpose(1, 2)
        v = self.to_v(context).view(b, m, self.heads, self.dim_head).transpose(1, 2)
        scores = matmul(q, k.transpose(2, 3), self.precision) / math.sqrt(self.dim_head)
        out = matmul(torch.softmax(scores, dim=-1), v, self.precision)
        return self.to_out[0](out.transpose(1, 2).reshape(b, n, -1))


class CrossAttention(Attention):
    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.attend(x, x if context is None else context)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, temb_dim: Optional[int], groups: int, eps: float):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=eps)
        self.conv1 = QConv2d(cin, cout, 3, padding=1)
        if temb_dim is not None:
            self.time_emb_proj = QLinear(temb_dim, cout)
        self.norm2 = nn.GroupNorm(groups, cout, eps=eps)
        self.conv2 = QConv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.conv_shortcut = QConv2d(cin, cout, 1)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class GEGLU(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = QLinear(dim, dim * 8)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, gate = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim), nn.Identity(), QLinear(dim * 4, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, context_dim: int, heads: int, dim_head: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = CrossAttention(dim, dim, heads, dim_head)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    def __init__(self, ch: int, context_dim: int, heads: int, depth: int, groups: int):
        super().__init__()
        self.norm = nn.GroupNorm(groups, ch, eps=1e-6)
        self.proj_in = QLinear(ch, ch)
        self.transformer_blocks = nn.ModuleList(
            [TransformerBlock(ch, context_dim, heads, ch // heads) for _ in range(depth)])
        self.proj_out = QLinear(ch, ch)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = self.proj_in(self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c))
        for block in self.transformer_blocks:
            y = block(y, context)
        return self.proj_out(y).reshape(b, h, w, c).permute(0, 3, 1, 2) + x


class Resample(nn.Module):
    """``down``: a stride-2 3x3 convolution (the VAE pads (0, 1, 0, 1) first);
    else nearest x2, then a 3x3 convolution."""

    def __init__(self, ch: int, down: bool, vae: bool = False):
        super().__init__()
        self.down, self.vae = down, vae
        pad = 0 if (down and vae) else 1
        self.conv = QConv2d(ch, ch, 3, stride=2 if down else 1, padding=pad)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.down:
            x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        elif self.vae:
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


class Block(nn.Module):
    """A down, mid or up block under diffusers' child names."""

    def __init__(self, resnets, attentions=(), downsamplers=(), upsamplers=()):
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


class TimeEmbedding(nn.Module):
    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.linear_1 = QLinear(cin, dim)
        self.linear_2 = QLinear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(x)))


class UNet(nn.Module):
    """diffusers' UNet2DConditionModel (SD 2.x and SDXL layouts). Returns the
    noise prediction and the mid-block output, both NHWC."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        chs, heads = cfg["block_out_channels"], cfg["attention_head_dim"]
        depth, layers = cfg["transformer_layers_per_block"], cfg["layers_per_block"]
        g, ctx = cfg["norm_num_groups"], cfg["cross_attention_dim"]
        temb = chs[0] * 4
        self.conv_in = QConv2d(cfg["in_channels"], chs[0], 3, padding=1)
        self.time_embedding = TimeEmbedding(chs[0], temb)
        if cfg.get("addition_embed_type") == "text_time":
            self.add_embedding = TimeEmbedding(cfg["projection_class_embeddings_input_dim"], temb)
        self.down_blocks = nn.ModuleList()
        cin, skips = chs[0], [chs[0]]
        for i, (kind, ch) in enumerate(zip(cfg["down_block_types"], chs)):
            res, att = [], []
            for _ in range(layers):
                res.append(ResnetBlock(cin, ch, temb, g, 1e-5))
                cin = ch
                skips.append(ch)
                if kind.startswith("CrossAttn"):
                    att.append(Transformer2D(ch, ctx, heads[i], depth[i], g))
            down = []
            if i < len(chs) - 1:
                down = [Resample(ch, down=True)]
                skips.append(ch)
            self.down_blocks.append(Block(res, att, downsamplers=down))
        mid = chs[-1]
        self.mid_block = Block([ResnetBlock(mid, mid, temb, g, 1e-5),
                                ResnetBlock(mid, mid, temb, g, 1e-5)],
                               [Transformer2D(mid, ctx, heads[-1], depth[-1], g)])
        self.up_blocks = nn.ModuleList()
        rev = list(zip(cfg["up_block_types"], reversed(chs), reversed(heads), reversed(depth)))
        x_ch = mid
        for i, (kind, ch, h, d) in enumerate(rev):
            res, att = [], []
            for _ in range(layers + 1):
                res.append(ResnetBlock(x_ch + skips.pop(), ch, temb, g, 1e-5))
                x_ch = ch
                if kind.startswith("CrossAttn"):
                    att.append(Transformer2D(ch, ctx, h, d, g))
            up = [Resample(ch, down=False)] if i < len(chs) - 1 else []
            self.up_blocks.append(Block(res, att, upsamplers=up))
        self.conv_norm_out = nn.GroupNorm(g, chs[0], eps=1e-5)
        self.conv_out = QConv2d(chs[0], cfg["out_channels"], 3, padding=1)

    def forward(self, sample: torch.Tensor, t, context: torch.Tensor,
                added_text: Optional[torch.Tensor] = None,
                added_time: Optional[torch.Tensor] = None):
        cfg = self.cfg
        b = sample.shape[0]
        t = torch.as_tensor(t, device=sample.device).expand(b)
        emb = self.time_embedding(timestep_embedding(t, cfg["block_out_channels"][0]))
        if hasattr(self, "add_embedding"):
            tids = timestep_embedding(added_time.reshape(-1), cfg["addition_time_embed_dim"])
            emb = emb + self.add_embedding(torch.cat([added_text, tids.reshape(b, -1)], dim=-1))
        x = self.conv_in(sample.permute(0, 3, 1, 2))
        skips = [x]
        for block in self.down_blocks:
            for res, attn in block.pairs():
                x = res(x, emb)
                if attn is not None:
                    x = attn(x, context)
                skips.append(x)
            if hasattr(block, "downsamplers"):
                x = block.downsamplers[0](x)
                skips.append(x)
        x = self.mid_block.resnets[0](x, emb)
        x = self.mid_block.attentions[0](x, context)
        x = self.mid_block.resnets[1](x, emb)
        mid = x.permute(0, 2, 3, 1)
        for block in self.up_blocks:
            for res, attn in block.pairs():
                x = res(torch.cat([x, skips.pop()], dim=1), emb)
                if attn is not None:
                    x = attn(x, context)
            if hasattr(block, "upsamplers"):
                x = block.upsamplers[0](x)
        x = self.conv_out(F.silu(self.conv_norm_out(x)))
        return x.permute(0, 2, 3, 1), mid


class VaeAttention(Attention):
    """The VAE mid block's single head over all positions, with a norm."""

    def __init__(self, ch: int, groups: int):
        super().__init__(ch, ch, 1, ch, qkv_bias=True)
        self.group_norm = nn.GroupNorm(groups, ch, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        return x + self.attend(y, y).reshape(b, h, w, c).permute(0, 3, 1, 2)


def _vae_mid(ch: int, g: int) -> Block:
    return Block([ResnetBlock(ch, ch, None, g, 1e-6), ResnetBlock(ch, ch, None, g, 1e-6)],
                 [VaeAttention(ch, g)])


def _run_mid(block: Block, x: torch.Tensor) -> torch.Tensor:
    return block.resnets[1](block.attentions[0](block.resnets[0](x)))


class Encoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        chs, g, layers = cfg["block_out_channels"], cfg["norm_num_groups"], cfg["layers_per_block"]
        self.conv_in = QConv2d(cfg["in_channels"], chs[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        cin = chs[0]
        for i, ch in enumerate(chs):
            res = []
            for _ in range(layers):
                res.append(ResnetBlock(cin, ch, None, g, 1e-6))
                cin = ch
            down = [Resample(ch, down=True, vae=True)] if i < len(chs) - 1 else []
            self.down_blocks.append(Block(res, downsamplers=down))
        self.mid_block = _vae_mid(chs[-1], g)
        self.conv_norm_out = nn.GroupNorm(g, chs[-1], eps=1e-6)
        self.conv_out = QConv2d(chs[-1], 2 * cfg["latent_channels"], 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for block in self.down_blocks:
            for res in block.resnets:
                x = res(x)
            if hasattr(block, "downsamplers"):
                x = block.downsamplers[0](x)
        return self.conv_out(F.silu(self.conv_norm_out(_run_mid(self.mid_block, x))))


class Decoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        chs, g, layers = cfg["block_out_channels"], cfg["norm_num_groups"], cfg["layers_per_block"]
        self.conv_in = QConv2d(cfg["latent_channels"], chs[-1], 3, padding=1)
        self.mid_block = _vae_mid(chs[-1], g)
        self.up_blocks = nn.ModuleList()
        cin = chs[-1]
        for i, ch in enumerate(reversed(chs)):
            res = []
            for _ in range(layers + 1):
                res.append(ResnetBlock(cin, ch, None, g, 1e-6))
                cin = ch
            up = [Resample(ch, down=False)] if i < len(chs) - 1 else []
            self.up_blocks.append(Block(res, upsamplers=up))
        self.conv_norm_out = nn.GroupNorm(g, chs[0], eps=1e-6)
        self.conv_out = QConv2d(chs[0], cfg["out_channels"], 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = _run_mid(self.mid_block, self.conv_in(z))
        for block in self.up_blocks:
            for res in block.resnets:
                x = res(x)
            if hasattr(block, "upsamplers"):
                x = block.upsamplers[0](x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class Vae(nn.Module):
    """diffusers' AutoencoderKL; ``encode`` gives the scaled posterior mode."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.scaling = cfg["scaling_factor"]
        lat = cfg["latent_channels"]
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = QConv2d(2 * lat, 2 * lat, 1)
        self.post_quant_conv = QConv2d(lat, lat, 1)

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) in [-1, 1] -> scaled latents (B, h, w, 4)."""
        moments = self.quant_conv(self.encoder(images.permute(0, 3, 1, 2)))
        mean, _ = moments.permute(0, 2, 3, 1).chunk(2, dim=-1)
        return self.scaling * mean

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Scaled latents -> images in [-1, 1], NHWC."""
        z = (latents / self.scaling).permute(0, 3, 1, 2)
        return self.decoder(self.post_quant_conv(z)).permute(0, 2, 3, 1)


class Midu(nn.Sequential):
    """The reference paper's midu regressors (MiduClassifier.py:124-160) over
    NHWC mid-block features: ``sdxl`` four conv + pool stages, else two."""

    def __init__(self, sdxl: bool, in_channels: int, num_outputs: int = 2):
        if sdxl:
            layers, ch = [], in_channels
            for out in (512, 256, 128, 64):
                layers += [QConv2d(ch, out, 3, padding=1), nn.ReLU(), nn.MaxPool2d(2)]
                ch = out
            layers += [nn.Flatten(), QLinear(256, 128), nn.ReLU(), QLinear(128, num_outputs)]
        else:
            layers = [QConv2d(in_channels, 256, 3, padding=1), nn.ReLU(), nn.MaxPool2d(2),
                      QConv2d(256, 128, 3, padding=1), nn.ReLU(), nn.AdaptiveAvgPool2d((2, 2)),
                      nn.Flatten(), QLinear(512, 64), nn.ReLU(), QLinear(64, num_outputs)]
        super().__init__(*layers)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        return super().forward(features.permute(0, 3, 1, 2))


def va_score(predicted: torch.Tensor, minimize: bool = True) -> torch.Tensor:
    """The guidance loss: the squared distance of the VA prediction to the
    untargeted goal (0.5, 0) when minimizing, (1, 1) when maximizing, summed
    over the images (guidance_scores.py:4-22)."""
    goal = torch.tensor((0.5, 0.0) if minimize else (1.0, 1.0), device=predicted.device)
    return torch.sum((goal - predicted) ** 2)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, width: int, stride: int, project: bool):
        super().__init__()
        self.conv1 = QConv2d(cin, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = QConv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = QConv2d(width, width * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(width * 4)
        self.downsample = None
        if project:
            self.downsample = nn.Sequential(QConv2d(cin, width * 4, 1, stride, bias=False),
                                            nn.BatchNorm2d(width * 4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skip = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        return F.relu(self.bn3(self.conv3(y)) + skip)


class ResNet50(nn.Module):
    """torchvision's ResNet-50 (v1.5) with a ``num_classes`` head."""

    def __init__(self, num_classes: int):
        super().__init__()
        self.conv1 = QConv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        cin = 64
        for i, blocks in enumerate((3, 4, 6, 3)):
            width = 64 * 2 ** i
            stage = [Bottleneck(cin if j == 0 else width * 4, width,
                                2 if (i > 0 and j == 0) else 1, j == 0) for j in range(blocks)]
            cin = width * 4
            self.add_module(f"layer{i + 1}", nn.Sequential(*stage))
        self.fc = QLinear(cin, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.maxpool(F.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return self.fc(x.mean(dim=(2, 3)))


def ten_crop_offsets(h: int, w: int, crop: int) -> List[tuple]:
    """The fixed ten-crop grid: four corners, the centre, four edge
    midpoints and one interior point."""
    my, mx = h - crop, w - crop
    return [(0, 0), (0, mx), (my, 0), (my, mx), (my // 2, mx // 2), (0, mx // 2),
            (my // 2, 0), (my, mx // 2), (my // 2, mx), (my // 4, 3 * mx // 4)]


class Teacher(nn.Module):
    """The pixel-space VA regressor (EmotionPredictionModel.py:10-54):
    resize the shorter side to ``input_size`` (bilinear, antialiased), ten
    ``crop_size`` crops, ResNet-50, the mean over the crops, a sigmoid;
    valence and arousal are its first two outputs."""

    def __init__(self, input_size: int = 480, crop_size: int = 448, num_classes: int = 4):
        super().__init__()
        self.input_size, self.crop_size = input_size, crop_size
        self.net = ResNet50(num_classes)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = images.shape
        s = self.input_size
        size = (s, max(1, round(w * s / h))) if h <= w else (max(1, round(h * s / w)), s)
        x = F.interpolate(images.permute(0, 3, 1, 2), size=size, mode="bilinear",
                          align_corners=False, antialias=True)
        c = self.crop_size
        crops = [x[:, :, t:t + c, l:l + c] for t, l in ten_crop_offsets(size[0], size[1], c)]
        x = (torch.stack(crops, dim=1).reshape(b * len(crops), 3, c, c) - 0.5) / 0.5
        out = self.net(x).reshape(b, len(crops), -1).mean(dim=1)
        return torch.sigmoid(out)[:, :2]


def frozen(model: nn.Module) -> nn.Module:
    model.eval()
    model.requires_grad_(False)
    return model


def unet_forward(unet: UNet, latents, t, context, added: Optional[Sequence[torch.Tensor]]):
    """The UNet under SDXL's added conditioning where it has one: ``added``
    is (pooled text embeddings, time ids), one row or one per latent."""
    if added is None:
        return unet(latents, t, context)
    b = latents.shape[0]
    return unet(latents, t, context, added[0].expand(b, -1), added[1].expand(b, -1))
