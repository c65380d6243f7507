"""Text encoders and prompt embedding for the SD family. Port of
``rgie_tpu/diffusion/text_encoder.py``.

The reference builds prompt embeddings through diffusers' encode_prompt
(``src/pipelines/diff_utils.py:252-346``): SD2.1 uses the OpenCLIP ViT-H text
tower's penultimate hidden states (1024 wide); SDXL concatenates CLIP ViT-L
(768) and OpenCLIP bigG (1280) hidden states (2048 wide) and adds bigG's
pooled, projected embedding and the micro-conditioning time ids. A tower here
carries the
parameter names of ``transformers.CLIPTextModel`` (``text_model.embeddings.*``,
``text_model.encoder.layers.N.*``, ``text_model.final_layer_norm``,
``text_projection``), so a real checkpoint's state dict loads directly.
Tokenization uses the real CLIP BPE when a merges file is available
(``RGIE_CLIP_BPE_PATH``) and a deterministic hash fallback otherwise.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import os
import zlib
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from rgie_tpu_torch.models.clip import quick_gelu

BOS, EOS = 49406, 49407
CONTEXT_LEN = 77

#: HF ``hidden_act`` name -> fn. The SD-family checkpoints differ: CLIP ViT-L
#: (SDXL text_encoder) uses quick_gelu; the OpenCLIP-derived towers (SD2.1
#: ViT-H, SDXL bigG) use exact (erf) gelu.
ACTIVATIONS = {"quick_gelu": quick_gelu, "gelu": F.gelu}


class TextTowerConfig:
    """Standard tower shapes (matching the HF text_encoder configs the
    reference's ``from_pretrained`` pulls in)."""

    @staticmethod
    def open_clip_vit_h():  # SD2.1 text encoder: 23-layer HF checkpoint whose
        # last_hidden_state (with final LN) IS the penultimate-layer trick.
        return dict(width=1024, layers=23, heads=16, act="gelu", skip_last=0)

    @staticmethod
    def clip_vit_l():       # SDXL text_encoder 1: penultimate hidden states.
        return dict(width=768, layers=12, heads=12, act="quick_gelu", skip_last=1)

    @staticmethod
    def open_clip_big_g():  # SDXL text_encoder 2: penultimate + projected pool.
        return dict(width=1280, layers=32, heads=20, act="gelu", skip_last=1, proj_dim=1280)

    @staticmethod
    def tiny():
        return dict(width=32, layers=2, heads=2)


class _SelfAttention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(width, width)
        self.k_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, n, w = x.shape
        d = w // self.heads

        def split(t):
            return t.view(b, n, self.heads, d).transpose(1, 2)

        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))
        logits = torch.matmul(q / math.sqrt(d), k.transpose(-1, -2))
        logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
        y = torch.matmul(torch.softmax(logits, dim=-1), v)
        return self.out_proj(y.transpose(1, 2).reshape(b, n, w))


class _Mlp(nn.Module):
    def __init__(self, width: int, act: str):
        super().__init__()
        self.fc1 = nn.Linear(width, width * 4)
        self.fc2 = nn.Linear(width * 4, width)
        self.act = ACTIVATIONS[act]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class _EncoderLayer(nn.Module):
    def __init__(self, width: int, heads: int, act: str):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(width, eps=1e-5)
        self.self_attn = _SelfAttention(width, heads)
        self.layer_norm2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = _Mlp(width, act)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, vocab_size: int, context_length: int, width: int):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.position_embedding = nn.Embedding(context_length, width)


class _Encoder(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, act: str):
        super().__init__()
        self.layers = nn.ModuleList([_EncoderLayer(width, heads, act) for _ in range(layers)])


class _TextModel(nn.Module):
    def __init__(self, width, layers, heads, vocab_size, context_length, act):
        super().__init__()
        self.embeddings = _Embeddings(vocab_size, context_length, width)
        self.encoder = _Encoder(width, layers, heads, act)
        self.final_layer_norm = nn.LayerNorm(width, eps=1e-5)


class TextEncoderHidden(nn.Module):
    """CLIP text tower returning (hidden_states, pooled).

    ``skip_last=1`` returns the penultimate layer's raw hidden states (the
    diffusers SDXL ``hidden_states[-2]`` path); ``skip_last=0`` returns the
    final layer WITH the final LayerNorm applied (HF ``last_hidden_state``,
    what diffusers' SD2.x encode_prompt consumes). ``proj_dim`` adds the HF
    ``text_projection`` to the pooled output (SDXL text_encoder_2)."""

    def __init__(self, width: int = 1024, layers: int = 23, heads: int = 16,
                 vocab_size: int = 49408, context_length: int = CONTEXT_LEN,
                 skip_last: int = 1, act: str = "quick_gelu", proj_dim: Optional[int] = None):
        super().__init__()
        self.skip_last = skip_last
        self.text_model = _TextModel(width, layers, heads, vocab_size, context_length, act)
        if proj_dim is not None:
            self.text_projection = nn.Linear(width, proj_dim, bias=False)

    def forward(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        tm = self.text_model
        n = tokens.shape[1]
        x = tm.embeddings.token_embedding(tokens) + tm.embeddings.position_embedding.weight[:n]
        mask = torch.ones((n, n), dtype=torch.bool, device=tokens.device).tril()
        penultimate = x
        n_layers = len(tm.encoder.layers)
        for i, layer in enumerate(tm.encoder.layers):
            x = layer(x, mask)
            if i == n_layers - 1 - self.skip_last:
                penultimate = x
        final = tm.final_layer_norm(x)
        hidden = penultimate if self.skip_last > 0 else final
        eot = tokens.argmax(dim=-1)
        pooled = final[torch.arange(final.shape[0], device=tokens.device), eot]
        if hasattr(self, "text_projection"):
            pooled = self.text_projection(pooled)
        return hidden, pooled


def tokenize(texts: Sequence[str], context_length: int = CONTEXT_LEN) -> torch.Tensor:
    """CLIP BPE when available, else a deterministic hash tokenizer: the same
    text gives the same ids, and BOS/EOS framing and padding follow CLIP's.
    The fallback keeps the pipeline runnable with random weights where no
    vocabulary file is at hand. Returns (len(texts), context_length) int64."""
    bpe = _load_bpe()
    out = np.zeros((len(texts), context_length), dtype=np.int64)
    for i, text in enumerate(texts):
        if bpe is not None:
            ids = bpe(text)[: context_length - 2]
        else:
            words = text.lower().strip().split()
            ids = [int(hashlib.md5(w.encode()).hexdigest(), 16) % 49000 + 320
                   for w in words][: context_length - 2]
        row = [BOS] + list(ids) + [EOS]
        out[i, : len(row)] = row
    return torch.from_numpy(out)


_BPE = None

#: Default location for the public CLIP merges file
#: (``bpe_simple_vocab_16e6.txt.gz`` from openai/CLIP). It is not committed:
#: drop the file here (or point RGIE_CLIP_BPE_PATH at it) and every
#: tokenize() call uses the real BPE.
VENDORED_BPE_PATH = os.path.join(os.path.dirname(__file__), "assets",
                                 "bpe_simple_vocab_16e6.txt.gz")


def _load_bpe():
    """Load the real CLIP BPE from RGIE_CLIP_BPE_PATH or the vendored asset.
    A file that is missing or does not load (truncated, not gzip, not a
    merges list) leaves the hash tokenizer in place, as in the JAX package."""
    global _BPE
    if _BPE is not None:
        return _BPE if _BPE is not False else None
    path = os.environ.get("RGIE_CLIP_BPE_PATH", "") or VENDORED_BPE_PATH
    if not os.path.exists(path):
        _BPE = False
        return None
    from rgie_tpu_torch.diffusion.bpe import SimpleBPE

    try:
        _BPE = SimpleBPE(path)
    except (OSError, EOFError, ValueError, zlib.error):   # unreadable, not gzip, not text
        _BPE = False
        return None
    return _BPE


@dataclasses.dataclass(frozen=True)
class PromptEncoder:
    """Bound text tower(s) producing CFG-ready embeddings.

    SD: embeds (2, 77, width) [uncond; cond]
    SDXL: embeds (2, 77, 768+1280) + pooled text_embeds (2, 1280) + time_ids
    (2, 6). (reference: get_prompt_embeddings_sd / _sdxl, diff_utils.py:252-346)

    The towers and every embedding are float32."""

    tower1: TextEncoderHidden
    tower2: Optional[TextEncoderHidden] = None   # SDXL's second tower

    @property
    def device(self) -> torch.device:
        return self.tower1.text_model.final_layer_norm.weight.device

    @torch.no_grad()
    def encode_sd(self, prompt: str, negative_prompt: str = "", do_cfg: bool = True
                  ) -> torch.Tensor:
        tokens = tokenize([negative_prompt, prompt] if do_cfg else [prompt])
        hidden, _ = self.tower1(tokens.to(self.device))
        return hidden

    @torch.no_grad()
    def encode_sdxl(self, prompt: str, negative_prompt: str = "", image_size: int = 1024
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(embeds (2, 77, w1 + w2), pooled text embeds (2, proj_dim), time ids
        (2, 6)), rows [negative; prompt], on the towers' device."""
        tokens = tokenize([negative_prompt, prompt]).to(self.device)
        h1, _ = self.tower1(tokens)
        h2, pooled2 = self.tower2(tokens)
        embeds = torch.cat([h1, h2], dim=-1)
        time_ids = get_add_time_ids(image_size, image_size).to(self.device).expand(2, 6)
        return embeds, pooled2, time_ids


def get_add_time_ids(height: int, width: int, crop_top: int = 0, crop_left: int = 0,
                     target_height: Optional[int] = None,
                     target_width: Optional[int] = None) -> torch.Tensor:
    """SDXL micro-conditioning (reference: get_add_time_ids, diff_utils.py:349-367):
    (orig_h, orig_w, crop_top, crop_left, target_h, target_w), (1, 6) float32."""
    return torch.tensor([[height, width, crop_top, crop_left, target_height or height,
                          target_width or width]], dtype=torch.float32)


def tower_config_from_params(state_dict: dict, skip_last: int = 1, act: str = "gelu") -> dict:
    """TextEncoderHidden shape kwargs from a tower's HF-named state dict
    (``text_model.*``, ``text_projection.weight``). ``act`` and
    ``skip_last`` depend on the tower's role (see TextTowerConfig) and must be
    given; heads are width // 64, as in every SD-family tower."""
    width = state_dict["text_model.embeddings.position_embedding.weight"].shape[1]
    prefix = "text_model.encoder.layers."
    layers = {k[len(prefix):].split(".")[0] for k in state_dict if k.startswith(prefix)}
    cfg = dict(width=width, layers=len(layers), heads=max(width // 64, 1),
               vocab_size=state_dict["text_model.embeddings.token_embedding.weight"].shape[0],
               skip_last=skip_last, act=act)
    if "text_projection.weight" in state_dict:
        cfg["proj_dim"] = state_dict["text_projection.weight"].shape[0]
    return cfg


def _random_tower(generator: torch.Generator, cfg: dict, dtype: torch.dtype, **kw
                  ) -> TextEncoderHidden:
    """A frozen random-weight tower on the CPU (positions N(0, 0.01) and the
    projection N(0, 1/width), as in the JAX package)."""
    from rgie_tpu_torch.models.init import freeze_, random_init_

    tower = TextEncoderHidden(**kw, **cfg)
    random_init_(tower, generator, stds={
        "text_model.embeddings.position_embedding.weight": 0.01,
        "text_projection.weight": cfg["width"] ** -0.5})
    return freeze_(tower.to(dtype))


def create_sd_prompt_encoder(generator: torch.Generator, tower_cfg: Optional[dict] = None,
                             vocab_size: int = 49408, dtype: torch.dtype = torch.float32
                             ) -> PromptEncoder:
    """A frozen random-weight SD prompt encoder on the CPU."""
    cfg = tower_cfg or TextTowerConfig.open_clip_vit_h()
    return PromptEncoder(tower1=_random_tower(generator, cfg, dtype, vocab_size=vocab_size))


def create_sdxl_prompt_encoder(generator: torch.Generator, cfg1: Optional[dict] = None,
                               cfg2: Optional[dict] = None, dtype: torch.dtype = torch.float32
                               ) -> PromptEncoder:
    """A frozen random-weight SDXL prompt encoder on the CPU: CLIP ViT-L
    (quick_gelu) and OpenCLIP bigG (gelu, projected pool), both read at their
    penultimate layer."""
    return PromptEncoder(
        tower1=_random_tower(generator, cfg1 or TextTowerConfig.clip_vit_l(), dtype),
        tower2=_random_tower(generator, cfg2 or TextTowerConfig.open_clip_big_g(), dtype))
