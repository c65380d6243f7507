"""Load a local diffusers-format checkpoint directory into the port's modules.
Port of ``rgie_tpu/diffusion/load.py``.

The reference calls ``from_pretrained("stabilityai/sd-turbo")`` /
``("stabilityai/stable-diffusion-xl-base-1.0")``
(``src/pipelines/InversionResamplingStableDiffusionPipeline.py:17-21``,
``...XLPipeline.py:15-20``). This is the offline analog: point it at an
already-downloaded diffusers snapshot directory

    <root>/unet/diffusion_pytorch_model.safetensors
    <root>/vae/diffusion_pytorch_model.safetensors
    <root>/text_encoder/model.safetensors
    <root>/text_encoder_2/model.safetensors        (SDXL)
    <root>/tokenizer/merges.txt                    (used for real BPE)

``.bin`` (torch pickle) checkpoints are accepted where safetensors are
absent. The port's modules carry the diffusers and HF parameter names, so
the state dicts load with ``load_state_dict(strict=True)`` as they are; the
only rewriting is what the JAX package's converters accept too: buffers and
bookkeeping keys no parameter maps to are dropped, and the VAE's legacy
attention names (``query``/``key``/``value``/``proj_attn``, 1x1-conv
weights) take the current ones.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn as nn

from rgie_tpu_torch.diffusion.unet import UNetConfig
from rgie_tpu_torch.diffusion.vae import VaeConfig

StateDict = Dict[str, torch.Tensor]

# Keys a real checkpoint may carry that no parameter maps to: HF position-id
# buffers (old transformers versions persist them), EMA shadow copies, and BN
# bookkeeping counters.
IGNORED_CHECKPOINT_KEYS = (
    r"(^|\.)position_ids$",
    r"num_batches_tracked$",
    r"(^|\.)model_ema\.",
    r"(^|\.)logit_scale$",
)
_LEGACY_VAE_ATTENTION = {"query": "to_q", "key": "to_k", "value": "to_v", "proj_attn": "to_out.0"}


def load_state_dict_file(path: str) -> StateDict:
    """One weights file (safetensors or torch .bin) -> ``{name: tensor}`` on
    the CPU, in the file's own types."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return dict(load_file(path))
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v for k, v in obj.items() if isinstance(v, torch.Tensor)}


def _find_weights(subdir: str) -> Optional[str]:
    if not os.path.isdir(subdir):
        return None
    for name in ("diffusion_pytorch_model.safetensors", "model.safetensors",
                 "diffusion_pytorch_model.bin", "pytorch_model.bin",
                 "diffusion_pytorch_model.fp16.safetensors", "model.fp16.safetensors"):
        p = os.path.join(subdir, name)
        if os.path.exists(p):
            return p
    return None


def _read_config(subdir: str) -> Dict[str, Any]:
    p = os.path.join(subdir, "config.json")
    if os.path.exists(p):
        with open(p) as f:
            return json.load(f)
    return {}


def unet_config_from_json(cfg: Dict[str, Any]) -> UNetConfig:
    """diffusers unet/config.json -> UNetConfig (falls back to SD2.1 fields).
    ``addition_pooled_dim`` is what ``projection_class_embeddings_input_dim``
    leaves after the six time ids: the port's modules are built with their
    shapes, where the JAX package's infer them from the first input."""
    d = UNetConfig()
    if not cfg:
        return d
    n_blocks = len(cfg.get("block_out_channels", d.block_out_channels))

    def per_block(name, default):
        v = cfg.get(name, default)
        return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n_blocks

    time_dim = cfg.get("addition_time_embed_dim") or d.addition_time_embed_dim
    proj_dim = (cfg.get("projection_class_embeddings_input_dim")
                or d.projection_class_embeddings_input_dim)
    return UNetConfig(
        in_channels=cfg.get("in_channels", d.in_channels),
        out_channels=cfg.get("out_channels", d.out_channels),
        block_out_channels=tuple(cfg.get("block_out_channels", d.block_out_channels)),
        down_block_types=tuple(cfg.get("down_block_types", d.down_block_types)),
        up_block_types=tuple(cfg.get("up_block_types", d.up_block_types)),
        layers_per_block=cfg.get("layers_per_block", d.layers_per_block),
        transformer_layers_per_block=per_block("transformer_layers_per_block", 1),
        attention_head_dim=per_block("attention_head_dim", 8),
        cross_attention_dim=cfg.get("cross_attention_dim", d.cross_attention_dim),
        addition_embed_type=cfg.get("addition_embed_type"),
        addition_time_embed_dim=time_dim,
        addition_pooled_dim=proj_dim - 6 * time_dim,
        projection_class_embeddings_input_dim=proj_dim,
        norm_num_groups=cfg.get("norm_num_groups", d.norm_num_groups),
    )


def vae_config_from_json(cfg: Dict[str, Any], is_xl: bool) -> VaeConfig:
    d = VaeConfig.sdxl() if is_xl else VaeConfig.sd()
    if not cfg:
        return d
    return VaeConfig(
        in_channels=cfg.get("in_channels", d.in_channels),
        latent_channels=cfg.get("latent_channels", d.latent_channels),
        block_out_channels=tuple(cfg.get("block_out_channels", d.block_out_channels)),
        layers_per_block=cfg.get("layers_per_block", d.layers_per_block),
        norm_num_groups=cfg.get("norm_num_groups", d.norm_num_groups),
        scaling_factor=cfg.get("scaling_factor", d.scaling_factor),
    )


def normalize_state_dict(state: StateDict, dtype: Optional[torch.dtype] = None) -> StateDict:
    """Drop the keys no parameter maps to, rename the VAE's legacy attention
    keys, and cast floating tensors to ``dtype`` when one is given."""
    out = {}
    for key, value in state.items():
        if any(re.search(pat, key) for pat in IGNORED_CHECKPOINT_KEYS):
            continue
        m = re.match(r"(.*mid_block\.attentions\.0\.)(query|key|value|proj_attn)\.(weight|bias)$",
                     key)
        if m:
            key = m.group(1) + _LEGACY_VAE_ATTENTION[m.group(2)] + "." + m.group(3)
            if value.ndim == 4:            # legacy 1x1 convolution weights
                value = value[:, :, 0, 0]
        if dtype is not None and value.is_floating_point():
            value = value.to(dtype)
        out[key] = value
    return out


def module_from_state_dict(make: Callable[[], nn.Module], state: StateDict) -> nn.Module:
    """Build ``make()`` without initialising it and load ``state`` into it
    (strict: every parameter is in the file and every key is a parameter).
    The module takes the tensors' types; it comes back frozen, on the CPU."""
    from rgie_tpu_torch.models.init import freeze_

    with torch.device("meta"):
        module = make()
    module.load_state_dict(state, strict=True, assign=True)
    return freeze_(module)


class DiffusersCheckpoint:
    """The state dicts and configs of one diffusers snapshot directory.

    ``text_cfg``/``text2_cfg`` are the raw ``text_encoder*/config.json``
    dicts: SD1.x towers use hidden_act=quick_gelu while SD2.x/sd-turbo use
    gelu, so the activation is read from the checkpoint, not fixed per role."""

    def __init__(self, unet_cfg: UNetConfig, unet_state: Optional[StateDict],
                 vae_cfg: VaeConfig, vae_state: Optional[StateDict],
                 text_state: Optional[StateDict], text2_state: Optional[StateDict] = None,
                 merges_path: Optional[str] = None, text_cfg: Optional[Dict[str, Any]] = None,
                 text2_cfg: Optional[Dict[str, Any]] = None):
        self.unet_cfg = unet_cfg
        self.unet_state = unet_state
        self.vae_cfg = vae_cfg
        self.vae_state = vae_state
        self.text_state = text_state
        self.text2_state = text2_state
        self.merges_path = merges_path
        self.text_cfg = text_cfg or {}
        self.text2_cfg = text2_cfg or {}

    @property
    def is_xl(self) -> bool:
        return self.unet_cfg.addition_embed_type == "text_time"

    @property
    def text_act(self) -> str:
        # HF CLIPTextConfig's default hidden_act is quick_gelu (CLIP ViT-L,
        # i.e. SD1.x / SDXL tower 1); SD2.x OpenCLIP configs say "gelu".
        return self.text_cfg.get("hidden_act", "quick_gelu")

    @property
    def text2_act(self) -> str:
        # SDXL tower 2 (OpenCLIP bigG) ships hidden_act="gelu".
        return self.text2_cfg.get("hidden_act", "gelu")


def load_diffusers_checkpoint(root: str, dtype: Optional[torch.dtype] = None
                              ) -> DiffusersCheckpoint:
    """Read a local snapshot dir. ``dtype`` (e.g. torch.bfloat16) casts the
    UNet and VAE weights at load; the text towers stay float32 (they run a
    few times per edit, and the embeddings they make are float32). Missing
    parts come back as None rather than raising, so a UNet-only dir still
    serves midu feature extraction."""
    unet_cfg = unet_config_from_json(_read_config(os.path.join(root, "unet")))
    is_xl = unet_cfg.addition_embed_type == "text_time"
    vae_cfg = vae_config_from_json(_read_config(os.path.join(root, "vae")), is_xl)

    def read(sub: str, cast: Optional[torch.dtype]) -> Optional[StateDict]:
        p = _find_weights(os.path.join(root, sub))
        return normalize_state_dict(load_state_dict_file(p), cast) if p else None

    unet_state, vae_state = read("unet", dtype), read("vae", dtype)
    text_state = read("text_encoder", torch.float32)
    text2_state = read("text_encoder_2", torch.float32)

    merges = os.path.join(root, "tokenizer", "merges.txt")
    merges_path = merges if os.path.exists(merges) else None
    if merges_path and not os.environ.get("RGIE_CLIP_BPE_PATH"):
        # Register the checkpoint's own vocabulary so tokenize() uses the real BPE.
        os.environ["RGIE_CLIP_BPE_PATH"] = merges_path
        from rgie_tpu_torch.diffusion import text_encoder as TE

        TE._BPE = None  # drop a cached hash-fallback decision
    return DiffusersCheckpoint(unet_cfg, unet_state, vae_cfg, vae_state, text_state, text2_state,
                               merges_path,
                               text_cfg=_read_config(os.path.join(root, "text_encoder")),
                               text2_cfg=_read_config(os.path.join(root, "text_encoder_2")))
