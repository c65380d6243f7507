"""Flax parameter trees -> torch state dicts for the port's modules.

The inverses of the converters in ``rgie_tpu/utils/torch_convert.py``. The
port's modules use torchvision, OpenAI-CLIP, diffusers and HF-transformers
names, so the reference's own checkpoints load directly; these functions move
weights the other way, from a JAX model (arrays in, e.g. ``np.asarray`` of
its variables) to the port.
Each returns a ``state_dict`` of float32 tensors that ``load_state_dict(...,
strict=True)`` takes.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch

from rgie_tpu_torch.models.discriminators import final_conv_dim, pixel_discriminator_arch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(kernel) -> torch.Tensor:
    """HWIO -> OIHW."""
    return _t(np.asarray(kernel).transpose(3, 2, 0, 1))


def _dense(kernel) -> torch.Tensor:
    """(in, out) -> (out, in)."""
    return _t(np.asarray(kernel).T)


def resnet_state_dict(flax_variables: Mapping[str, Any],
                      stage_sizes: Sequence[int] = (3, 4, 6, 3)) -> Dict[str, torch.Tensor]:
    """{'params', 'batch_stats'} of ``rgie_tpu.models.resnet.ResNet`` ->
    torchvision ResNet state dict (inverse of ``convert_resnet50``)."""
    params, stats = flax_variables["params"], flax_variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}

    def bn(dst, p, s):
        sd[f"{dst}.weight"] = _t(p["scale"])
        sd[f"{dst}.bias"] = _t(p["bias"])
        sd[f"{dst}.running_mean"] = _t(s["mean"])
        sd[f"{dst}.running_var"] = _t(s["var"])
        sd[f"{dst}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)

    sd["conv1.weight"] = _conv(params["conv1"]["kernel"])
    bn("bn1", params["bn1"], stats["bn1"])
    for i, blocks in enumerate(stage_sizes):
        for j in range(blocks):
            src, dst = f"layer{i + 1}_{j}", f"layer{i + 1}.{j}"
            p, s = params[src], stats[src]
            for k in (1, 2, 3):
                sd[f"{dst}.conv{k}.weight"] = _conv(p[f"conv{k}"]["kernel"])
                bn(f"{dst}.bn{k}", p[f"bn{k}"], s[f"bn{k}"])
            if "downsample_conv" in p:
                sd[f"{dst}.downsample.0.weight"] = _conv(p["downsample_conv"]["kernel"])
                bn(f"{dst}.downsample.1", p["downsample_bn"], s["downsample_bn"])
    sd["fc.weight"] = _dense(params["fc"]["kernel"])
    sd["fc.bias"] = _t(params["fc"]["bias"])
    return sd


def emonet_state_dict(flax_variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """{'params', 'batch_stats'} of ``rgie_tpu.models.emonet.EmoNet`` (a
    one-output ResNet-50) -> a checkpoint under the reference's EmoNet names
    (inverse of ``convert_emonet_checkpoint``), as ``models.emonet.load_emonet``
    and ``models.loader.load_va_loss`` read it."""
    from rgie_tpu_torch.models.emonet import to_reference_keys

    return to_reference_keys(resnet_state_dict(flax_variables))


def clip_visual_state_dict(flax_params: Mapping[str, Any], layers: int, heads: int,
                           width: int) -> Dict[str, torch.Tensor]:
    """{'params'} of ``rgie_tpu.models.clip.VisionTransformer`` -> OpenAI
    ``visual.*`` state dict without the prefix (inverse of
    ``convert_clip_visual``): q/k/v join back into ``in_proj_weight``, the
    HWIO ``conv1_kernel`` becomes OIHW, ``proj`` stays as it is."""
    p = flax_params["params"]

    def ln(dst, src):
        return {f"{dst}.weight": _t(src["scale"]), f"{dst}.bias": _t(src["bias"])}

    sd: Dict[str, torch.Tensor] = {
        "conv1.weight": _conv(p["conv1_kernel"]),
        "class_embedding": _t(p["class_embedding"]),
        "positional_embedding": _t(p["positional_embedding"]),
        "proj": _t(p["proj"]),
        **ln("ln_pre", p["ln_pre"]), **ln("ln_post", p["ln_post"]),
    }
    for i in range(layers):
        src, dst = p[f"resblock_{i}"], f"transformer.resblocks.{i}"
        attn = src["attn"]
        # flax MHA kernels (in, heads, head_dim) -> torch (out, in) rows
        sd[f"{dst}.attn.in_proj_weight"] = torch.cat(
            [_t(np.asarray(attn[n]["kernel"]).reshape(width, width).T)
             for n in ("query", "key", "value")])
        sd[f"{dst}.attn.in_proj_bias"] = torch.cat(
            [_t(np.asarray(attn[n]["bias"]).reshape(width)) for n in ("query", "key", "value")])
        sd[f"{dst}.attn.out_proj.weight"] = _t(
            np.asarray(attn["out"]["kernel"]).reshape(width, width).T)
        sd[f"{dst}.attn.out_proj.bias"] = _t(attn["out"]["bias"])
        sd.update(ln(f"{dst}.ln_1", src["ln_1"]))
        sd.update(ln(f"{dst}.ln_2", src["ln_2"]))
        for n in ("c_fc", "c_proj"):
            sd[f"{dst}.mlp.{n}.weight"] = _dense(src["mlp"][n]["kernel"])
            sd[f"{dst}.mlp.{n}.bias"] = _t(src["mlp"][n]["bias"])
    return sd


def pixel_discriminator_state_dict(flax_variables: Mapping[str, Any], size_w: int = 480,
                                   size_h: int = 480, n_scale: int = 3) -> Dict[str, torch.Tensor]:
    """{'params'} of ``rgie_tpu.models.discriminators.PixelDiscriminator`` ->
    the reference's state dict (inverse of ``convert_pixel_discriminator``):
    the first MLP layer's input rows go back from NHWC (h, w, c) order to
    torch's channel-major flatten."""
    p = flax_variables["params"]
    n_dis, _ = pixel_discriminator_arch(size_w, size_h)
    sd: Dict[str, torch.Tensor] = {}
    for s in range(n_scale):
        for i in range(n_dis):
            sd[f"modules_features.{s}.{i}.1.weight"] = _conv(p[f"s{s}_conv{i}"]["kernel"])
            sd[f"modules_features.{s}.{i}.1.bias"] = _t(p[f"s{s}_conv{i}"]["bias"])
        c = np.asarray(p[f"s{s}_conv{n_dis - 1}"]["kernel"]).shape[-1]
        h, w = final_conv_dim(size_h, s, n_dis), final_conv_dim(size_w, s, n_dis)
        w0 = np.asarray(p[f"s{s}_fc0"]["kernel"]).T                  # (128, h*w*c)
        w0 = w0.reshape(-1, h, w, c).transpose(0, 3, 1, 2).reshape(w0.shape[0], -1)
        sd[f"modules_logs.{s}.1.weight"] = _t(w0)
        sd[f"modules_logs.{s}.1.bias"] = _t(p[f"s{s}_fc0"]["bias"])
        sd[f"modules_logs.{s}.3.weight"] = _dense(p[f"s{s}_fc1"]["kernel"])
        sd[f"modules_logs.{s}.3.bias"] = _t(p[f"s{s}_fc1"]["bias"])
    return sd


# ---------------------------------------------------------------------------
# Diffusion stack: UNet2DCondition, AutoencoderKL, the CLIP text tower, midu
# ---------------------------------------------------------------------------


def _put_conv(sd, dst, src):
    sd[f"{dst}.weight"] = _conv(src["kernel"])
    sd[f"{dst}.bias"] = _t(src["bias"])


def _put_linear(sd, dst, src):
    sd[f"{dst}.weight"] = _dense(src["kernel"])
    if "bias" in src:
        sd[f"{dst}.bias"] = _t(src["bias"])


def _put_norm(sd, dst, src):
    sd[f"{dst}.weight"] = _t(src["scale"])
    sd[f"{dst}.bias"] = _t(src["bias"])


def _put_resnet(sd, dst, src):
    _put_norm(sd, f"{dst}.norm1", src["norm1"]["norm"])
    _put_conv(sd, f"{dst}.conv1", src["conv1"])
    _put_norm(sd, f"{dst}.norm2", src["norm2"]["norm"])
    _put_conv(sd, f"{dst}.conv2", src["conv2"])
    if "time_emb_proj" in src:
        _put_linear(sd, f"{dst}.time_emb_proj", src["time_emb_proj"])
    if "conv_shortcut" in src:
        _put_conv(sd, f"{dst}.conv_shortcut", src["conv_shortcut"])


def _put_transformer2d(sd, dst, src, depth: int):
    _put_norm(sd, f"{dst}.norm", src["norm"]["norm"])
    _put_linear(sd, f"{dst}.proj_in", src["proj_in"])
    _put_linear(sd, f"{dst}.proj_out", src["proj_out"])
    for k in range(depth):
        b, blk = f"{dst}.transformer_blocks.{k}", src[f"block_{k}"]
        for n in ("norm1", "norm2", "norm3"):
            _put_norm(sd, f"{b}.{n}", blk[n])
        for a in ("attn1", "attn2"):
            for proj in ("to_q", "to_k", "to_v"):
                _put_linear(sd, f"{b}.{a}.{proj}", blk[a][proj])
            _put_linear(sd, f"{b}.{a}.to_out.0", blk[a]["to_out"])
        _put_linear(sd, f"{b}.ff.net.0.proj", blk["ff"]["proj_in"])
        _put_linear(sd, f"{b}.ff.net.2", blk["ff"]["proj_out"])


def unet_state_dict(flax_variables: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """{'params'} of ``rgie_tpu.diffusion.unet.UNet2DCondition`` -> diffusers
    ``UNet2DConditionModel`` state dict (inverse of ``convert_unet_diffusers``).
    ``cfg`` is the UNetConfig of either package."""
    p = flax_variables["params"]
    sd: Dict[str, torch.Tensor] = {}
    _put_conv(sd, "conv_in", p["conv_in"])
    _put_linear(sd, "time_embedding.linear_1", p["time_embed_0"])
    _put_linear(sd, "time_embedding.linear_2", p["time_embed_2"])
    _put_norm(sd, "conv_norm_out", p["norm_out"]["norm"])
    _put_conv(sd, "conv_out", p["conv_out"])
    if cfg.addition_embed_type == "text_time":
        _put_linear(sd, "add_embedding.linear_1", p["add_embed_0"])
        _put_linear(sd, "add_embedding.linear_2", p["add_embed_2"])
    n_blocks = len(cfg.block_out_channels)
    for bi, btype in enumerate(cfg.down_block_types):
        for li in range(cfg.layers_per_block):
            _put_resnet(sd, f"down_blocks.{bi}.resnets.{li}", p[f"down_{bi}_res_{li}"])
            if btype == "CrossAttnDownBlock2D":
                _put_transformer2d(sd, f"down_blocks.{bi}.attentions.{li}",
                                   p[f"down_{bi}_attn_{li}"],
                                   cfg.transformer_layers_per_block[bi])
        if bi < n_blocks - 1:
            _put_conv(sd, f"down_blocks.{bi}.downsamplers.0.conv",
                      p[f"down_{bi}_downsample"]["conv"])
    _put_resnet(sd, "mid_block.resnets.0", p["mid_res_0"])
    _put_transformer2d(sd, "mid_block.attentions.0", p["mid_attn"],
                       cfg.transformer_layers_per_block[-1])
    _put_resnet(sd, "mid_block.resnets.1", p["mid_res_1"])
    rev_tf = tuple(reversed(cfg.transformer_layers_per_block))
    for bi, btype in enumerate(cfg.up_block_types):
        for li in range(cfg.layers_per_block + 1):
            _put_resnet(sd, f"up_blocks.{bi}.resnets.{li}", p[f"up_{bi}_res_{li}"])
            if btype == "CrossAttnUpBlock2D":
                _put_transformer2d(sd, f"up_blocks.{bi}.attentions.{li}",
                                   p[f"up_{bi}_attn_{li}"], rev_tf[bi])
        if bi < n_blocks - 1:
            _put_conv(sd, f"up_blocks.{bi}.upsamplers.0.conv", p[f"up_{bi}_upsample"]["conv"])
    return sd


def controlnet_state_dict(flax_variables: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """{'params'} of ``rgie_tpu.diffusion.controlnet.ControlNet`` -> the
    port's ``ControlNet`` state dict (diffusers' ``ControlNetModel`` names):
    the copied down and mid blocks as in ``unet_state_dict``, the conditioning
    embedding's ``block_{k}`` convs as ``blocks.{k}``, the zero convs
    ``zero_conv_{i}`` / ``zero_conv_mid`` as ``controlnet_down_blocks.{i}`` /
    ``controlnet_mid_block``."""
    p = flax_variables["params"]
    sd: Dict[str, torch.Tensor] = {}
    _put_conv(sd, "conv_in", p["conv_in"])
    _put_linear(sd, "time_embedding.linear_1", p["time_embed_0"])
    _put_linear(sd, "time_embedding.linear_2", p["time_embed_2"])
    if cfg.addition_embed_type == "text_time":
        _put_linear(sd, "add_embedding.linear_1", p["add_embed_0"])
        _put_linear(sd, "add_embedding.linear_2", p["add_embed_2"])
    emb = p["cond_embedding"]
    _put_conv(sd, "controlnet_cond_embedding.conv_in", emb["conv_in"])
    _put_conv(sd, "controlnet_cond_embedding.conv_out", emb["conv_out"])
    for k in range(sum(1 for name in emb if str(name).startswith("block_"))):
        _put_conv(sd, f"controlnet_cond_embedding.blocks.{k}", emb[f"block_{k}"])
    n_blocks = len(cfg.block_out_channels)
    for bi, btype in enumerate(cfg.down_block_types):
        for li in range(cfg.layers_per_block):
            _put_resnet(sd, f"down_blocks.{bi}.resnets.{li}", p[f"down_{bi}_res_{li}"])
            if btype == "CrossAttnDownBlock2D":
                _put_transformer2d(sd, f"down_blocks.{bi}.attentions.{li}",
                                   p[f"down_{bi}_attn_{li}"],
                                   cfg.transformer_layers_per_block[bi])
        if bi < n_blocks - 1:
            _put_conv(sd, f"down_blocks.{bi}.downsamplers.0.conv",
                      p[f"down_{bi}_downsample"]["conv"])
    _put_resnet(sd, "mid_block.resnets.0", p["mid_res_0"])
    _put_transformer2d(sd, "mid_block.attentions.0", p["mid_attn"],
                       cfg.transformer_layers_per_block[-1])
    _put_resnet(sd, "mid_block.resnets.1", p["mid_res_1"])
    for i in range(sum(1 for name in p if str(name).startswith("zero_conv_")) - 1):
        _put_conv(sd, f"controlnet_down_blocks.{i}", p[f"zero_conv_{i}"])
    _put_conv(sd, "controlnet_mid_block", p["zero_conv_mid"])
    return sd


def vae_state_dict(flax_variables: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """{'params'} of ``rgie_tpu.diffusion.vae.AutoencoderKL`` -> diffusers
    ``AutoencoderKL`` state dict (inverse of ``convert_vae_diffusers``): the
    quant convs move back from the encoder and decoder to the top level."""
    enc, dec = flax_variables["params"]["encoder"], flax_variables["params"]["decoder"]
    sd: Dict[str, torch.Tensor] = {}

    def put_mid(dst, src):
        _put_resnet(sd, f"{dst}.resnets.0", src["mid_res_0"])
        attn = src["mid_attn"]
        _put_norm(sd, f"{dst}.attentions.0.group_norm", attn["norm"]["norm"])
        for proj in ("to_q", "to_k", "to_v"):
            _put_linear(sd, f"{dst}.attentions.0.{proj}", attn[proj])
        _put_linear(sd, f"{dst}.attentions.0.to_out.0", attn["to_out"])
        _put_resnet(sd, f"{dst}.resnets.1", src["mid_res_1"])

    n_blocks = len(cfg.block_out_channels)
    _put_conv(sd, "encoder.conv_in", enc["conv_in"])
    _put_norm(sd, "encoder.conv_norm_out", enc["norm_out"]["norm"])
    _put_conv(sd, "encoder.conv_out", enc["conv_out"])
    _put_conv(sd, "quant_conv", enc["quant_conv"])
    put_mid("encoder.mid_block", enc)
    for bi in range(n_blocks):
        for li in range(cfg.layers_per_block):
            _put_resnet(sd, f"encoder.down_blocks.{bi}.resnets.{li}", enc[f"down_{bi}_res_{li}"])
        if bi < n_blocks - 1:
            _put_conv(sd, f"encoder.down_blocks.{bi}.downsamplers.0.conv",
                      enc[f"down_{bi}_downsample"])
    _put_conv(sd, "post_quant_conv", dec["post_quant_conv"])
    _put_conv(sd, "decoder.conv_in", dec["conv_in"])
    _put_norm(sd, "decoder.conv_norm_out", dec["norm_out"]["norm"])
    _put_conv(sd, "decoder.conv_out", dec["conv_out"])
    put_mid("decoder.mid_block", dec)
    for bi in range(n_blocks):
        for li in range(cfg.layers_per_block + 1):
            _put_resnet(sd, f"decoder.up_blocks.{bi}.resnets.{li}", dec[f"up_{bi}_res_{li}"])
        if bi < n_blocks - 1:
            _put_conv(sd, f"decoder.up_blocks.{bi}.upsamplers.0.conv", dec[f"up_{bi}_upsample"])
    return sd


def clip_text_state_dict(flax_variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """{'params'} of ``rgie_tpu.diffusion.text_encoder.TextEncoderHidden`` ->
    HF ``CLIPTextModel(WithProjection)`` state dict, ``text_model.`` prefix
    included (inverse of ``convert_clip_text_hf``)."""
    p = flax_variables["params"]
    width = np.asarray(p["positional_embedding"]).shape[1]
    sd: Dict[str, torch.Tensor] = {
        "text_model.embeddings.token_embedding.weight": _t(p["token_embedding"]["embedding"]),
        "text_model.embeddings.position_embedding.weight": _t(p["positional_embedding"]),
    }
    _put_norm(sd, "text_model.final_layer_norm", p["ln_final"])
    layers = sum(1 for k in p if str(k).startswith("resblock_"))
    for i in range(layers):
        src, dst = p[f"resblock_{i}"], f"text_model.encoder.layers.{i}"
        _put_norm(sd, f"{dst}.layer_norm1", src["ln_1"])
        _put_norm(sd, f"{dst}.layer_norm2", src["ln_2"])
        attn = src["attn"]
        for flax_name, hf_name in (("query", "q_proj"), ("key", "k_proj"), ("value", "v_proj")):
            # flax MHA kernels (in, heads, head_dim) -> torch (out, in)
            sd[f"{dst}.self_attn.{hf_name}.weight"] = _t(
                np.asarray(attn[flax_name]["kernel"]).reshape(width, width).T)
            sd[f"{dst}.self_attn.{hf_name}.bias"] = _t(
                np.asarray(attn[flax_name]["bias"]).reshape(width))
        sd[f"{dst}.self_attn.out_proj.weight"] = _t(
            np.asarray(attn["out"]["kernel"]).reshape(width, width).T)
        sd[f"{dst}.self_attn.out_proj.bias"] = _t(attn["out"]["bias"])
        _put_linear(sd, f"{dst}.mlp.fc1", src["mlp"]["c_fc"])
        _put_linear(sd, f"{dst}.mlp.fc2", src["mlp"]["c_proj"])
    if "text_projection" in p:
        sd["text_projection.weight"] = _dense(p["text_projection"])
    return sd


def midu_state_dict(flax_variables: Mapping[str, Any], is_sdxl: bool = False
                    ) -> Dict[str, torch.Tensor]:
    """{'params'} of ``rgie_tpu.models.midu.MiduSD`` / ``MiduSDXL`` -> the
    reference's ``nn.Sequential`` state dict (inverse of ``convert_midu``):
    the first linear layer's input rows go back from the NHWC (h, w, c)
    flatten to torch's channel-major one."""
    p = flax_variables["params"]
    conv_ixs = (0, 3, 6, 9) if is_sdxl else (0, 3)
    lin_ixs = (13, 15) if is_sdxl else (7, 9)
    sd: Dict[str, torch.Tensor] = {}
    for n, i in enumerate(conv_ixs):
        _put_conv(sd, str(i), p[f"conv_{n}"])
    flat_c = np.asarray(p[f"conv_{len(conv_ixs) - 1}"]["kernel"]).shape[-1]
    for n, i in enumerate(lin_ixs):
        w = np.asarray(p[f"dense_{n}"]["kernel"]).T  # (out, in)
        if n == 0:
            w = w.reshape(w.shape[0], 2, 2, flat_c).transpose(0, 3, 1, 2).reshape(w.shape[0], -1)
        sd[f"{i}.weight"] = _t(w)
        sd[f"{i}.bias"] = _t(p[f"dense_{n}"]["bias"])
    return sd


def munit_state_dict(flax_variables: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """{'params'} of ``rgie_tpu.models.munit.AutoEncoder`` (one domain) ->
    imaginaire-keyed ``rgie_tpu_torch.models.munit.AutoEncoder`` state dict
    (inverse of ``convert_munit_autoencoder``). ``cfg`` is the
    ``MunitGenConfig``."""
    p = flax_variables["params"]
    sd: Dict[str, torch.Tensor] = {}

    def block(dst, src):
        _put_conv(sd, f"{dst}.layers.conv", src["conv"])
        norm = src.get("norm")
        if norm is not None and "fc" in norm:
            _put_linear(sd, f"{dst}.layers.norm.fc.layers.conv", norm["fc"])
        elif norm is not None:
            _put_norm(sd, f"{dst}.layers.norm", norm)

    se, n_style = p["style_encoder"], 1 + cfg.num_downsamples_style
    for i in range(n_style):
        block(f"style_encoder.model.{i}", se[f"layer_{i}"])
    sd[f"style_encoder.model.{n_style + 1}.weight"] = _dense(se["fc"]["kernel"])[:, :, None, None]
    sd[f"style_encoder.model.{n_style + 1}.bias"] = _t(se["fc"]["bias"])

    ce, n_content = p["content_encoder"], 1 + cfg.num_downsamples_content
    for i in range(n_content):
        block(f"content_encoder.model.{i}", ce[f"layer_{i}"])
    de, r_blocks = p["decoder"], cfg.num_res_blocks
    for r in range(r_blocks):
        for b in (0, 1):
            block(f"content_encoder.model.{n_content + r}.conv_block_{b}",
                  ce[f"res_{r}"][f"conv_block_{b}"])
            block(f"decoder.decoder.{r}.conv_block_{b}", de[f"res_{r}"][f"conv_block_{b}"])
    for k in range(cfg.num_downsamples_content):
        block(f"decoder.decoder.{r_blocks + 2 * k + 1}", de[f"up_{k}"])
    block(f"decoder.decoder.{r_blocks + 2 * cfg.num_downsamples_content + 1}", de["out"])
    for i in range(cfg.num_mlp_blocks):
        _put_linear(sd, f"mlp.model.{i}.layers.conv", p["mlp"][f"linear_{i}"])
    return sd


def multires_patch_discriminator_state_dict(flax_variables: Mapping[str, Any],
                                            num_layers: int = 5) -> Dict[str, torch.Tensor]:
    """{'params'} of ``rgie_tpu.models.discriminators.MultiResPatchDiscriminator``
    -> the port's imaginaire-keyed state dict (inverse of
    ``convert_multires_patch_discriminator``)."""
    p = flax_variables["params"]
    sd: Dict[str, torch.Tensor] = {}
    for i in range(len(p)):
        for n in range(num_layers + 2):
            _put_conv(sd, f"discriminators.{i}.layer{n}.0.layers.conv", p[f"dis_{i}"][f"layer{n}"])
    return sd
