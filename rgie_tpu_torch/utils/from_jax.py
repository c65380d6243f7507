"""Flax parameter trees -> torch state dicts for the port's modules.

The inverses of the converters in ``rgie_tpu/utils/torch_convert.py``. The
port's modules use torchvision and OpenAI-CLIP names, so the reference's own
checkpoints load directly; these functions move weights the other way, from
a JAX model (arrays in, e.g. ``np.asarray`` of its variables) to the port.
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
