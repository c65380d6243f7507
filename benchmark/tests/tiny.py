"""Tiny configurations with the published block structures, for driving the
harness on the CPU in the tests."""

from __future__ import annotations

import copy

SD_UNET = {"in_channels": 4, "out_channels": 4, "block_out_channels": [32, 64],
           "down_block_types": ["CrossAttnDownBlock2D", "DownBlock2D"],
           "up_block_types": ["UpBlock2D", "CrossAttnUpBlock2D"], "layers_per_block": 1,
           "transformer_layers_per_block": [1, 1], "attention_head_dim": [2, 4],
           "cross_attention_dim": 32, "norm_num_groups": 4}
XL_UNET = dict(SD_UNET, down_block_types=["DownBlock2D", "CrossAttnDownBlock2D"],
               up_block_types=["CrossAttnUpBlock2D", "UpBlock2D"],
               transformer_layers_per_block=[1, 2], addition_embed_type="text_time",
               addition_time_embed_dim=8, projection_class_embeddings_input_dim=16 + 6 * 8)
VAE = {"in_channels": 3, "out_channels": 3, "latent_channels": 4, "block_out_channels": [8, 16],
       "layers_per_block": 1, "norm_num_groups": 4, "scaling_factor": 0.18215}
TEACHER = {"network": "resnet50", "num_classes": 4, "input_size": 40, "crop_size": 32,
           "crops": 10}


def config(xl: bool = False) -> dict:
    """SD's layout at 64 px (DDIM), or SDXL's at 128 px (karras DPM; the
    SDXL midu reads a 32 x 32 mid block); 2 steps, 2 inner steps, float32."""
    return copy.deepcopy({
        "name": "tiny-xl" if xl else "tiny", "unet": XL_UNET if xl else SD_UNET, "vae": VAE,
        "text_len": 8, "resolution": 128 if xl else 64,
        "scheduler": "dpm_karras" if xl else "ddim", "num_inference_steps": 2,
        "guidance_scale": 2.0, "clf_scale": 0.2, "num_inner_steps": 2, "nto_epsilon": 1e-5,
        "teacher": TEACHER, "dtype": {"unet_vae": "float32"}})


def cell(name: str, limits: dict, follow_program: bool = False) -> dict:
    return {"name": name, "config": name, "traffic": name, "chips": 1,
            "follow_program": follow_program, "limits": dict(limits)}
