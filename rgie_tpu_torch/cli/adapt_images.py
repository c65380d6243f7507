"""Diffusion dataset editing CLI on PyTorch: port of the single-image branch
of ``scripts/adapt_images.py`` (reference entry point ``src/adapt_images.py``).

    python -m rgie_tpu_torch.cli.adapt_images --data-dir DIR --scale sd \\
        --input-size 1024 --device cuda

Iterates a captions dataset; per image: score the original through the midu
regressor, VAE-encode, DDIM-invert with the empty prompt, optionally run the
null-text optimization, resample with classifier-free plus midu classifier
guidance, VAE-decode, save and rescore.

Without downloaded SD weights every model is a random-weight stand-in drawn
from ``--seed`` (``--scale tiny`` runs the whole flow on a small UNet/VAE;
``--scale sd`` is SD-2.1 width). Runs on one device; ``--device cuda`` (the
default) fails when CUDA is missing, and the CPU is used only for ``--device
cpu``. At ``--scale sd --input-size 1024`` the UNet's top-level
self-attention and the VAE's mid-block attention run through the
flash-attention CUDA kernels.

Options of later slices are accepted and raise, naming the slice: ``--scale
sdxl``, ``--scheduler dpm``, ``--vae-tile``, ``--diffusers-dir`` (slice C2,
the SDXL edit end to end), ``--batch > 1`` and ``--segment`` (slice C2's
batched and segmented edits).
"""

from __future__ import annotations

import argparse
import os
from typing import NamedTuple, Optional, Sequence

import torch

from rgie_tpu_torch.adapt.adapter import ImageAdapter, ImageScorer, OutputImageManager
from rgie_tpu_torch.config import AdaptConfig, GuidanceConfig
from rgie_tpu_torch.diffusion import schedulers as SCH
from rgie_tpu_torch.diffusion.pipeline import InversionResamplingPipeline
from rgie_tpu_torch.diffusion.text_encoder import (PromptEncoder, TextTowerConfig,
                                                   create_sd_prompt_encoder)
from rgie_tpu_torch.diffusion.unet import UNetConfig, create_unet
from rgie_tpu_torch.diffusion.vae import VaeConfig, create_vae


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--midu-ckpt", default=None, help="torch midu classifier checkpoint")
    ap.add_argument("--diffusers-dir", default=None, help="(slice C2) local diffusers snapshot")
    ap.add_argument("--scale", choices=("tiny", "sd", "sdxl"), default="tiny")
    ap.add_argument("--num-steps", type=int, default=50)
    ap.add_argument("--scheduler", choices=("ddim", "dpm"), default="ddim")
    ap.add_argument("--end-iteration", type=int, default=None)
    ap.add_argument("--cfg-scale", type=float, default=2.0)
    ap.add_argument("--clf-scale", type=float, default=0.2)
    ap.add_argument("--reference-value", type=float, default=None,
                    help="alpha offset on the original VA (GuidanceConfig.reference_value)")
    ap.add_argument("--no-nto", action="store_true")
    ap.add_argument("--use-caption", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=1, help="(slice C2) > 1: the batched edit")
    ap.add_argument("--remat", action="store_true",
                    help="recompute UNet activations on the differentiated paths (less "
                         "memory at the cost of one extra forward)")
    ap.add_argument("--segment", type=int, default=0, metavar="K", help="(slice C2)")
    ap.add_argument("--remat-mode", choices=("call", "block"), default="block",
                    help="with --remat: 'block' recomputes each UNet res/attn block (peak = "
                         "boundaries + one block); 'call' wraps the whole UNet call")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--input-size", type=int, default=None)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default=None,
                    help="the UNet's and the VAE's type (default: float32 for tiny, bfloat16 "
                         "for sd); the text tower and the embeddings stay float32")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--vae-tile", type=int, default=None, help="(slice C2) tiled VAE")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def check_supported(args) -> None:
    """Raise for the options that later slices bring."""
    later = [
        (args.scale == "sdxl", "--scale sdxl", "slice C2 (the SDXL edit end to end, with the "
                                               "second text tower)"),
        (args.scheduler == "dpm", "--scheduler dpm", "slice C2 (the table and sigma-space "
                                                     "DPM-Solver++ schedulers)"),
        (args.batch > 1, "--batch > 1", "slice C2 (diffusion/batched.py)"),
        (args.segment > 0, "--segment", "slice C2 (diffusion/segmented.py)"),
        (args.vae_tile is not None, "--vae-tile", "slice C2 (the tiled VAE transport)"),
        (args.diffusers_dir is not None, "--diffusers-dir", "slice C2 (diffusion/load.py)"),
    ]
    for asked, flag, slice_name in later:
        if asked:
            raise NotImplementedError(f"{flag} is not ported yet: it comes with {slice_name}")


class EditStack(NamedTuple):
    pipe: InversionResamplingPipeline
    prompt_encoder: PromptEncoder
    input_size: int


def build_models(args, generator: torch.Generator, device: torch.device) -> EditStack:
    """The frozen UNet, VAE, midu classifier and text tower on ``device``:
    random stand-ins drawn from ``generator`` (the midu from ``--midu-ckpt``
    where that file exists), with the DDIM schedule of ``--num-steps``."""
    from rgie_tpu_torch.models.midu import create_midu

    check_supported(args)
    if args.scale == "tiny":
        input_size = args.input_size or 64
        unet_cfg, vae_cfg = UNetConfig.tiny(), VaeConfig.tiny()
        tower_cfg = TextTowerConfig.tiny()
    else:
        input_size = args.input_size or 512
        unet_cfg, vae_cfg = UNetConfig.sd21(), VaeConfig.sd()
        tower_cfg = TextTowerConfig.open_clip_vit_h()
    dtype_name = args.dtype or ("float32" if args.scale == "tiny" else "bfloat16")
    dtype = torch.bfloat16 if dtype_name == "bfloat16" else torch.float32

    unet = create_unet(generator, unet_cfg, dtype=dtype,
                       block_remat=args.remat and args.remat_mode == "block")
    vae = create_vae(generator, vae_cfg, dtype=dtype)
    midu = create_midu(generator, is_sdxl=False, in_channels=unet_cfg.block_out_channels[-1])
    if args.midu_ckpt and os.path.exists(args.midu_ckpt):
        from rgie_tpu_torch.utils.checkpoint import load_torch_state_dict

        midu.load_state_dict(load_torch_state_dict(args.midu_ckpt), strict=True)
        print(f"loaded midu classifier from {args.midu_ckpt}")
    # The text tower and every embedding stay float32 whatever --dtype says,
    # as in the JAX package (a bfloat16 UNet with float32 embedding masters):
    # null-text optimization's Adam steps of lr <= 1e-2 are at or below one
    # bfloat16 step of an entry of size 1.
    prompt_encoder = create_sd_prompt_encoder(generator, tower_cfg)

    pipe = InversionResamplingPipeline(
        unet=unet.to(device), vae=vae.to(device), sched=SCH.make_schedule(args.num_steps),
        midu_model=midu.to(device), is_xl=False,
        remat_unet=args.remat and args.remat_mode == "call", scheduler_type=args.scheduler)
    prompt_encoder.tower1.to(device)
    return EditStack(pipe=pipe, prompt_encoder=prompt_encoder, input_size=input_size)


def make_adapter(stack: EditStack, out_dir: str):
    """The scorer, the output manager and the per-image adapter over a stack."""
    enc = stack.prompt_encoder

    def embeds_fn(prompt, negative):
        return enc.encode_sd(prompt, negative, do_cfg=False)

    def cfg_embeds_fn(prompt, negative):
        return enc.encode_sd(prompt, negative, do_cfg=True)

    scorer = ImageScorer(pipe=stack.pipe, embeds_fn=embeds_fn)
    manager = OutputImageManager(scorer=scorer, output_path=out_dir)
    adapter = ImageAdapter(pipe=stack.pipe, scorer=scorer, embeds_fn=embeds_fn,
                           cfg_embeds_fn=cfg_embeds_fn, input_size=stack.input_size)
    return adapter, manager


def make_configs(args):
    gcfg = GuidanceConfig(clf_scale=args.clf_scale, cfg_scale=args.cfg_scale,
                          reference_value=args.reference_value, is_nto=not args.no_nto,
                          use_caption=args.use_caption)
    acfg = AdaptConfig(num_inversion_steps=args.num_steps, num_inference_steps=args.num_steps,
                       end_iteration=args.end_iteration, is_xl=False)
    return gcfg, acfg


def adapt_image(adapter: ImageAdapter, manager: OutputImageManager, image_path: str,
                gcfg: GuidanceConfig, acfg: AdaptConfig, caption: str = ""):
    """One image of the CLI: ``ImageAdapter.adapt`` from the file at
    ``image_path`` (score, invert, optimize, resample, decode, save, rescore).
    Returns ``{label: image (1, H, W, 3) in [0, 1]}``."""
    return adapter.adapt(image_path, gcfg, manager, acfg.resolved_end_iteration(), caption)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    from rgie_tpu_torch.device import resolve_device

    device = resolve_device(args.device)

    from rgie_tpu_torch.config import DATA_DIR, OUT_DIR
    from rgie_tpu_torch.data import CaptionFeedDataset, first_caption

    stack = build_models(args, torch.Generator().manual_seed(args.seed), device)
    adapter, manager = make_adapter(stack, args.out_dir or str(OUT_DIR / "adapt_images"))
    gcfg, acfg = make_configs(args)

    dataset = CaptionFeedDataset(args.data_dir or str(DATA_DIR))
    n = len(dataset) if args.limit is None else min(args.limit, len(dataset))
    for i in range(n):
        _, (name, path, captions) = dataset[i]
        print(f"[ {i + 1} / {n} ]: {name}\n")
        adapt_image(adapter, manager, path, gcfg, acfg, first_caption(captions))


if __name__ == "__main__":
    main()
