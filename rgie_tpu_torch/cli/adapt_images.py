"""Diffusion dataset editing CLI on PyTorch: port of
``scripts/adapt_images.py`` (reference entry point ``src/adapt_images.py``).

    python -m rgie_tpu_torch.cli.adapt_images --data-dir DIR --scale sd \\
        --input-size 1024 --device cuda

    python -m rgie_tpu_torch.cli.adapt_images --data-dir DIR --scale sdxl \
        --scheduler dpm --device cuda

Iterates a captions dataset ``--batch`` images at a time; per image: score
the original through the midu regressor, VAE-encode, invert with the empty
prompt (DDIM, or DPM-Solver++ 2M), optionally run the null-text
optimization, resample with classifier-free plus midu classifier guidance,
VAE-decode, rescore and save.

Without ``--diffusers-dir`` (a local diffusers snapshot) every model is a
random-weight stand-in drawn from ``--seed``: ``--scale tiny`` runs the whole
flow on a small UNet/VAE, ``--scale sd`` is SD-2.1 width (512 px by
default), ``--scale sdxl`` SDXL base width (1024 px, two text towers, pooled
embeddings and micro-conditioning time ids). With ``--scheduler dpm`` the
SDXL edit steps over karras sigmas (lu lambdas asked for too, as in the
reference, where karras takes precedence), forward and inverse; the SD edit
over the alphas table. ``--device cuda`` (the default) fails when CUDA is
missing, and the CPU is used only for ``--device cpu``.
The UNet's self-attention over 256 positions or more (every level but SD's
mid block at 512 px) runs through the flash-attention CUDA kernels, and at
1024 px the VAE's mid-block attention (16384 positions) too.

Every batch size, the default 1 too, runs the batched edit
(``diffusion/batched.py``): every UNet and VAE call takes the batch's images
together, and each image's result is its single-image edit's. ``--segment
K`` runs it in windows of K diffusion steps (``diffusion/segmented.py``),
with the same results. Differences from the JAX CLI, on purpose: one image
at a time goes through the same program (the JAX CLI runs its per-image
adapter there and ignores ``--segment``), the last batch of a dataset is not
padded to B images (the padding changes no image's result), and a process
runs on one device (JAX's shards a batch over the devices of a mesh).

Several processes (``torchrun --nproc_per_node N``, one card each):
``--batch`` is the global batch and must divide over them; rank p edits feed
items p, p+N, ... (``ShardedView``), ``--batch / N`` at a time, and writes
their outputs.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from rgie_tpu_torch.adapt.adapter import ImageAdapter, ImageScorer, cond_row, transform_image
from rgie_tpu_torch.config import AdaptConfig, GuidanceConfig
from rgie_tpu_torch.diffusion import schedulers as SCH
from rgie_tpu_torch.diffusion.pipeline import InversionResamplingPipeline, SdxlCond
from rgie_tpu_torch.diffusion.text_encoder import (PromptEncoder, TextEncoderHidden,
                                                   TextTowerConfig, create_sd_prompt_encoder,
                                                   create_sdxl_prompt_encoder,
                                                   tower_config_from_params)
from rgie_tpu_torch.diffusion.unet import UNet2DCondition, UNetConfig, create_unet
from rgie_tpu_torch.diffusion.vae import AutoencoderKL, VaeConfig, create_vae


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--midu-ckpt", default=None, help="torch midu classifier checkpoint")
    ap.add_argument("--diffusers-dir", default=None,
                    help="local diffusers snapshot dir (unet/ vae/ text_encoder/ ...): loads its "
                         "weights instead of the random stand-ins")
    ap.add_argument("--scale", choices=("tiny", "sd", "sdxl"), default="tiny")
    ap.add_argument("--num-steps", type=int, default=50)
    ap.add_argument("--dpm-diffusers-exact", action="store_true",
                    help="build the DPM karras/lu sigma tables with the diffusers-exact "
                         "conventions (inference-range endpoints, appended training sigma_max "
                         "on the inverse table, first-order first inverse step)")
    ap.add_argument("--scheduler", choices=("ddim", "dpm"), default="ddim",
                    help="ddim (reference SD default) or dpm; with --scale sdxl, dpm uses karras "
                         "sigmas + lu lambdas like the reference (...XLPipeline.py:29-32)")
    ap.add_argument("--end-iteration", type=int, default=None)
    ap.add_argument("--cfg-scale", type=float, default=2.0)
    ap.add_argument("--clf-scale", type=float, default=0.2)
    ap.add_argument("--reference-value", type=float, default=None,
                    help="alpha offset on the original VA (GuidanceConfig.reference_value)")
    ap.add_argument("--no-nto", action="store_true")
    ap.add_argument("--use-caption", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=1,
                    help="edit this many images at a time (diffusion/batched.py)")
    ap.add_argument("--remat", action="store_true",
                    help="recompute UNet activations on the differentiated paths (less "
                         "memory at the cost of one extra forward)")
    ap.add_argument("--segment", type=int, default=0, metavar="K",
                    help="run the batched edit in windows of K diffusion steps chained from "
                         "the host (diffusion/segmented.py); the results are "
                         "the same")
    ap.add_argument("--remat-mode", choices=("call", "block"), default="block",
                    help="with --remat: 'block' recomputes each UNet res/attn block (peak = "
                         "boundaries + one block); 'call' wraps the whole UNet call")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--input-size", type=int, default=None)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default=None,
                    help="the UNet's and the VAE's type (default: float32 for tiny, bfloat16 "
                         "for sd and sdxl); the text towers and the embeddings stay float32")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--vae-tile", type=int, default=None,
                    help="latent tile size for tiled VAE encode/decode (diffusers enable_tiling "
                         "analog; e.g. 64 = 512 px tiles, 25%% overlap)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def load_midu_checkpoint(midu: torch.nn.Module, path: str) -> None:
    """``--midu-ckpt``: a torch state dict under the reference's keys (what
    ``cli/train_guidance_clf.py`` writes), loaded with ``strict=True``."""
    from rgie_tpu_torch.utils.checkpoint import load_torch_state_dict

    midu.load_state_dict(load_torch_state_dict(path), strict=True)
    print(f"loaded midu classifier from {path}")


class EditStack(NamedTuple):
    pipe: InversionResamplingPipeline
    prompt_encoder: PromptEncoder
    input_size: int


def _prompt_encoder(ckpt, is_xl: bool, generator: torch.Generator, tower_cfg: dict,
                    diffusers_dir: Optional[str]) -> PromptEncoder:
    """The checkpoint's text tower(s) where it has them, else random stand-ins.
    Each tower's activation comes from its config.json."""
    if ckpt is None or ckpt.text_state is None:
        if is_xl:
            return create_sdxl_prompt_encoder(generator)
        return create_sd_prompt_encoder(generator, tower_cfg)
    from rgie_tpu_torch.diffusion.load import module_from_state_dict

    def tower(state, skip_last, act):
        cfg = tower_config_from_params(state, skip_last=skip_last, act=act)
        return module_from_state_dict(lambda: TextEncoderHidden(**cfg), state)

    if not is_xl:
        return PromptEncoder(tower1=tower(ckpt.text_state, 0, ckpt.text_act))
    # Both towers must be present: an SDXL dir with only text_encoder/ would
    # otherwise fail later with an unhelpful error.
    if ckpt.text2_state is None:
        raise ValueError(f"SDXL checkpoint {diffusers_dir} has text_encoder/ but no "
                         "text_encoder_2/ weights: both towers are required for SDXL prompt "
                         "encoding")
    return PromptEncoder(tower1=tower(ckpt.text_state, 1, ckpt.text_act),
                         tower2=tower(ckpt.text2_state, 1, ckpt.text2_act))


def build_models(args, generator: torch.Generator, device: torch.device) -> EditStack:
    """The frozen UNet, VAE, midu classifier and text tower(s) on ``device``:
    the ``--diffusers-dir`` snapshot's weights, or random stand-ins drawn from
    ``generator`` (the midu from ``--midu-ckpt`` where that file exists),
    with the schedules of ``--num-steps`` and ``--scheduler``."""
    from rgie_tpu_torch.models.midu import create_midu

    if args.scale == "tiny":
        input_size = args.input_size or 64
        unet_cfg, vae_cfg = UNetConfig.tiny(), VaeConfig.tiny()
        tower_cfg, is_xl = TextTowerConfig.tiny(), False
    elif args.scale == "sd":
        input_size = args.input_size or 512
        unet_cfg, vae_cfg = UNetConfig.sd21(), VaeConfig.sd()
        tower_cfg, is_xl = TextTowerConfig.open_clip_vit_h(), False
    else:
        input_size = args.input_size or 1024
        unet_cfg, vae_cfg = UNetConfig.sdxl(), VaeConfig.sdxl()
        tower_cfg, is_xl = TextTowerConfig.clip_vit_l(), True
    dtype_name = args.dtype or ("float32" if args.scale == "tiny" else "bfloat16")
    dtype = torch.bfloat16 if dtype_name == "bfloat16" else torch.float32

    ckpt = None
    if args.diffusers_dir:
        from rgie_tpu_torch.diffusion.load import load_diffusers_checkpoint

        ckpt = load_diffusers_checkpoint(
            args.diffusers_dir, dtype=torch.float32 if args.scale == "tiny" else dtype)
        unet_cfg, vae_cfg, is_xl = ckpt.unet_cfg, ckpt.vae_cfg, ckpt.is_xl
        if args.input_size is None:
            input_size = 1024 if is_xl else 512
        print(f"loaded diffusers checkpoint from {args.diffusers_dir} "
              f"(xl={is_xl}, bpe={'real' if ckpt.merges_path else 'fallback'})")

    latent_hw = input_size // 2 ** (len(vae_cfg.block_out_channels) - 1)
    mid_hw = latent_hw // 2 ** (len(unet_cfg.block_out_channels) - 1)
    if is_xl and mid_hw != 32:
        raise ValueError(f"MiduSDXL reads 32 x 32 mid-block features; {input_size} px gives "
                         f"{mid_hw} x {mid_hw}")

    # The frozen models are made (or read) on the host, cast to the working
    # type, then moved to the device once: SDXL's UNet alone has 2.6 B
    # parameters.
    t0 = time.perf_counter()
    block_remat = args.remat and args.remat_mode == "block"
    if ckpt is not None and ckpt.unet_state is not None:
        from rgie_tpu_torch.diffusion.load import module_from_state_dict

        unet = module_from_state_dict(
            lambda: UNet2DCondition(unet_cfg, block_remat=block_remat), ckpt.unet_state)
        vae = module_from_state_dict(lambda: AutoencoderKL(vae_cfg), ckpt.vae_state)
    else:
        unet = create_unet(generator, unet_cfg, dtype=dtype, block_remat=block_remat)
        vae = create_vae(generator, vae_cfg, dtype=dtype)
    midu = create_midu(generator, is_sdxl=is_xl, in_channels=unet_cfg.block_out_channels[-1])
    if args.midu_ckpt and os.path.exists(args.midu_ckpt):
        load_midu_checkpoint(midu, args.midu_ckpt)
    # The text towers and every embedding stay float32 whatever --dtype says,
    # as in the JAX package (a bfloat16 UNet with float32 embedding masters):
    # null-text optimization's Adam steps (lr 1e-2 for SD) are at or below one
    # bfloat16 step of an entry of size 1.
    prompt_encoder = _prompt_encoder(ckpt, is_xl, generator, tower_cfg, args.diffusers_dir)
    host_s = time.perf_counter() - t0

    sched = SCH.make_schedule(args.num_steps)
    sigma_kw = {}
    if args.scheduler == "dpm" and is_xl:
        # The reference's SDXL DPM config: karras sigmas (+ lu lambdas, which
        # karras precedence masks) and the dedup'd inverse table.
        sigma_kw = {name: SCH.make_dpm_sigma_schedule(
            args.num_steps, use_karras_sigmas=True, use_lu_lambdas=True, inverse=inverse,
            diffusers_exact=args.dpm_diffusers_exact)
            for name, inverse in (("sigma_sched", False), ("sigma_sched_inv", True))}
    t0 = time.perf_counter()
    pipe = InversionResamplingPipeline(
        unet=unet.to(device), vae=vae.to(device), sched=sched, midu_model=midu.to(device),
        is_xl=is_xl, remat_unet=args.remat and args.remat_mode == "call",
        scheduler_type=args.scheduler, vae_tile=args.vae_tile, **sigma_kw)
    for tower in (prompt_encoder.tower1, prompt_encoder.tower2):
        if tower is not None:
            tower.to(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if args.scale != "tiny":
        print(f"models ({sum(p.numel() for p in unet.parameters()) / 1e9:.2f} B UNet "
              f"parameters, {dtype_name}) made on the host in {host_s:.1f} s, moved to {device} "
              f"in {time.perf_counter() - t0:.1f} s")
    return EditStack(pipe=pipe, prompt_encoder=prompt_encoder, input_size=input_size)


def make_adapter(stack: EditStack) -> ImageAdapter:
    """The prompt encoders of an edit over a stack, with its scorer."""
    enc, size = stack.prompt_encoder, stack.input_size
    added_cond_fn = None
    if stack.pipe.is_xl:
        def embeds_fn(prompt, negative):
            e, _, _ = enc.encode_sdxl(prompt, negative, image_size=size)
            return e[1:2]    # the cond row

        def cfg_embeds_fn(prompt, negative):
            e, _, _ = enc.encode_sdxl(prompt, negative, image_size=size)
            return e

        def added_cond_fn(prompt, negative):
            _, pooled, time_ids = enc.encode_sdxl(prompt, negative, image_size=size)
            return SdxlCond(text_embeds=pooled, time_ids=time_ids)
    else:
        def embeds_fn(prompt, negative):
            return enc.encode_sd(prompt, negative, do_cfg=False)

        def cfg_embeds_fn(prompt, negative):
            return enc.encode_sd(prompt, negative, do_cfg=True)

    scorer = ImageScorer(pipe=stack.pipe, embeds_fn=embeds_fn, added_cond_fn=added_cond_fn)
    return ImageAdapter(pipe=stack.pipe, scorer=scorer, embeds_fn=embeds_fn,
                        cfg_embeds_fn=cfg_embeds_fn, added_cond_fn=added_cond_fn)


def make_configs(args, is_xl: bool = False):
    gcfg = GuidanceConfig(clf_scale=args.clf_scale, cfg_scale=args.cfg_scale,
                          reference_value=args.reference_value, is_nto=not args.no_nto,
                          use_caption=args.use_caption)
    acfg = AdaptConfig(num_inversion_steps=args.num_steps, num_inference_steps=args.num_steps,
                       end_iteration=args.end_iteration, is_xl=is_xl,
                       scheduler_type=args.scheduler)
    return gcfg, acfg


def make_batched_program(args, pipe: InversionResamplingPipeline, gcfg: GuidanceConfig,
                         acfg: AdaptConfig):
    """The batched edit of ``--batch`` images, in windows of ``--segment``
    steps when that is set."""
    from rgie_tpu_torch.diffusion.batched import make_batched_edit
    from rgie_tpu_torch.diffusion.segmented import make_segmented_edit

    kwargs = dict(guidance_scale=gcfg.cfg_scale, guidance_clf_scale=gcfg.clf_scale,
                  use_nto=gcfg.is_nto, use_reference=gcfg.reference_value is not None,
                  end_iteration=acfg.resolved_end_iteration(), midu_is_minimized=not gcfg.max)
    if args.segment > 0:
        return make_segmented_edit(pipe, chunk_steps=args.segment, **kwargs)
    return make_batched_edit(pipe, **kwargs)


def batch_conds(adapter: ImageAdapter, gcfg: GuidanceConfig, captions: Sequence[str]):
    """The per-image conditioning of a batch (``BatchedConds``) from each
    image's caption: the CFG pair of the guidance prompt, the caption's
    embeddings for null-text optimization and, for SDXL, their added conds."""
    from rgie_tpu_torch.diffusion.batched import BatchedConds, stack_conds

    per_image = []
    for caption in captions:
        prompt = gcfg.prompt if not gcfg.use_caption else (caption + " " + gcfg.prompt)
        added_cfg = added_cond = added_uncond = None
        if adapter.pipe.is_xl:
            added_cfg = adapter.added_cond_fn(prompt, gcfg.negative_prompt)
            both = adapter.added_cond_fn(caption, "")
            added_uncond, added_cond = cond_row(both, 0), cond_row(both, 1)
        per_image.append(BatchedConds(
            cfg_embeds=adapter.cfg_embeds_fn(prompt, gcfg.negative_prompt),
            cond_embeds=adapter.embeds_fn(caption, ""), added_cfg=added_cfg,
            added_cond=added_cond, added_uncond=added_uncond))
    return stack_conds(per_image)


def feed_items(data_dir: str, limit: Optional[int] = None) -> List[Tuple[str, str, str]]:
    """(name, image path, first caption) of this process's share of a
    captions feed's first ``limit`` images (all without a limit): items p,
    p+N, ... of N processes (``ShardedView``), every item in one process."""
    from rgie_tpu_torch.data import CaptionFeedDataset, ShardedView, first_caption
    from rgie_tpu_torch.parallel import process_info

    dataset = ShardedView(CaptionFeedDataset(data_dir), *process_info())
    items = []
    for i in range(dataset.local_count(limit)):
        _, (name, path, captions) = dataset[i]
        items.append((name, path, first_caption(captions)))
    return items


def adapt_batches(args, stack: EditStack, adapter: ImageAdapter,
                  items: Sequence[Tuple[str, str, str]], gcfg: GuidanceConfig, acfg: AdaptConfig,
                  out_dir: str) -> List[tuple]:
    """Edit ``items``, (name, image path, caption) each, this process's share
    of ``--batch`` at a time (the last batch holds what is left: it is not
    padded). Per image: its
    name, both scores, the reconstruction error and its JPEG under
    ``out_dir/<label>/``; per batch one timing line. Returns, per batch,
    (names, ``BatchedEditOutputs``, ``RunLog``, seconds)."""
    import numpy as np
    from PIL import Image

    from rgie_tpu_torch.data.dataset import load_image_rgb
    from rgie_tpu_torch.diffusion.pipeline import RunLog
    from rgie_tpu_torch.parallel import split_batch

    pipe, scorer = stack.pipe, adapter.scorer
    local_batch = split_batch(args.batch)
    program = make_batched_program(args, pipe, gcfg, acfg)
    label = gcfg.resolved_label()
    out_sub = os.path.join(out_dir, label)
    os.makedirs(out_sub, exist_ok=True)
    empty = adapter.embeds_fn("", "")
    added_empty = None
    if pipe.is_xl:
        added_empty = cond_row(adapter.added_cond_fn("", ""), 1)

    n, done = len(items), []
    for start in range(0, n, local_batch):
        batch = items[start:start + local_batch]
        names = [name for name, _, _ in batch]
        images = torch.stack([transform_image(load_image_rgb(path), stack.input_size)[0]
                              for _, path, _ in batch]).to(pipe.device)
        conds = batch_conds(adapter, gcfg, [caption for _, _, caption in batch])
        alphas = torch.full((len(batch), 2), gcfg.reference_value or 0.0, device=pipe.device)

        log = RunLog()
        t0 = time.perf_counter()
        out = program(images, empty, conds, alphas, added_empty, log=log)
        edited = out.edited.cpu()
        dt = time.perf_counter() - t0
        orig, adapted = out.orig_score.cpu().numpy(), out.adapted_score.cpu().numpy()
        for b, name in enumerate(names):
            print(f"[ {start + b + 1} / {n} ]: {name}\n")
            scorer.print_score(orig[b:b + 1], "original")
            scorer.print_score(adapted[b:b + 1], "adapted", orig[b:b + 1])
            rec = scorer.rec_error(images[b].cpu(), edited[b])
            print("Reconstruction error: {:.4f}".format(rec))
            arr = np.clip(edited[b].numpy() * 255, 0, 255).astype(np.uint8)
            Image.fromarray(arr).save(os.path.join(out_sub, f"{name.replace('.jpg', '')}.jpg"))
        print(f"[{label}] batch of {len(batch)} edited in {dt:.2f}s ({len(batch) / dt:.3f} img/s)")
        done.append((names, out, log, dt))
    return done


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    from rgie_tpu_torch.parallel import process_device, split_batch

    split_batch(args.batch)
    device = process_device(args.device)

    from rgie_tpu_torch.config import DATA_DIR, OUT_DIR

    stack = build_models(args, torch.Generator().manual_seed(args.seed), device)
    gcfg, acfg = make_configs(args, stack.pipe.is_xl)
    adapt_batches(args, stack, make_adapter(stack), feed_items(args.data_dir or str(DATA_DIR),
                                                               args.limit),
                  gcfg, acfg, args.out_dir or str(OUT_DIR / "adapt_images"))

if __name__ == "__main__":
    main()
