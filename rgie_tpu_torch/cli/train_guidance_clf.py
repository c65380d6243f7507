"""Guidance-regressor (midu) training CLI on PyTorch: port of
``scripts/train_guidance_clf.py`` (reference ``src/clf/train_guidance_clf.py``):
train the small CNN that predicts valence/arousal from the UNet's mid-block
activations at noisy latents.

    python -m rgie_tpu_torch.cli.train_guidance_clf --scale sd --device cuda

Per batch (reference :209-294): teacher VA labels from the frozen pixel-space
regressor (``training/clf_wrapper.py``), VAE encode, scheduler noise at random
timesteps, the frozen UNet's mid-block features, then one Adam step (lr 1e-5,
L2 weight decay 5e-5) of the midu on their MSE to the labels. Per epoch the
train and validation losses, and the best midu so far written with
``torch.save`` (``BestCheckpointer``: ``best.pt`` under ``--out-dir``), which
the diffusion CLI reads with ``--midu-ckpt``.

Without ``--data-dir`` the images are random, drawn from ``--seed``; with it,
the captions feed's images, full batches only. The UNet, VAE and teacher are
random-weight stand-ins from ``--seed``. The UNet and VAE run in ``--dtype``
(float32 at the tiny scales, bfloat16 at ``sd`` and ``sdxl``); the teacher
runs in float32 whatever ``--dtype`` says, as the reference builds it before
it picks the type (its labels are the midu's targets); the midu trains in
float32.
``--scale tiny`` and ``tiny-xl`` are test sizes; ``sdxl`` trains
``MiduSDXL`` over the SDXL UNet's mid block at 1024 px (reference
train_guidance_clf.py:52-54,89-98), where the VAE's mid-block attention
(16384 positions) runs through the flash-attention forward kernel, as the
UNet's self-attention does at every scale. The
port's ``MiduSDXL`` reads 32 x 32 mid features only, so ``tiny-xl`` needs
``--image-size 128``. Runs on ``--device cuda`` (the default) or ``cpu``.

Several processes (``torchrun --nproc_per_node N``, one card each):
``--batch-size`` is the global batch and must divide over them. Each rank
draws its own rows and noise (its generators folded with its rank; with
``--data-dir``, feed items p, p+N, ...), the gradients and the losses are
averaged over the ranks before each Adam step (DDP, so every rank keeps the
same midu), and rank 0 alone writes the checkpoint.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Iterator, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from rgie_tpu_torch.config import PROJECT_ROOT, TrainGuidanceConfig
from rgie_tpu_torch.diffusion import schedulers as SCH
from rgie_tpu_torch.diffusion.schedulers import DiffusionSchedule
from rgie_tpu_torch.diffusion.unet import UNet2DCondition, UNetConfig
from rgie_tpu_torch.diffusion.vae import AutoencoderKL, VaeConfig
from rgie_tpu_torch.training.clf_wrapper import ClfWrapper
from rgie_tpu_torch.training.train_midu import get_noisy_latents
from rgie_tpu_torch.utils.spans import span

#: (UNet config, VAE config, default image size, teacher regressor sizes).
SCALES = {
    "tiny": (UNetConfig.tiny, VaeConfig.tiny, 64, dict(input_size=72, crop_size=64)),
    "tiny-xl": (UNetConfig.tiny_xl, VaeConfig.tiny, 64, dict(input_size=72, crop_size=64)),
    "sd": (UNetConfig.sd21, VaeConfig.sd, 512, {}),
    "sdxl": (UNetConfig.sdxl, VaeConfig.sdxl, 1024, {}),
}
#: The empty prompt of the frozen feature pass: zero embeddings of this many
#: tokens, as in the JAX CLI.
CONTEXT_LEN = 8
#: A rank's data and validation generators are seeded ``RANK_FOLD * rank``
#: past rank 0's (the JAX CLI folds ``pid * 100003`` into its keys).
RANK_FOLD = 100003


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data-dir", default=None, help="captions feed dataset; random if absent")
    ap.add_argument("--out-dir", default=str(PROJECT_ROOT / "checkpoints" / "midu"))
    ap.add_argument("--scale", choices=tuple(SCALES), default="tiny",
                    help="sdxl = MiduSDXL over the SDXL UNet mid block at 1024 px (reference "
                         "train_guidance_clf.py:52-54,89-98); tiny-xl is its test-size twin")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default=None,
                    help="the frozen UNet's and VAE's type (default: bfloat16 at sd and sdxl); "
                         "the teacher and the midu run in float32")
    ap.add_argument("--setting", choices=("va", "valence", "arousal"), default="va")
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=8, help="global batch")
    ap.add_argument("--learning-rate", type=float, default=1e-5)
    ap.add_argument("--weight-decay", type=float, default=5e-5)
    ap.add_argument("--num-batches", type=int, default=16, help="train batches per epoch")
    ap.add_argument("--val-batches", type=int, default=4)
    ap.add_argument("--image-size", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


class TrainStack(NamedTuple):
    """The frozen feature extractors and the teacher, with the conditioning of
    the feature pass."""

    unet: UNet2DCondition
    vae: AutoencoderKL
    teacher: ClfWrapper
    sched: DiffusionSchedule
    image_size: int
    context: torch.Tensor                    # (1, CONTEXT_LEN, D) zeros
    added_text: Optional[torch.Tensor]       # SDXL: (1, pooled) zeros
    added_time: Optional[torch.Tensor]       # SDXL: (1, 6) micro-conditioning ids


def make_stack(unet: UNet2DCondition, vae: AutoencoderKL, teacher: ClfWrapper,
               image_size: int) -> TrainStack:
    """The feature pass's conditioning around frozen modules on one device.
    SDXL's is the empty prompt's: zero pooled embeddings and the standard
    (orig_size, crop 0 0, target_size) time ids (the reference trains with
    empty prompts, MiduClassifier._set_midu_layer_no_grad)."""
    cfg, device = unet.cfg, unet.conv_in.weight.device
    added_text = added_time = None
    if cfg.addition_embed_type == "text_time":
        added_text = torch.zeros((1, cfg.addition_pooled_dim), device=device)
        added_time = torch.tensor([[image_size, image_size, 0, 0, image_size, image_size]],
                                  dtype=torch.float32, device=device)
    return TrainStack(unet=unet, vae=vae, teacher=teacher, sched=SCH.make_schedule(50),
                      image_size=image_size,
                      context=torch.zeros((1, CONTEXT_LEN, cfg.cross_attention_dim),
                                          device=device),
                      added_text=added_text, added_time=added_time)


def build_models(args, generator: torch.Generator, device: torch.device
                 ) -> Tuple[TrainStack, nn.Module]:
    """The frozen UNet and VAE (random stand-ins from ``generator``, made on
    the host in the scale's type and moved once), the float32 teacher and the
    float32 midu to train."""
    from rgie_tpu_torch.diffusion.unet import create_unet
    from rgie_tpu_torch.diffusion.vae import create_vae
    from rgie_tpu_torch.models.midu import create_midu
    from rgie_tpu_torch.training.clf_wrapper import create_teacher

    unet_cfg_fn, vae_cfg_fn, default_size, teacher_sizes = SCALES[args.scale]
    unet_cfg, vae_cfg = unet_cfg_fn(), vae_cfg_fn()
    image_size = args.image_size or default_size
    is_xl = unet_cfg.addition_embed_type == "text_time"
    latent_hw = image_size // 2 ** (len(vae_cfg.block_out_channels) - 1)
    mid_hw = latent_hw // 2 ** (len(unet_cfg.block_out_channels) - 1)
    if is_xl and mid_hw != 32:
        raise ValueError(f"MiduSDXL reads 32 x 32 mid-block features; {image_size} px gives "
                         f"{mid_hw} x {mid_hw}")
    dtype_name = args.dtype or ("float32" if args.scale.startswith("tiny") else "bfloat16")
    dtype = torch.bfloat16 if dtype_name == "bfloat16" else torch.float32

    unet = create_unet(generator, unet_cfg, dtype=dtype)
    vae = create_vae(generator, vae_cfg, dtype=dtype)
    teacher = create_teacher(generator, loss_type=args.setting, **teacher_sizes)
    midu = create_midu(generator, is_sdxl=is_xl, num_outputs=2 if args.setting == "va" else 1,
                       in_channels=unet_cfg.block_out_channels[-1])
    teacher.loss.to(device)
    stack = make_stack(unet.to(device), vae.to(device), teacher, image_size)
    return stack, midu.to(device)


@torch.no_grad()
def features_and_labels(stack: TrainStack, generator: torch.Generator, images: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher labels and the mid-block features at noisy latents of
    ``images`` (B, H, W, 3) in [0, 1], both float32; the teacher reads the
    images in float32; the timesteps and the noise are drawn from
    ``generator`` (JAX CLI: features_and_labels)."""
    with span("train.features"):
        with span("train.teacher"):
            labels = stack.teacher.get_label(images.float())
        with span("train.encode"):
            latents = stack.vae.encode(images * 2 - 1).float()
            noisy, t = get_noisy_latents(generator, latents, stack.sched.alphas_cumprod,
                                         stack.sched.num_train_timesteps)
        with span("train.unet"):
            b = noisy.shape[0]
            kwargs = {}
            if stack.added_text is not None:
                kwargs = dict(added_text_embeds=stack.added_text.expand(b, -1),
                              added_time_ids=stack.added_time.expand(b, -1))
            _, mid = stack.unet(noisy, t, stack.context.expand(b, -1, -1), **kwargs)
            return mid.float(), labels


def image_batches(args, image_size: int, generator: torch.Generator, n_batches: int,
                  device: torch.device) -> Iterator[torch.Tensor]:
    """``n_batches`` batches of this process's share of ``--batch-size``
    images (B, H, W, 3) in [0, 1]: the feed's (its items p, p+N, ... of N
    processes), full batches only, or random ones from ``generator``."""
    from rgie_tpu_torch.parallel import process_info, split_batch

    batch = split_batch(args.batch_size, "--batch-size")
    if args.data_dir and os.path.exists(args.data_dir):
        from rgie_tpu_torch.data import CaptionFeedDataset, ShardedView, iterate_batches

        count = 0
        for imgs, _ in iterate_batches(ShardedView(CaptionFeedDataset(args.data_dir),
                                                   *process_info()),
                                       batch, image_size, image_size):
            if count >= n_batches:
                break
            if imgs.shape[0] == batch:
                yield torch.from_numpy(imgs).to(device)
                count += 1
        return
    for _ in range(n_batches):
        yield torch.rand((batch, image_size, image_size, 3), generator=generator).to(device)


def main(argv: Optional[Sequence[str]] = None) -> TrainStack:
    """Train; returns the frozen stack the run used."""
    args = build_parser().parse_args(argv)
    from rgie_tpu_torch.parallel import (all_mean, is_main_process, process_device,
                                         process_info, split_batch)
    from rgie_tpu_torch.training.train_midu import (create_train_state, make_eval_step,
                                                    shard_train_step)
    from rgie_tpu_torch.utils.checkpoint import BestCheckpointer

    split_batch(args.batch_size, "--batch-size")
    device = process_device(args.device)
    pid = process_info()[0]
    cfg = TrainGuidanceConfig(setting=args.setting, batch_size=args.batch_size,
                              learning_rate=args.learning_rate,
                              weight_decay=args.weight_decay, num_epochs=args.epochs,
                              seed=args.seed)
    t0 = time.perf_counter()
    stack, midu = build_models(args, torch.Generator().manual_seed(args.seed), device)
    print(f"models built at --scale {args.scale}, {stack.image_size} px, in "
          f"{time.perf_counter() - t0:.1f} s")
    train_step, state = shard_train_step(create_train_state(midu, cfg))
    eval_step = make_eval_step()
    data = torch.Generator().manual_seed(args.seed + 1 + RANK_FOLD * pid)
    ckpt = BestCheckpointer(args.out_dir) if is_main_process() else None
    for epoch in range(cfg.num_epochs):
        t0 = time.perf_counter()
        train_losses = []
        for images in image_batches(args, stack.image_size, data, args.num_batches, device):
            feats, labels = features_and_labels(stack, data, images)
            state, loss, _ = train_step(state, feats, labels)
            train_losses.append(float(loss))
        # The same validation images and noise every epoch.
        val = torch.Generator().manual_seed(args.seed + 2 + RANK_FOLD * pid)
        val_losses = []
        for images in image_batches(args, stack.image_size, val, args.val_batches, device):
            feats, labels = features_and_labels(stack, val, images)
            loss, _ = eval_step(state.model, feats, labels)
            val_losses.append(float(loss))
        # Every rank's validation rows count, as in the JAX CLI's global eval.
        val_loss = float(all_mean(torch.tensor(np.mean(val_losses), dtype=torch.float64,
                                               device=device)))
        saved = ckpt is not None and ckpt.maybe_save(val_loss, state.model, state.step)
        print(f"epoch {epoch + 1}/{cfg.num_epochs} train {np.mean(train_losses):.5f} val "
              f"{val_loss:.5f} {'(best saved)' if saved else ''} "
              f"[{time.perf_counter() - t0:.1f}s]")
    if ckpt is not None:
        print(f"best val loss: {ckpt.best_loss:.5f} at {ckpt.best_path}")
    return stack


if __name__ == "__main__":
    main()
