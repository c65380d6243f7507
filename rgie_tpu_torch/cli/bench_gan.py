"""Benchmark of the MUNIT style-code edit on PyTorch — port of
``scripts/bench_gan.py`` (the optimize_image_imaginaire workload,
BASELINE.json configs[1]): per Adam step, decode -> clamp -> ten-crop VA
regressor (forward and backward) -> L1 content re-encoding, on a batch of
``--batch`` images at ``--size`` px, the regressor and the generator in
``--dtype`` (bfloat16 by default; the style codes and Adam's state stay
float32). Random weights from ``--seed``: the shipped MUNIT width
(``MunitGenConfig()``, imagenet2imagenet.yaml) and ResNet-50.

    python -m rgie_tpu_torch.cli.bench_gan [--size 1024] [--batch 4] [--remat]
                                           [--profile]

Prints one JSON line with the fields of ``rgie_tpu_torch.cli.bench``; the
FLOPs are those of one value-and-grad objective step with the content and
style codes computed beforehand (the edit encodes once, not per step), and
appends it to ``artifacts/bench_history_torch.jsonl``. ``--profile`` (with
``--steps``, ``--top``, ``--logdir``, ``--parse-only``) profiles that step
instead, as ``cli.bench --profile`` does.
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Optional, Sequence, Tuple

import torch

from rgie_tpu_torch.cli.bench import (DTYPES, SEED, add_profile_flags, profile_step, report,
                                      step_flops, time_edit, value_and_grad_step)
from rgie_tpu_torch.config import GanEditConfig, MunitGenConfig, OptimizeConfig
from rgie_tpu_torch.engine import gan as GE
from rgie_tpu_torch.engine.optimize import OptResult


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--num-steps", type=int, default=100)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--dtype", choices=tuple(DTYPES), default="bfloat16")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    add_profile_flags(ap)
    return ap


def build(batch: int, dtype: torch.dtype, remat: bool, num_steps: int, size: int,
          device: torch.device):
    """Random-weight regressor on [-1, 1] images (``normalize=False``) and
    MUNIT generator in ``dtype``, ``batch`` random images in [-1, 1] and
    alphas of 0.1, from the bench's SEED."""
    from rgie_tpu_torch.losses.emotion_loss import ValenceArousalLoss
    from rgie_tpu_torch.models.emotion import create_regressor
    from rgie_tpu_torch.models.munit import create_generator

    g = torch.Generator().manual_seed(SEED)
    va_loss = ValenceArousalLoss(regressor=create_regressor(g, normalize=False, dtype=dtype))
    gen = create_generator(g, MunitGenConfig(), image_size=size, dtype=dtype)
    models = GE.GanEditModels(generator=gen.autoencoder_a.to(device), va_loss=va_loss.to(device))
    cfg = GanEditConfig(optimize=OptimizeConfig(num_steps=num_steps, learning_rate=0.05),
                        input_size=size, crop_size=size, remat=remat)
    images = (torch.rand((batch, size, size, 3), generator=g) * 2 - 1).to(device)
    alphas = torch.full((batch, 2), 0.1, device=device)
    return models, cfg, images, alphas


def objective_step(models: GE.GanEditModels, cfg: GanEditConfig, images: torch.Tensor,
                   alphas: torch.Tensor) -> Callable[[], None]:
    """One value-and-grad objective step at the batch's own style codes, the
    content and styles encoded beforehand."""
    ctx, style0 = GE.make_context(models, images, alphas)
    return value_and_grad_step(GE.make_objective(models, cfg), style0, ctx)


def run(models: GE.GanEditModels, cfg: GanEditConfig, images: torch.Tensor,
        alphas: torch.Tensor, runs: int = 3) -> Tuple[dict, OptResult, torch.Tensor]:
    """Time the batched edit and count one objective step; returns the JSON
    row and the last run's result and edited images."""
    seconds, peak, result, edited = time_edit(lambda c: GE.make_batched_edit(models, c), cfg,
                                              images, alphas, runs)
    flops = step_flops(objective_step(models, cfg, images, alphas))
    dtype = models.va_loss.regressor.net.compute_dtype
    row = report(f"optimize_image_imaginaire {images.shape[1]}px MUNIT edit", images.device,
                 dtype, cfg.remat, images.shape[0], cfg.optimize.num_steps, seconds, flops, peak)
    return row, result, edited


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    from rgie_tpu_torch.cli.profile_adapt_images import parse_trace
    from rgie_tpu_torch.device import resolve_device
    from rgie_tpu_torch.utils.bench_history import record

    if args.parse_only:
        parse_trace(args.logdir, args.top)
        return
    device = resolve_device(args.device)
    models, cfg, images, alphas = build(args.batch, DTYPES[args.dtype], args.remat,
                                        args.num_steps, args.size, device)
    if args.profile:
        profile_step(objective_step(models, cfg, images, alphas),
                     f"MUNIT objective step ({args.size} px, batch {args.batch}, {args.dtype})",
                     device, args)
        return
    row, _, _ = run(models, cfg, images, alphas, args.runs)
    print(json.dumps(row), flush=True)
    record("cli.bench_gan", row)


if __name__ == "__main__":
    main()
