"""Benchmark of the batched parametric edit on PyTorch — port of the root
``bench.py`` (BASELINE.json configs[0]): 256 px images, 100 Adam steps of
the filter chain -> ten-crop 480/448 ResNet-50 VA regressor (forward and
backward) -> CLIP ViT-B/32 reconstruction loss (forward and backward), the
frozen models in ``--dtype`` (bfloat16 by default) and the 41 parameters
and Adam's state in float32.

    python -m rgie_tpu_torch.cli.bench [--batch 12] [--dtype bfloat16] [--remat]
                                       [--profile]

A 2-step edit warms cuDNN and the allocator up, then ``--runs`` edits are
timed (host clock, each run ending in a read of its outputs). Prints one
JSON line: edited images/s, the batched step time, and the achieved
TFLOP/s and MFU, the FLOPs of one value-and-grad objective step being
counted by ``torch.utils.flop_counter.FlopCounterMode`` (matmuls and
convolutions) and the MFU taken against the H100's dense peak of the type
that runs; with the device's name, power limit, the torch and CUDA versions
and the peak memory, and appends it to ``artifacts/bench_history_torch.jsonl``
(``utils/bench_history.py``). Device figures are null on the CPU.

``--profile`` instead profiles ``--steps`` of those objective steps under
``torch.profiler`` (device time summed by kernel, the ``--top`` kernels
printed; CUDA only); ``--logdir DIR`` also writes the chrome trace there,
and ``--parse-only`` prints the top kernels of the trace in ``--logdir``
without running anything (the flags of ``scripts/profile_param_edit.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time
from typing import Callable, Optional, Sequence, Tuple

import torch

from rgie_tpu_torch.config import OptimizeConfig, ParamEditConfig
from rgie_tpu_torch.engine import parametric as P
from rgie_tpu_torch.engine.optimize import OptResult
from rgie_tpu_torch.ops import chain as CH

NUM_STEPS, IMAGE_SIZE, RUNS, SEED = 100, 256, 3, 0
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# Published dense peaks of one H100 SXM: float32 outside the tensor cores,
# bfloat16 in them.
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=12)
    ap.add_argument("--dtype", choices=tuple(DTYPES), default="bfloat16")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    add_profile_flags(ap)
    return ap


def add_profile_flags(ap: argparse.ArgumentParser) -> None:
    """``--profile`` and the flags of ``scripts/profile_param_edit.py``."""
    from rgie_tpu_torch.cli.profile_adapt_images import TOP_KERNELS

    ap.add_argument("--profile", action="store_true",
                    help="profile value-and-grad objective steps instead of timing the edit")
    ap.add_argument("--steps", type=int, default=1,
                    help="objective steps in the profiled window (with --profile)")
    ap.add_argument("--top", type=int, default=TOP_KERNELS, help="kernels printed")
    ap.add_argument("--logdir", default=None,
                    help="write the profile's chrome trace (trace.json) here")
    ap.add_argument("--parse-only", action="store_true",
                    help="print the top kernels of the trace in --logdir and exit")


def device_info(device: torch.device) -> dict:
    """The device's name and power limit, and the torch and CUDA versions."""
    info = {"device": "cpu", "power_limit": None, "torch": torch.__version__,
            "cuda": torch.version.cuda}
    if device.type == "cuda":
        index = device.index if device.index is not None else torch.cuda.current_device()
        info["device"] = torch.cuda.get_device_name(index)
        info["power_limit"] = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    return info


def value_and_grad_step(objective: Callable, x: torch.Tensor, ctx) -> Callable[[], None]:
    """One value-and-grad step of ``objective`` at ``x``: the Adam loop's
    body, which the benches count and profile."""
    def step() -> None:
        objective(x.detach().clone().requires_grad_(True), ctx).sum().backward()

    return step


def step_flops(step: Callable[[], None]) -> float:
    """FLOPs of ``step`` as FlopCounterMode counts them (matmuls and
    convolutions, forward and backward; elementwise work is not counted)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        step()
    return float(counter.get_total_flops())


def profile_step(step: Callable[[], None], what: str, device: torch.device, args) -> None:
    """``--profile``: the device's name and power limit, then ``args.steps``
    calls of ``step`` after a warm-up, timed and under torch.profiler
    (cli/profile_adapt_images.py)."""
    from rgie_tpu_torch.cli.profile_adapt_images import profile_phase

    info = device_info(device)
    print(f"{info['device']}, {info['power_limit']}; torch {info['torch']}, CUDA {info['cuda']}")
    if args.steps > 1:
        what = f"{args.steps} x {what}"
        one, step = step, lambda: [one() for _ in range(args.steps)]
    profile_phase(what, step, top=args.top, logdir=args.logdir)


def time_edit(make_edit: Callable, cfg, images: torch.Tensor, alphas: torch.Tensor,
              runs: int) -> Tuple[float, int, OptResult, torch.Tensor]:
    """A 2-step warm-up edit, then ``runs`` timed edits. Returns the seconds
    per edit, the peak device memory of the timed runs (0 on the CPU), and
    the last run's result and edited images."""
    warm = dataclasses.replace(cfg, optimize=dataclasses.replace(cfg.optimize, num_steps=2))
    make_edit(warm)(images, alphas)
    on_card = images.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    edit = make_edit(cfg)
    t0 = time.perf_counter()
    for _ in range(runs):
        result, edited = edit(images, alphas)
        float(edited.float().sum()) + float(result.best_loss.sum())   # waits for the device
    seconds = (time.perf_counter() - t0) / runs
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    return seconds, peak, result, edited


def report(metric: str, device: torch.device, dtype: torch.dtype, remat: bool, batch: int,
           num_steps: int, seconds: float, flops: float, peak: int) -> dict:
    """The JSON row (the JAX bench's fields, unrounded)."""
    on_card = device.type == "cuda"
    tflops = flops * num_steps / seconds / 1e12
    return {
        "metric": metric,
        "value": batch / seconds,
        "unit": "images/sec",
        "detail": {
            "batch": batch, "steps": num_steps, "edit_seconds": seconds,
            "per_step_ms_batched": seconds / num_steps * 1e3,
            "dtype": str(dtype).replace("torch.", ""), "remat": remat,
            "step_tflop": flops / 1e12,
            "achieved_tflops": tflops if on_card else None,
            "mfu_pct": tflops * 1e12 / PEAK_FLOPS[dtype] * 100.0 if on_card else None,
            "peak_memory_gib": peak / 2 ** 30 if on_card else None,
            **device_info(device),
        },
    }


def build(batch: int, dtype: torch.dtype, remat: bool, device: torch.device):
    """Random-weight frozen ResNet-50 regressor and CLIP ViT-B/32 in ``dtype``,
    ``batch`` random IMAGE_SIZE px images in [0, 1] and alphas of 0.1, from
    SEED; NUM_STEPS Adam steps."""
    from rgie_tpu_torch.losses.emotion_loss import ValenceArousalLoss
    from rgie_tpu_torch.models.clip import create_clip_image_encoder
    from rgie_tpu_torch.models.emotion import create_regressor

    g = torch.Generator().manual_seed(SEED)
    va_loss = ValenceArousalLoss(regressor=create_regressor(g, dtype=dtype))
    clip_enc = create_clip_image_encoder(g, dtype=dtype)
    models = P.EditModels(va_loss=va_loss.to(device), clip=clip_enc.to(device))
    cfg = ParamEditConfig(optimize=OptimizeConfig(num_steps=NUM_STEPS, learning_rate=0.05),
                          remat=remat)
    images = torch.rand((batch, IMAGE_SIZE, IMAGE_SIZE, 3), generator=g).to(device)
    alphas = torch.full((batch, 2), 0.1, device=device)
    return models, cfg, images, alphas


def objective_step(models: P.EditModels, cfg: ParamEditConfig, images: torch.Tensor,
                   alphas: torch.Tensor) -> Callable[[], None]:
    """One value-and-grad objective step of the batch at the identity vector."""
    ctx = P.make_context(models, cfg, images, alphas)
    x0 = CH.pack_params(CH.init_params(images.dtype, images.device))
    return value_and_grad_step(P.make_objective(models, cfg), x0.expand(images.shape[0], -1), ctx)


def run(models: P.EditModels, cfg: ParamEditConfig, images: torch.Tensor, alphas: torch.Tensor,
        runs: int = RUNS) -> Tuple[dict, OptResult, torch.Tensor]:
    """Time the batched edit and count one objective step; returns the JSON
    row and the last run's result and edited images."""
    seconds, peak, result, edited = time_edit(lambda c: P.make_batched_edit(models, c), cfg,
                                              images, alphas, runs)
    flops = step_flops(objective_step(models, cfg, images, alphas))
    row = report(f"edited images/sec ({images.shape[1]}px, {cfg.optimize.num_steps}-step "
                 "Adam edit)", images.device, models.va_loss.regressor.net.compute_dtype,
                 cfg.remat, images.shape[0], cfg.optimize.num_steps, seconds, flops, peak)
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
    models, cfg, images, alphas = build(args.batch, DTYPES[args.dtype], args.remat, device)
    if args.profile:
        profile_step(objective_step(models, cfg, images, alphas),
                     f"parametric objective step ({IMAGE_SIZE} px, batch {args.batch}, "
                     f"{args.dtype})", device, args)
        return
    row, _, _ = run(models, cfg, images, alphas)
    print(json.dumps(row), flush=True)
    record("cli.bench", row)


if __name__ == "__main__":
    main()
