"""Where the diffusion edit's time goes on the card: one inversion step, one
null-text inner step (loss and gradient) and one guided sampling step of the
``adapt_images`` stack under ``torch.profiler``, with device time summed by
kernel.

    python -m rgie_tpu_torch.cli.profile_adapt_images --scale sd --input-size 1024 \\
        --dtype float32
    python -m rgie_tpu_torch.cli.profile_adapt_images --scale sdxl --scheduler dpm

Takes the flags of ``rgie_tpu_torch.cli.adapt_images``; weights are the random
stand-ins drawn from ``--seed`` and the latents are random, so the shapes and
the kernels are the edit's while the values are not (at ``--scale sdxl`` the
pooled text embeddings are random too, beside the time ids of the input
size). Each step is the scheduler's (``--scheduler``: DDIM, or DPM-Solver++
over the alphas table for SD and over the karras sigma tables for SDXL).
Needs CUDA. Prints, per phase, the wall time of one synchronized call after
a warm-up, the profiled device time, the share of it spent in the
flash-attention kernels, the peak memory, and the kernels with the largest
shares.
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from typing import Callable, Optional, Sequence

import torch

from rgie_tpu_torch.cli import adapt_images as cli
from rgie_tpu_torch.device import resolve_device
from rgie_tpu_torch.diffusion import schedulers as SCH
from rgie_tpu_torch.diffusion.pipeline import SdxlCond
from rgie_tpu_torch.diffusion.text_encoder import get_add_time_ids

TOP_KERNELS = 12
TRACE_FILE = "trace.json"


def profile_phase(name: str, fn: Callable[[], object], top: int = TOP_KERNELS,
                  logdir: Optional[str] = None) -> None:
    """One call of ``fn`` after a warm-up, timed, then one under
    torch.profiler: device time summed by kernel, the ``top`` kernels
    printed; with ``logdir``, the chrome trace written there as trace.json."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()                               # warm-up: cuDNN's choices, the allocator
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    if logdir:
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))
    # Kernel rows only: the operator rows repeat their kernels' device time.
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    total = sum(ms for _, ms, _ in rows)
    flash = sum(ms for key, ms, _ in rows if "flash_" in key and "rgie" in key)
    print(f"{name}: wall {wall_ms:.1f} ms, device busy {total:.1f} ms, flash-attention kernels "
          f"{flash:.1f} ms ({100 * flash / max(total, 1e-9):.1f}%), peak memory "
          f"{peak / 2**30:.2f} GiB")
    print_kernels(rows, top)


def print_kernels(rows, top: int) -> None:
    """(name, device ms, launches) rows: the ``top`` by time, with shares."""
    total = sum(ms for _, ms, _ in rows)
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:top]:
        print(f"  {100 * ms / max(total, 1e-9):5.1f}%  {ms:9.2f} ms  x{count:<4d} {key[:110]}")


def parse_trace(logdir: str, top: int = TOP_KERNELS) -> None:
    """The ``top`` device kernels of the chrome trace ``profile_phase`` wrote
    to ``logdir``, by total time (``--parse-only``)."""
    if not logdir:
        raise SystemExit("--parse-only reads the trace under --logdir: name that directory")
    with open(os.path.join(logdir, TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    by_name = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            ms, count = by_name.get(e["name"], (0.0, 0))
            by_name[e["name"]] = (ms + e.get("dur", 0) / 1e3, count + 1)
    rows = [(name, ms, count) for name, (ms, count) in by_name.items()]
    print(f"{os.path.join(logdir, TRACE_FILE)}: {len(rows)} kernels, device time "
          f"{sum(ms for _, ms, _ in rows):.1f} ms")
    print_kernels(rows, top)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = cli.build_parser().parse_args(argv)
    device = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    print(card)
    gen = torch.Generator().manual_seed(args.seed)
    stack = cli.build_models(args, gen, device)
    pipe = stack.pipe
    hw = stack.input_size // pipe.vae.upscale_factor
    width = pipe.unet.cfg.cross_attention_dim

    def draw(*shape):
        return torch.randn(shape, generator=gen).to(device)

    lat, lat_prev = draw(1, hw, hw, 4), draw(1, hw, hw, 4)
    embeds = draw(2, 77, width)
    added = added_row = None
    if pipe.is_xl:
        time_ids = get_add_time_ids(stack.input_size, stack.input_size).to(device)
        added = SdxlCond(draw(2, pipe.unet.cfg.addition_pooled_dim), time_ids.expand(2, 6))
        added_row = SdxlCond(added.text_embeds[:1], added.time_ids[:1])
    ts, next_ts, i_vals = pipe.sample_tables(0)
    inv_ts, src_ts, inv_i = pipe.invert_tables()
    t = int(ts[0])

    def state():
        return SCH.dpm_init_state(lat.shape, lat.dtype, device)

    with torch.no_grad():
        eps_cond, _ = pipe._unet(lat, t, embeds[1:], added_row)
    print(f"{args.scale} at {stack.input_size} px, latents {hw}x{hw}, {args.dtype or 'default'}, "
          f"scheduler {args.scheduler}")

    profile_phase("inversion step (UNet forward, batch 1)", lambda: pipe.invert_steps(
        lat, state(), embeds[:1], added_row, inv_ts[1:2], src_ts[1:2], inv_i[1:2]))
    profile_phase("null-text inner step (UNet forward + backward to the embeddings)",
                  lambda: pipe.null_inner_loss_and_grad(embeds[:1], lat, t, eps_cond, lat_prev,
                                                        args.cfg_scale, added_row))
    profile_phase("guided sampling step (CFG pair forward + guidance forward and backward)",
                  lambda: pipe.sample_steps(lat, state(), embeds, added, ts[:1], next_ts[:1],
                                            i_vals[:1], guidance_scale=args.cfg_scale,
                                            guidance_clf_scale=args.clf_scale))
    image = torch.rand((1, stack.input_size, stack.input_size, 3), generator=gen).to(device)
    profile_phase("VAE encode", lambda: pipe.encode_image(image))
    profile_phase("VAE decode", lambda: pipe.decode_latents(lat))


if __name__ == "__main__":
    main()
