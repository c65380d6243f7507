"""Where the diffusion edit's time goes on the card: one inversion step, one
null-text inner step (loss and gradient) and one guided sampling step of the
``adapt_images`` stack under ``torch.profiler``, with device time summed by
kernel.

    python -m rgie_tpu_torch.cli.profile_adapt_images --scale sd --input-size 1024 \\
        --dtype float32

Takes the flags of ``rgie_tpu_torch.cli.adapt_images``; weights are the random
stand-ins drawn from ``--seed`` and the latents are random, so the shapes and
the kernels are the edit's while the values are not. Needs CUDA. Prints, per
phase, the wall time of one synchronized call after a warm-up, the profiled
device time, the share of it spent in the flash-attention kernels, and the
kernels with the largest shares.
"""

from __future__ import annotations

import subprocess
import time
from typing import Callable, Optional, Sequence

import torch

from rgie_tpu_torch.cli import adapt_images as cli
from rgie_tpu_torch.device import resolve_device

TOP_KERNELS = 12


def profile_phase(name: str, fn: Callable[[], object]) -> None:
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
    # Kernel rows only: the operator rows repeat their kernels' device time.
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    total = sum(ms for _, ms, _ in rows)
    flash = sum(ms for key, ms, _ in rows if "flash_" in key and "rgie" in key)
    print(f"{name}: wall {wall_ms:.1f} ms, device busy {total:.1f} ms, flash-attention kernels "
          f"{flash:.1f} ms ({100 * flash / max(total, 1e-9):.1f}%), peak memory "
          f"{peak / 2**30:.2f} GiB")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:TOP_KERNELS]:
        print(f"  {100 * ms / total:5.1f}%  {ms:9.2f} ms  x{count:<4d} {key[:110]}")


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
    ts, next_ts, i_vals = pipe.sample_tables(0)
    t = int(ts[0])
    with torch.no_grad():
        eps_cond, _ = pipe._unet(lat, t, embeds[1:], None)
    print(f"{args.scale} at {stack.input_size} px, latents {hw}x{hw}, {args.dtype or 'default'}")

    profile_phase("inversion step (UNet forward, batch 1)", lambda: pipe.invert_steps(
        lat, None, embeds[:1], None, ts[:1], ts[:1], i_vals[:1]))
    profile_phase("null-text inner step (UNet forward + backward to the embeddings)",
                  lambda: pipe.null_inner_loss_and_grad(embeds[:1], lat, t, eps_cond, lat_prev,
                                                        args.cfg_scale))
    profile_phase("guided sampling step (CFG pair forward + guidance forward and backward)",
                  lambda: pipe.sample_steps(lat, None, embeds, None, ts[:1], next_ts[:1],
                                            i_vals[:1], guidance_scale=args.cfg_scale,
                                            guidance_clf_scale=args.clf_scale))
    image = torch.rand((1, stack.input_size, stack.input_size, 3), generator=gen).to(device)
    profile_phase("VAE encode", lambda: pipe.encode_image(image))
    profile_phase("VAE decode", lambda: pipe.decode_latents(lat))


if __name__ == "__main__":
    main()
