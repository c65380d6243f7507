"""Benchmark of the batched diffusion edit (the adapt_images workload) on
PyTorch: port of ``scripts/bench_diffusion.py``. VAE encode -> inversion ->
null-text optimization -> guided CFG sampling -> VAE decode -> rescore, over
a batch of images at once (``diffusion/batched.py``).

    python -m rgie_tpu_torch.cli.bench_diffusion --scale sd --size 1024 --batch 2 \\
        [--num-steps 50] [--segment K] [--profile]

Reference workload: ``src/adapt_images.py:60-85`` +
``src/pipelines/InversionResamplingDiffusionPipeline.py:74-122`` (a bs=1 host
loop, 50 + 50 steps, 10 null-text inner steps). The weights are random from
``--seed`` (the FLOPs and the memory traffic are those of a checkpoint's),
in float32 at ``--scale tiny`` and bfloat16 at ``sd`` and ``sdxl``, as in
the JAX bench; the prompt embeddings are random too. With random weights the
null-text early stop does not fire, so every inner step runs.

One edit warms cuDNN and the allocator up, then ``--runs`` edits are timed
(host clock, each ending in a read of its outputs). Prints one JSON line:
images per second, seconds per image, ms per UNet-forward equivalent
(``unet_forward_equivalents``), the peak memory, the device's name and power
limit, the torch and CUDA versions, the type and the commit. There is no
history file. ``--profile`` instead profiles one edit under
``torch.profiler`` (device time summed by kernel; CUDA only). The JAX
bench's ``--memory-analysis`` (XLA's compile-time memory analysis) has no
counterpart: the peak memory of the timed runs stands in its place.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Optional, Sequence

import torch

from rgie_tpu_torch.config import PROJECT_ROOT


def unet_forward_equivalents(num_steps: int, use_nto: bool, num_inner: int) -> int:
    """Nominal single-latent UNet forward passes per edited image (counting a
    backward as 2 forwards, no remat surcharge; NTO inner loop at its full
    iteration budget — early stop only lowers the real number)."""
    n = 2                   # original + adapted VA scoring taps
    n += num_steps          # inversion
    if use_nto:
        # per outer step: 1 cond fwd + inner (fwd+bwd) + final CFG pair
        n += num_steps * (1 + num_inner * 3 + 2)
    # sampling: CFG pair + classifier-guidance grad (fwd+bwd)
    n += num_steps * (2 + 3)
    return n


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scale", choices=("tiny", "sd", "sdxl"), default="sd")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--size", type=int, default=None, help="image size (default 64 at tiny, "
                                                           "512 at sd and sdxl)")
    ap.add_argument("--num-steps", type=int, default=50)
    ap.add_argument("--num-inner", type=int, default=10)
    ap.add_argument("--no-nto", action="store_true")
    ap.add_argument("--remat", action="store_true", default=True)
    ap.add_argument("--no-remat", dest="remat", action="store_false")
    ap.add_argument("--remat-mode", choices=("call", "block"), default="call",
                    help="'block' recomputes each UNet res/attn block on the backward pass "
                         "(the UNet's block_remat); 'call' the whole UNet call")
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--segment", type=int, default=0, metavar="K",
                    help="run the segmented edit (diffusion/segmented.py): windows of K "
                         "diffusion steps chained from the host")
    ap.add_argument("--vae-tile", type=int, default=None,
                    help="latent tile size for tiled VAE encode/decode (e.g. 64 = 512 px "
                         "tiles, 25%% overlap)")
    ap.add_argument("--profile", action="store_true",
                    help="profile one edit under torch.profiler instead of timing --runs")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def build(args, device: torch.device):
    """The random-weight pipeline, the batch of images and its conditioning,
    and the edit program. Returns (pipe, program, inputs, dtype)."""
    from rgie_tpu_torch.diffusion import schedulers as SCH
    from rgie_tpu_torch.diffusion.batched import BatchedConds, make_batched_edit
    from rgie_tpu_torch.diffusion.pipeline import InversionResamplingPipeline, SdxlCond
    from rgie_tpu_torch.diffusion.segmented import make_segmented_edit
    from rgie_tpu_torch.diffusion.unet import UNetConfig, create_unet
    from rgie_tpu_torch.diffusion.vae import VaeConfig, create_vae
    from rgie_tpu_torch.models.midu import create_midu

    if args.scale == "tiny":
        size, unet_cfg, vae_cfg = args.size or 64, UNetConfig.tiny(), VaeConfig.tiny()
        dtype = torch.float32
    elif args.scale == "sd":
        size, unet_cfg, vae_cfg = args.size or 512, UNetConfig.sd21(), VaeConfig.sd()
        dtype = torch.bfloat16
    else:
        size, unet_cfg, vae_cfg = args.size or 512, UNetConfig.sdxl(), VaeConfig.sdxl()
        dtype = torch.bfloat16
    is_xl = args.scale == "sdxl"
    g = torch.Generator().manual_seed(args.seed)
    unet = create_unet(g, unet_cfg, dtype=dtype,
                       block_remat=args.remat and args.remat_mode == "block")
    vae = create_vae(g, vae_cfg, dtype=dtype)
    midu = create_midu(g, is_sdxl=is_xl, in_channels=unet_cfg.block_out_channels[-1])
    pipe = InversionResamplingPipeline(
        unet=unet.to(device), vae=vae.to(device), sched=SCH.make_schedule(args.num_steps),
        midu_model=midu.to(device), is_xl=is_xl,
        remat_unet=args.remat and args.remat_mode == "call", vae_tile=args.vae_tile)

    b, width = args.batch, unet_cfg.cross_attention_dim

    def draw(*shape, scale=0.02):
        return (torch.randn(shape, generator=g) * scale).to(device)

    images = torch.rand((b, size, size, 3), generator=g).to(device)
    empty = draw(1, 77, width)
    conds = dict(cfg_embeds=draw(b, 2, 77, width), cond_embeds=draw(b, 1, 77, width))
    added_empty = None
    if is_xl:
        time_ids = torch.tensor([size, size, 0, 0, size, size], dtype=torch.float32,
                                device=device)

        def added(n):
            return SdxlCond(draw(b, n, unet_cfg.addition_pooled_dim),
                            time_ids.expand(b, n, 6).contiguous())

        conds.update(added_cfg=added(2), added_cond=added(1), added_uncond=added(1))
        added_empty = SdxlCond(draw(1, unet_cfg.addition_pooled_dim), time_ids[None])
    alphas = torch.zeros((b, 2), device=device)

    kwargs = dict(guidance_scale=2.0, guidance_clf_scale=0.2, use_nto=not args.no_nto,
                  num_inner_steps=args.num_inner)
    if args.segment > 0:
        program = make_segmented_edit(pipe, chunk_steps=args.segment, **kwargs)
    else:
        program = make_batched_edit(pipe, **kwargs)
    return pipe, program, (images, empty, BatchedConds(**conds), alphas, added_empty), dtype


def commit() -> Optional[str]:
    """The checkout's commit, or None outside a git checkout."""
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=PROJECT_ROOT, capture_output=True,
                             text=True, timeout=30)
    except OSError:
        return None
    return out.stdout.strip() if out.returncode == 0 else None


def run_once(program, inputs, log=None):
    out = program(*inputs, log=log)
    # A read of the outputs waits for the device.
    float(out.edited.float().sum()) + float(out.adapted_score.sum())
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    from rgie_tpu_torch.cli.bench import device_info
    from rgie_tpu_torch.device import resolve_device
    from rgie_tpu_torch.diffusion.pipeline import RunLog

    device = resolve_device(args.device)
    t0 = time.perf_counter()
    pipe, program, inputs, dtype = build(args, device)
    build_s = time.perf_counter() - t0
    info = device_info(device)
    size = inputs[0].shape[1]
    if args.profile:
        from rgie_tpu_torch.cli.profile_adapt_images import profile_phase

        print(f"{info['device']}, {info['power_limit']}; torch {info['torch']}, "
              f"CUDA {info['cuda']}")
        profile_phase(f"batched edit ({args.scale}, {size} px, batch {args.batch}, "
                      f"{args.num_steps} steps, {str(dtype)[6:]})",
                      lambda: run_once(program, inputs))
        return {}

    on_card = device.type == "cuda"
    t0 = time.perf_counter()
    run_once(program, inputs)
    first_s = time.perf_counter() - t0
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    log = RunLog()
    t0 = time.perf_counter()
    for _ in range(args.runs):
        run_once(program, inputs, log)
    seconds = (time.perf_counter() - t0) / args.runs
    fwd_eq = unet_forward_equivalents(args.num_steps, not args.no_nto, args.num_inner)
    b = args.batch
    row = {
        "metric": f"adapt_images {args.scale}-scale {size}px batched diffusion edit",
        "value": b / seconds,
        "unit": "images/sec",
        "detail": {
            "batch": b, "steps": args.num_steps, "nto": not args.no_nto,
            "num_inner": args.num_inner, "remat": args.remat, "remat_mode": args.remat_mode,
            "segment": args.segment or None, "edit_seconds": seconds,
            "seconds_per_image": seconds / b,
            "unet_fwd_equivalents_per_image": fwd_eq,
            "per_unet_fwd_ms": seconds / (fwd_eq * b) * 1e3,
            "nto_inner_steps_run": sum(log.nto_inner_steps) // args.runs,
            "seconds_by_phase": {k: v / args.runs for k, v in log.seconds.items()},
            "build_seconds": build_s, "first_run_seconds": first_s,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else None,
            "dtype": str(dtype).replace("torch.", ""), "commit": commit(), **info,
        },
    }
    print(json.dumps(row), flush=True)
    from rgie_tpu_torch.utils.bench_history import record

    record("cli.bench_diffusion", row)
    return row


if __name__ == "__main__":
    main()
