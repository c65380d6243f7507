"""On-card parity and timing of the attention modules' two routes: port of
``scripts/check_flash_attn.py``. The kernel route (``flash_attention``, the
CUDA kernels) against the matmul route (matmul, float32 softmax, matmul, as
``CrossAttention`` runs where the gate is closed). Its table is the measured
ground of the gate's rule (``flash_self_attention_ok``).

    python -m rgie_tpu_torch.cli.check_flash_attn [--skip-timing]

1. Parity: forward and gradients (q, k, v) of both routes on the same inputs
   at every shape of ``SHAPES`` in bfloat16 and float32: the forward within
   ``FWD_TOL`` of the largest entry, each gradient within ``GRAD_TOL`` of its
   largest entry (bfloat16: the JAX script's limits; float32: both routes sum
   in float32).
2. Times (CUDA events; the median of 5 windows of ``CALLS`` back-to-back
   calls, over ``CALLS``): forward, and forward + backward, of both routes at
   every shape of ``SHAPES`` in both types, and whether the kernel wins both
   (``kernel_wins``) and what the gate decides there (``gate``).
   ``SHAPES`` holds the self-attention the benchmark's cells and the CLIs
   launch: SD-2.1 at 512 px (5, 10, 20 and 20 heads of 64 at 4096, 1024, 256
   and 64 positions) at batch 1, 2 (the single edit and its CFG pair), 8 and
   16 (the batched edit and its CFG pair); SDXL at 1024 px (10 heads at 4096,
   20 at 1024) at batch 1, 2 and 4; the VAE mid block (one head of 512) at
   4096 positions (512 px) at batch 1, 2 and 8 and at 1024 (a 32 x 32 latent
   tile); SD-2.1 at 1024 px (20, 10 and 5 heads at 1024, 4096 and 16384) at
   batch 2; and the tensor-core widths 32 and 128 (10 heads at 256, 1024 and
   4096 positions, batch 2 and 16; at 128 float32 takes its wide forward).
3. A full-width SD-2.1 UNet in both types under each of the gate's
   thresholds in ``THRESHOLDS`` ("closed": the module's ``FLASH_ATTN`` set to
   "0" here, as ``RGIE_FLASH_ATTN=0`` does; a number: ``MIN_FLASH_SEQ_LEN``
   set to it), the thresholds in alternation over ``UNET_REPS`` windows:
   median, quartiles and peak memory. The forward at 1024 px, batch 2, and
   at 512 px, batch 16 (the CFG pair of a batch of 8), and the forward +
   backward to the text embeddings at 512 px, batch 8 (a null-text inner
   step's or a guidance step's UNet work) and batch 16 (the same at
   ``--batch 16``; thresholds 1024 and below, where the matmul route's
   scores fit).

Needs CUDA. Every line carries the card's name and power limit; the last line
is one JSON object with all the numbers.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

FWD_TOL = {torch.bfloat16: 0.06, torch.float32: 1e-4}
GRAD_TOL = {torch.bfloat16: 0.05, torch.float32: 1e-4}
#: (B, H, N, d) of every self-attention call the cells and the CLIs launch.
SHAPES = ([(b, h, n, 64) for b in (1, 2, 8, 16)
           for h, n in ((5, 4096), (10, 1024), (20, 256), (20, 64))]
          + [(b, h, n, 64) for b in (1, 2, 4) for h, n in ((10, 4096), (20, 1024))]
          + [(1, 1, 4096, 512), (2, 1, 4096, 512), (8, 1, 4096, 512), (1, 1, 1024, 512)]
          + [(2, 20, 1024, 64), (2, 10, 4096, 64), (2, 5, 16384, 64)]
          + [(b, 10, n, d) for d in (32, 128) for b in (2, 16) for n in (256, 1024, 4096)])
SHAPES = list(dict.fromkeys(SHAPES))
#: Calls timed back to back between two events.
CALLS = 10
TYPES = (torch.bfloat16, torch.float32)
#: The gate's thresholds the UNet is timed under ("closed": no kernel).
THRESHOLDS = ("closed", 8192, 4096, 1024, 256, 64)
#: Timing windows of the UNet at each threshold.
UNET_REPS = 9


def matmul_route(q, k, v, scale: float):
    """The attention modules' route where the gate is closed
    (``CrossAttention``)."""
    attn = torch.matmul(q, k.transpose(-1, -2)) * scale
    attn = torch.softmax(attn.float(), dim=-1).to(q.dtype)
    return torch.matmul(attn, v)


def time_ms(fns: List[Callable[[], object]], warmup: int = 1, reps: int = 5,
            calls: int = 1) -> List[float]:
    """Median milliseconds of one ``fn()`` over ``reps`` windows of ``calls``
    calls each, CUDA events, the functions in alternation."""
    return [float(np.median(ts)) for ts in time_windows(fns, warmup, reps, calls)]


def time_windows(fns: List[Callable[[], object]], warmup: int, reps: int,
                 calls: int = 1) -> List[List[float]]:
    """Milliseconds of one ``fn()`` in each of ``reps`` windows of ``calls``
    calls, CUDA events, the functions in alternation."""
    for _ in range(warmup):
        for fn in fns:
            fn()
    times = [[] for _ in fns]
    for _ in range(reps):
        for fn, ts in zip(fns, times):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) / calls)
    return times


def _inputs(shape, dtype, seed: int):
    b, h, n, d = shape
    g = torch.Generator().manual_seed(seed)
    # (b, n, h, d) storage seen as (b, h, n, d): the modules' own layout.
    return [torch.randn((b, n, h, d), generator=g).cuda().to(dtype).transpose(1, 2)
            for _ in range(4)]


def _type_name(dtype) -> str:
    return str(dtype)[6:]


def check_parity(shape, dtype, card: str) -> dict:
    from rgie_tpu_torch.ops.kernels import flash_attention as FA

    q, k, v, do = _inputs(shape, dtype, 0)
    scale = 1.0 / math.sqrt(shape[3])
    outs = []
    for route in (lambda a, b, c: FA.flash_attention(a, b, c, sm_scale=scale),
                  lambda a, b, c: matmul_route(a, b, c, scale)):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        o = route(*leaves)
        outs.append((o.detach(), torch.autograd.grad(o, leaves, do)))
    (o_k, g_k), (o_m, g_m) = outs
    rel = lambda a, b: float((a.float() - b.float()).abs().max() / b.float().abs().max())
    row = {"shape": list(shape), "dtype": _type_name(dtype), "fwd": rel(o_k, o_m),
           **{f"d{name}": rel(a, b) for name, a, b in zip("qkv", g_k, g_m)}}
    print(f"parity {shape} {row['dtype']} on {card}: forward {row['fwd']:.3e} (limit "
          f"{FWD_TOL[dtype]:g}), dq {row['dq']:.3e}, dk {row['dk']:.3e}, dv {row['dv']:.3e} "
          f"(limit {GRAD_TOL[dtype]:g}), of the largest entry")
    if row["fwd"] > FWD_TOL[dtype] or max(row["dq"], row["dk"], row["dv"]) > GRAD_TOL[dtype]:
        raise AssertionError(f"the kernel route disagrees with the matmul route at {shape} "
                             f"{dtype}")
    return row


def time_routes(shape, dtype, card: str) -> dict:
    from rgie_tpu_torch.ops.kernels import flash_attention as FA

    q, k, v, do = _inputs(shape, dtype, 1)
    scale = 1.0 / math.sqrt(shape[3])
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
    fns = [lambda: FA.flash_attention(q, k, v, sm_scale=scale),
           lambda: matmul_route(q, k, v, scale),
           lambda: torch.autograd.grad(FA.flash_attention(ql, kl, vl, sm_scale=scale),
                                       (ql, kl, vl), do),
           lambda: torch.autograd.grad(matmul_route(ql, kl, vl, scale), (ql, kl, vl), do)]
    try:
        ms = time_ms(fns, calls=CALLS)
    except torch.cuda.OutOfMemoryError:     # the matmul route's N x N scores
        torch.cuda.empty_cache()
        fwd, both = time_ms([fns[0], fns[2]], calls=CALLS)
        ms = [fwd, None, both, None]
    wins = ms[1] is None or (ms[0] < ms[1] and ms[2] < ms[3])
    gate = FA.flash_self_attention_ok(shape[2], shape[2], shape[3])
    row = {"shape": list(shape), "dtype": _type_name(dtype), "fwd_kernel_ms": ms[0],
           "fwd_matmul_ms": ms[1], "fwd_bwd_kernel_ms": ms[2], "fwd_bwd_matmul_ms": ms[3],
           "kernel_wins": wins, "gate": gate}
    fmt = lambda x: "out of memory" if x is None else f"{x:.4f}"
    print(f"routes {shape} {row['dtype']} ms on {card}: forward kernel {fmt(ms[0])} matmul "
          f"{fmt(ms[1])}; forward + backward kernel {fmt(ms[2])} matmul {fmt(ms[3])}; kernel "
          f"wins both: {wins}; gate open: {gate}")
    return row


def time_unet(card: str) -> List[dict]:
    from rgie_tpu_torch.diffusion.unet import UNetConfig, create_unet
    from rgie_tpu_torch.ops.kernels import flash_attention as FA

    unet = create_unet(torch.Generator().manual_seed(0), UNetConfig.sd21()).cuda()
    unet.requires_grad_(False)
    g = torch.Generator().manual_seed(1)
    runs = [("forward", 1024, 2, THRESHOLDS), ("forward", 512, 16, THRESHOLDS),
            ("forward + backward", 512, 8, THRESHOLDS),
            ("forward + backward", 512, 16, (1024, 256, 64))]
    saved = FA.FLASH_ATTN, FA.MIN_FLASH_SEQ_LEN
    rows = []
    for dtype in TYPES:
        unet.to(dtype)
        for what, px, batch, thresholds in runs:
            lat = torch.randn((batch, px // 8, px // 8, 4), generator=g).cuda().to(dtype)
            ctx = torch.randn((batch, 77, 1024), generator=g).cuda().to(dtype)
            t = torch.full((batch,), 500, device="cuda")

            def under(threshold):
                def call():
                    FA.FLASH_ATTN, FA.MIN_FLASH_SEQ_LEN = (
                        ("0", saved[1]) if threshold == "closed" else (saved[0], threshold))
                    if what == "forward":
                        with torch.no_grad():
                            unet(lat, t, ctx)
                        return
                    c = ctx.detach().requires_grad_()
                    eps = unet(lat, t, c)[0]
                    torch.autograd.grad(eps.float().square().sum(), c)
                return call

            fns = [under(threshold) for threshold in thresholds]
            try:
                windows = time_windows(fns, 2, UNET_REPS)
                peaks = []
                for fn in fns:
                    torch.cuda.reset_peak_memory_stats()
                    fn()
                    torch.cuda.synchronize()
                    peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
            finally:
                FA.FLASH_ATTN, FA.MIN_FLASH_SEQ_LEN = saved
            name = f"SD-2.1 UNet {what}, {px} px, batch {batch}"
            for threshold, ts, peak in zip(thresholds, windows, peaks):
                q1, median, q3 = statistics.quantiles(ts, n=4)
                rows.append({"what": name, "dtype": _type_name(dtype), "threshold": threshold,
                             "ms": median, "q1_ms": q1, "q3_ms": q3, "peak_gib": peak})
                print(f"{name}, {_type_name(dtype)}, gate {threshold} on {card}: {median:.2f} ms "
                      f"(quartiles {q1:.2f}-{q3:.2f}, {UNET_REPS} windows), peak {peak:.2f} GiB")
            del lat, ctx
            torch.cuda.empty_cache()
    return rows


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--skip-timing", action="store_true")
    args = ap.parse_args(argv)
    from rgie_tpu_torch.cli.bench import device_info
    from rgie_tpu_torch.device import resolve_device

    info = device_info(resolve_device("cuda"))
    card = f"{info['device']}, {info['power_limit']}"
    print(f"{card}; torch {info['torch']}, CUDA {info['cuda']}")
    t0 = time.perf_counter()
    result = {**info, "parity": []}
    for s in SHAPES:
        for d in TYPES:
            result["parity"].append(check_parity(s, d, card))
            torch.cuda.empty_cache()
    if not args.skip_timing:
        result["routes"] = []
        for s in SHAPES:
            for d in TYPES:
                result["routes"].append(time_routes(s, d, card))
                torch.cuda.empty_cache()
        result["unet"] = time_unet(card)
    print(f"PARITY_OK in {time.perf_counter() - t0:.1f} s")
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
