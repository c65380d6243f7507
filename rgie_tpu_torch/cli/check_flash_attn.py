"""On-card parity and timing of the attention modules' two routes: port of
``scripts/check_flash_attn.py``. The kernel route (``flash_attention``, the
CUDA kernels) against the matmul route (matmul, float32 softmax, matmul, as
``CrossAttention`` runs below the gate).

    python -m rgie_tpu_torch.cli.check_flash_attn [--skip-timing]

1. Parity: forward and gradients (q, k, v) of both routes on the same inputs
   at the UNet's (2, 5, 4096, 64) in bfloat16 and float32, the VAE's
   (1, 1, 4096, 512), and the gated shapes (1, 2, 16384, 64) and
   (1, 1, 16384, 512): the forward within ``FWD_TOL`` of the largest entry,
   each gradient within ``GRAD_TOL`` of its largest entry (bfloat16: the
   JAX script's limits; float32: both routes sum in float32).
2. Times (CUDA events, median of 5): forward, and forward + backward, of
   both routes at N in {1024, 4096, 16384} with SD-2.1's head counts at
   those levels of a 1024 px edit (20, 10 and 5 heads of 64; batch 2, the
   CFG pair), in both types. These are the data for the gate's threshold
   per type (``MIN_FLASH_SEQ_LEN``), which this script does not change.
3. A full-width SD-2.1 UNet forward at 1024 px (batch 2, random weights) in
   both types with the gate open and closed (the gate closed by setting the
   module's ``FLASH_ATTN`` to "0" here, as ``RGIE_FLASH_ATTN=0`` does).

Needs CUDA. Every line carries the card's name and power limit; the last line
is one JSON object with all the numbers.
"""

from __future__ import annotations

import argparse
import json
import math
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

FWD_TOL = {torch.bfloat16: 0.06, torch.float32: 1e-4}
GRAD_TOL = {torch.bfloat16: 0.05, torch.float32: 1e-4}
PARITY_SHAPES = [(2, 5, 4096, 64), (1, 1, 4096, 512), (1, 2, 16384, 64), (1, 1, 16384, 512)]
ROUTE_SHAPES = [(2, 20, 1024, 64), (2, 10, 4096, 64), (2, 5, 16384, 64)]


def matmul_route(q, k, v, scale: float):
    """The attention modules' route below the gate (``CrossAttention``)."""
    attn = torch.matmul(q, k.transpose(-1, -2)) * scale
    attn = torch.softmax(attn.float(), dim=-1).to(q.dtype)
    return torch.matmul(attn, v)


def time_ms(fns: List[Callable[[], object]], warmup: int = 1, reps: int = 5) -> List[float]:
    """Median milliseconds of each ``fn()``, CUDA events, in alternation."""
    for _ in range(warmup):
        for fn in fns:
            fn()
    times = [[] for _ in fns]
    for _ in range(reps):
        for fn, ts in zip(fns, times):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
    return [float(np.median(ts)) for ts in times]


def _inputs(shape, dtype, seed: int):
    b, h, n, d = shape
    g = torch.Generator().manual_seed(seed)
    # (b, n, h, d) storage seen as (b, h, n, d): the modules' own layout.
    return [torch.randn((b, n, h, d), generator=g).cuda().to(dtype).transpose(1, 2)
            for _ in range(4)]


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
    row = {"shape": list(shape), "dtype": str(dtype)[6:], "fwd": rel(o_k, o_m),
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
        ms = time_ms(fns)
    except torch.cuda.OutOfMemoryError:     # the matmul route's N x N scores
        torch.cuda.empty_cache()
        fwd, both = time_ms([fns[0], fns[2]])
        ms = [fwd, None, both, None]
    row = {"shape": list(shape), "dtype": str(dtype)[6:], "fwd_kernel_ms": ms[0],
           "fwd_matmul_ms": ms[1], "fwd_bwd_kernel_ms": ms[2], "fwd_bwd_matmul_ms": ms[3]}
    fmt = lambda x: "out of memory" if x is None else f"{x:.3f}"
    print(f"routes {shape} {row['dtype']} ms on {card}: forward kernel {fmt(ms[0])} matmul "
          f"{fmt(ms[1])}; forward + backward kernel {fmt(ms[2])} matmul {fmt(ms[3])}")
    return row


def time_unet(card: str) -> List[dict]:
    from rgie_tpu_torch.diffusion.unet import UNetConfig, create_unet
    from rgie_tpu_torch.ops.kernels import flash_attention as FA

    unet = create_unet(torch.Generator().manual_seed(0), UNetConfig.sd21()).cuda()
    g = torch.Generator().manual_seed(1)
    lat = torch.randn((2, 128, 128, 4), generator=g).cuda()
    ctx = torch.randn((2, 77, 1024), generator=g).cuda()
    t = torch.tensor([500, 500], device="cuda")
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        unet.to(dtype)
        ms = {}
        saved = FA.FLASH_ATTN
        try:
            for gate in ("open", "closed"):
                FA.FLASH_ATTN = saved if gate == "open" else "0"
                with torch.no_grad():
                    ms[gate] = time_ms([lambda: unet(lat, t, ctx)], warmup=2, reps=5)[0]
        finally:
            FA.FLASH_ATTN = saved
        rows.append({"what": "SD-2.1 UNet forward, 1024 px, batch 2", "dtype": str(dtype)[6:],
                     "gate_open_ms": ms["open"], "gate_closed_ms": ms["closed"]})
        print(f"SD-2.1 UNet forward at 1024 px, batch 2, {str(dtype)[6:]} on {card}: gate open "
              f"(kernels at the 16384-position sites) {ms['open']:.2f} ms, gate closed "
              f"{ms['closed']:.2f} ms")
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
    result = {**info, "parity": [check_parity(s, d, card) for s in PARITY_SHAPES
                                 for d in (torch.bfloat16, torch.float32)]}
    torch.cuda.empty_cache()
    if not args.skip_timing:
        result["routes"] = [time_routes(s, d, card) for s in ROUTE_SHAPES
                            for d in (torch.bfloat16, torch.float32)]
        torch.cuda.empty_cache()
        result["unet_forward"] = time_unet(card)
    print(f"PARITY_OK in {time.perf_counter() - t0:.1f} s")
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
