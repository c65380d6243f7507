"""Kernel K1 at one shape, one JSON row: port of ``scripts/bench_fused_chain.py``.

    python -m rgie_tpu_torch.cli.bench_fused_chain [--batch 12 --size 1024] --device cuda

K1 (``csrc/pointwise_chain.cu``, the exposure -> saturation -> tone -> color
-> contrast prefix of the chain) on (B, S, S, 3) random float32 images with
parameters drawn as ``tests/test_pallas.py`` draws them, checked against its
plain version (the separate ops) at 2e-5, then timed: a call (CUDA events
around the wrapper, host work included), the device alone (the call
replayed from a CUDA graph, as ``chip_smoke.py`` times it), the plain
version, and the least time the card could take (the bytes K1 must move,
each input read once and the output written once, over the HBM3 rate of
3.35 TB/s; its arithmetic is far below the float32 rate). The default shape
is ``run_img_trans``'s batch, (12, 1024, 1024, 3). On ``--device cpu`` the
wrapper runs its plain two-pass version: the row then holds host times and
no device time.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import numpy as np
import torch

#: The largest difference K1 may show against its plain version
#: (tests/test_pallas.py's tolerance).
TOLERANCE = 2e-5
PEAK_BYTES = 3.35e12


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=12)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def draw_params(rng: np.random.Generator, device: torch.device):
    """K1's parameters drawn as tests/test_pallas.py:12-20 draws them."""
    from rgie_tpu_torch.ops import chain as CH

    p = CH.init_params(device=device)
    p.exposure = torch.tensor(rng.uniform(-0.4, 0.4), dtype=torch.float32, device=device)
    p.saturation = torch.tensor(rng.uniform(0.4, 1.8), dtype=torch.float32, device=device)
    p.contrast = torch.tensor(rng.uniform(0.5, 1.6), dtype=torch.float32, device=device)
    p.tone = torch.tensor(rng.uniform(0.6, 1.4, (8, 1)), dtype=torch.float32, device=device)
    p.color = torch.tensor(rng.uniform(0.6, 1.4, (8, 3)), dtype=torch.float32, device=device)
    return p


def median_ms(fn, device: torch.device, runs: int) -> float:
    """Median milliseconds of ``fn()``: CUDA events on the card, the host's
    clock on the CPU; after two warm-up calls."""
    fn(), fn()
    times = []
    for _ in range(runs):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def bench(batch: int, size: int, device: torch.device, runs: int = 20, seed: int = 0) -> dict:
    """The row for K1 at (batch, size, size, 3) on ``device``."""
    from rgie_tpu_torch.ops.kernels import pointwise_chain as PC

    rng = np.random.default_rng(seed)
    shape = (batch, size, size, 3)
    img = torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32)).to(device)
    params = draw_params(rng, device)
    err = float((PC.pointwise_chain(img, params)
                 - PC.reference_pointwise_chain(img, params)).abs().max())
    if err > TOLERANCE:
        raise AssertionError(f"K1 differs from its plain version by {err:.3e} at {shape}")
    call_ms = median_ms(lambda: PC.pointwise_chain(img, params), device, runs)
    plain_ms = median_ms(lambda: PC.reference_pointwise_chain(img, params), device, runs)
    device_ms = None
    if device.type == "cuda":
        from rgie_tpu_torch.cli.kernel_variants import graph_ms

        device_ms = graph_ms(lambda: PC.pointwise_chain(img, params))
    n_bytes = 2 * 4 * int(np.prod(shape))
    return {
        "metric": f"K1 pointwise chain, float32, {shape}",
        "value": device_ms if device_ms is not None else call_ms,
        "unit": "ms on the device (CUDA graph replay)" if device_ms is not None
                else "ms a call on the host (plain two-pass version)",
        "detail": {"shape": list(shape), "device": str(device), "call_ms": call_ms,
                   "device_ms": device_ms, "plain_ms": plain_ms, "bytes": n_bytes,
                   "bound_ms": n_bytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
                   "max_abs_err": err, "tolerance": TOLERANCE, "runs": runs},
    }


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    from rgie_tpu_torch.device import resolve_device

    row = bench(args.batch, args.size, resolve_device(args.device), args.runs, args.seed)
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
