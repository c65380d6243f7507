"""Host throughput of the native C++ preprocessing feeder
(``native/preprocess.cpp``: shorter-side resize, center crop, [0, 1] float,
pthread pool) against the PIL path: port of ``scripts/bench_preprocess.py``.

    python -m rgie_tpu_torch.cli.bench_preprocess [--n 64] [--hw 640] [--crop 512]

Prints one JSON line: images/s of ``preprocess_batch`` and its ratio to the
per-image PIL loop, with ``path`` naming what ran (``native`` or, when the
library cannot load, ``pil``), and appends it to
``artifacts/bench_history_torch.jsonl``. Host work only: no device runs.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Sequence

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--hw", type=int, default=640)
    ap.add_argument("--resize", type=int, default=512)
    ap.add_argument("--crop", type=int, default=512)
    ap.add_argument("--runs", type=int, default=5)
    return ap


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    from rgie_tpu_torch.data.dataset import preprocess_image
    from rgie_tpu_torch.data.native_preprocess import native_available, preprocess_batch
    from rgie_tpu_torch.utils.bench_history import record

    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (args.hw, args.hw + 32, 3), dtype=np.uint8)
              for _ in range(args.n)]

    def rate(fn) -> float:
        t0 = time.perf_counter()
        for _ in range(args.runs):
            fn()
        return args.n * args.runs / (time.perf_counter() - t0)

    path = "native" if native_available() else "pil"
    preprocess_batch(images[:4], args.resize, args.crop)     # the pool's warm-up
    batch_ips = rate(lambda: preprocess_batch(images, args.resize, args.crop))
    pil_ips = rate(lambda: [preprocess_image(img.astype(np.float32) / 255.0, args.resize,
                                             args.crop) for img in images])
    row = {
        "metric": f"host preprocess {args.hw}px->{args.crop}px",
        "value": batch_ips, "unit": f"images/sec ({path})", "vs_baseline": batch_ips / pil_ips,
        "detail": {"path": path, "pil_ips": pil_ips, "n": args.n, "runs": args.runs,
                   "threads": min(8, os.cpu_count() or 1)},
    }
    print(f"preprocess_batch ran the {path} path", flush=True)
    print(json.dumps(row), flush=True)
    record("cli.bench_preprocess", row)
    return row


if __name__ == "__main__":
    main()
