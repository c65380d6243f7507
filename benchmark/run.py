"""Run one cell of the benchmark of ``rgie_tpu_torch`` on this machine's CUDA
device and print its result as the last line of standard output.

    python3 benchmark/run.py --workload sd21-512-nto-b8 --seed 7 --seconds 40 --trace 0

A cell is ``benchmark/workloads/<name>.json``; it names a configuration
(``configs/``) and a traffic mix (``traffic/``), whose ``kind`` names the
module under ``kinds/`` that drives it. With ``--trace 0`` the result holds
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, each
read by ``metrics/<name>.py`` from the window and one traced stretch after
it. Every run then checks what its window produced against the plain
reference under ``reference/`` and prints each number compared beside its
limit, last.

Builds and caches stay inside the checkout: the kernels under
``build/kernels`` (the program's own fixed directory), Triton's and PyTorch's
extension caches under ``build/``.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import common  # noqa: E402


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cell_class(kind: str):
    """The class that drives a traffic mix of ``kind``: ``kinds/<kind>.py``'s
    ``CELL``."""
    return importlib.import_module(f"benchmark.kinds.{kind}").CELL


def cell_metrics(spec: dict, workload: str, trace: bool) -> list:
    """The entries of ``BENCHMARK.json`` this cell reports in this mode."""
    entries = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in entries if workload in m.get("workloads", [workload])]


def require_device(chips: int) -> "torch.device":
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("no CUDA device: the benchmark runs on the card only\n")
        raise SystemExit(2)
    if torch.cuda.device_count() < chips:
        sys.stderr.write(f"the cell needs {chips} CUDA devices, "
                         f"{torch.cuda.device_count()} found\n")
        raise SystemExit(2)
    from rgie_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def run_cell(spec: dict, workload: str, cell: dict, config: dict, traffic: dict, seed: int,
             seconds: float, trace: bool, device, t_start: float) -> dict:
    """Set up, run the window, read the metrics and check the result of one
    cell on ``device``; returns the result line's object."""
    import torch

    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    t_cell = time.perf_counter()
    runner = cell_class(traffic["kind"])(cell, config, traffic, seed, device)
    runner.setup()
    sync()
    setup_s = time.perf_counter() - t_start
    print(json.dumps({"setup_parts": dict(runner.setup_parts, start_s=t_cell - t_start)}),
          flush=True)

    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    win = runner.window(seconds)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    common.check_imports("once the window closed")
    notes = {k: win[k] for k in ("batches", "steps", "batch_s") if k in win}
    if "logs" in win:
        notes["phase_s"] = [log.seconds for log in win["logs"]]
    print(json.dumps({"window_notes": notes}), flush=True)

    metrics, breakdown = {}, None
    device_rec = dict(common.device_record(cell["chips"]) if on_card else
                      {"platform": "cpu", "kind": "cpu", "count": 1}, memory_peak_bytes=peak)
    wanted = cell_metrics(spec, workload, trace)
    if trace:
        ctx = runner.trace_context(win)
        tr = ctx["trace"]
        device_rec.update(busy_s=tr.busy_s, window_s=tr.window_s)
        breakdown = {"device_ops": tr.device_ops, "idle_gaps": tr.idle_gaps}
        for m in wanted:
            value = common.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        print(json.dumps({"trace_notes": {
            "k2_launches": ctx.get("launches"),
            "k2_shapes": ctx.get("k2_shapes"),
            "inner_iterations_per_outer_step": ctx.get("inner_per_outer"),
            "device_operations": tr.device_count,
            "idle_share_from_busy_and_window": 1.0 - tr.busy_s / tr.window_s}}), flush=True)
    else:
        measured = dict(runner.e2e(win), peak_mem_gib=peak / 2 ** 30, setup_s=setup_s)
        for m in wanted:
            metrics[m["name"]] = {"value": measured[m["name"]], "unit": m["unit"]}

    numbers = runner.check()
    limits = cell["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items() if k in limits}
    missing = sorted(set(limits) - set(numbers))
    correct = not missing and all(c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": win["images"],
              "failed": 0 if correct else runner.checked_count,
              "metrics": metrics, "device": device_rec}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    for k, c in checks.items():
        sys.stderr.write(f"check {k}: {c['value']!r} limit {c['limit']!r}\n")
    for k in missing:
        sys.stderr.write(f"check {k}: not computed\n")
    sys.stderr.flush()
    return result


def main(argv=None) -> int:
    args = parse(argv)
    common.check_imports("at the start")
    t_start = time.perf_counter()
    spec = common.read_json(ROOT / "BENCHMARK.json")
    cell, config, traffic = common.cell_files(args.workload)
    device = require_device(cell["chips"])
    result = run_cell(spec, args.workload, cell, config, traffic, args.seed, args.seconds,
                      bool(args.trace), device, t_start)
    common.check_imports("before the result")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
