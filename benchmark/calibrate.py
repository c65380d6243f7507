"""The readings a cell's limits are set from, in one process on the card:
for each seed the program's numbers against the float32 reference (a window
of one batch, or the training cell's first steps, at the cell's own sizes),
and for the control seeds the reference one step below each part's type
against the float32 reference. One JSON line per reading.

    python3 benchmark/calibrate.py --workload sd21-512-nto-b8 --seeds 11 12 13 --control 11

Not part of a benchmark run: ``run.py`` never runs the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import common, run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[],
                    help="training cells: faults planted in the reference (half, labels), "
                         "read on the control seeds")
    args = ap.parse_args(argv)
    import torch

    cell, config, traffic = common.cell_files(args.workload)
    device = run.require_device(cell["chips"])
    cls = run.cell_class(traffic["kind"])
    for seed in args.seeds:
        t0 = time.perf_counter()
        runner = cls(cell, config, traffic, seed, device)
        runner.setup()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        win = runner.window(0.0)
        t2 = time.perf_counter()
        numbers = runner.check()
        t3 = time.perf_counter()
        print(json.dumps({"workload": args.workload, "seed": seed, "side": "program",
                          "numbers": numbers, "setup_s": t1 - t0, "window_s": t2 - t1,
                          "window_images": win["images"], "check_s": t3 - t2}), flush=True)
        del runner
        torch.cuda.empty_cache()
    for seed in args.control:
        t0 = time.perf_counter()
        runner = cls(cell, config, traffic, seed, device)
        if traffic["kind"] == "train":
            runner.setup()
            runner.free_program()
            numbers = runner.control()
            for name in args.faults:
                print(json.dumps({"workload": args.workload, "seed": seed, "side": name,
                                  "numbers": runner.fault(name)}), flush=True)
        else:
            runner.empty_inputs()
            gen = torch.Generator(device=device).manual_seed(common.derive_seed(seed, "window"))
            from benchmark.kinds.edit import Inputs

            numbers = runner.control(Inputs(runner, gen, runner.batch))
        print(json.dumps({"workload": args.workload, "seed": seed, "side": "control",
                          "numbers": numbers, "seconds": time.perf_counter() - t0}), flush=True)
        del runner
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
