"""The program's own ranges on the profiler's clock: one traced stretch that
records the device's operations, the runtime calls that launched them and
the ``record_function`` ranges of ``rgie_tpu_torch`` (``utils/spans.py``;
user scope only, never an ATen operator), and what each range holds.

Each device operation is joined to the runtime call that launched it by
correlation id, and charged to the innermost program range open on the
launching thread at that moment, or on the main thread's where the launching
thread has none open (autograd launches a backward from a device thread of
its own). Each idle gap of the device is charged to the innermost range open
on the main thread where it starts.

``run.py`` does not call this yet: its traced run records device activity
only (``trace.traced``). Run by hand, on the card, it sets a cell up as
``run.py`` does and traces whole batches (training: 3 s of steps) both ways,
in turns, beside an untraced one, and prints one JSON object with each
traced stretch's wall seconds and idle share, the figures the ranges give
(``RangeTrace.readings``), the device and idle seconds by range, and the
idle gaps by host call as ``trace.Trace`` charges them when the ranges are
host events:

    python3 benchmark/spans.py --workload sdxl-1024-nto-b2 --seed 7 --rounds 2
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import re
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Tuple

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark.common import PEAK_BF16_FLOPS, PEAK_FP32_FLOPS, PEAK_HBM_BYTES  # noqa: E402
from benchmark.flops import gaps, union_seconds  # noqa: E402
from benchmark.trace import WINDOW, Trace, _annotation  # noqa: E402

#: ``attn.<route>.<type>.<B>x<H>x<N>x<M>x<d>``, as ``utils/spans.py`` names
#: one attention call.
ATTENTION = re.compile(r"^attn\.(k2|matmul)\.(\w+)\.(\d+)x(\d+)x(\d+)x(\d+)x(\d+)$")
#: Bytes per value of each type an attention range names.
WIDTHS = {"bf16": 2, "f16": 2, "f32": 4}
#: What a launch or a gap is charged to where no program range is open.
OUTSIDE = "_no_program_range_"
#: ... and a device operation no recorded runtime call launched.
UNLAUNCHED = "_no_launch_recorded_"
SHOWN = 24


def attention_least_seconds(dtype: str, batch: int, heads: int, n: int, m: int,
                            width: int) -> float:
    """The least time of one attention call of ``heads`` heads of ``width``
    over ``n`` queries and ``m`` keys in ``dtype`` (``bf16``, ``f16`` or
    ``f32``): the larger of its 4 B H N M d operations (Q K^T and P V) over
    the peak of its type (the bf16 tensor cores, or float32 on the CUDA
    cores) and its bytes (Q and O, (B, H, N, d) each, K and V, (B, H, M, d)
    each, read or written once) over the HBM peak. Where the operations bound
    it, as they do for every self-attention the UNet and VAE run, it equals
    ``flops.flash_least_seconds("fwd", ...)`` at M = N."""
    size = WIDTHS[dtype]
    flops = 4.0 * batch * heads * n * m * width
    peak = PEAK_BF16_FLOPS if size == 2 else PEAK_FP32_FLOPS
    data = batch * heads * 2 * (n + m) * width * size
    return max(flops / peak, data / PEAK_HBM_BYTES)


def _open_at(ranges: List[Tuple[int, int, str, int]], queries: Iterable[Tuple[int, int, object]],
             main: int) -> Dict[object, Tuple[int, ...]]:
    """For each query (time, thread, key), the indices into ``ranges`` (start,
    end, name, thread) of the ranges open on that thread at that time,
    outermost first; the main thread's where that thread has none open."""
    events = [(s, 0, i) for i, (s, _, _, _) in enumerate(ranges)]
    events += [(e, 2, i) for i, (_, e, _, _) in enumerate(ranges)]
    events += [(t, 1, (tid, key)) for t, tid, key in queries]
    events.sort(key=lambda ev: (ev[0], ev[1]))
    stacks: Dict[int, List[int]] = defaultdict(list)
    out: Dict[object, Tuple[int, ...]] = {}
    for _, kind, item in events:
        if kind == 0:
            stacks[ranges[item][3]].append(item)
        elif kind == 2:
            stack = stacks[ranges[item][3]]
            if stack and stack[-1] == item:
                stack.pop()
            elif item in stack:
                stack.remove(item)
        else:
            tid, key = item
            out[key] = tuple(stacks.get(tid) or stacks[main])
    return out


def _covered(merged: List[Tuple[int, int]], starts: List[int], lo: int, hi: int) -> int:
    """The length of [lo, hi] that the disjoint sorted intervals ``merged``
    cover."""
    total = 0
    for s, e in merged[max(bisect.bisect_right(starts, lo) - 1, 0):]:
        if s >= hi:
            break
        total += max(0, min(e, hi) - max(s, lo))
    return total


def _merge(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class RangeTrace:
    """One traced stretch with the program's ranges: ``device`` (start, end,
    name, correlation id), ``ranges`` (start, end, name, thread) of the
    program, ``runtime`` (start, end, name, thread, correlation id), the
    runtime calls, launches among them; the window [t0, t1] on the
    profiler's clock and the main thread. ``trace`` is the ``trace.Trace``
    of the same events, the ranges counting as host calls."""

    def __init__(self, window_s: float, device: List[Tuple[int, int, str, int]],
                 ranges: List[Tuple[int, int, str, int]],
                 runtime: List[Tuple[int, int, str, int, int]], t0: int, t1: int, main: int):
        self.window_s, self.t0, self.t1, self.main = window_s, t0, t1, main
        self.device = [(max(s, t0), min(e, t1), n, c) for s, e, n, c in device
                       if e > t0 and s < t1]
        self.ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))   # outer first
        self.runtime = runtime
        self.trace = Trace(window_s, [(s, e, n) for s, e, n, _ in self.device],
                           [(s, e, n) for s, e, n, _, _ in runtime]
                           + [(s, e, n) for s, e, n, _ in self.ranges], t0, t1)
        launched = {c: (s, tid) for s, _, _, tid, c in runtime}
        chains = _open_at(self.ranges, ((s, tid, c) for c, (s, tid) in launched.items()),
                          main)
        #: Device seconds launched inside each range (nested ranges included).
        self.inclusive_s = [0.0] * len(self.ranges)
        by_span: Dict[str, float] = defaultdict(float)
        for s, e, _, c in self.device:
            chain = chains.get(c)
            if chain is None:
                by_span[UNLAUNCHED] += (e - s) * 1e-9
                continue
            for i in chain:
                self.inclusive_s[i] += (e - s) * 1e-9
            by_span[self.ranges[chain[-1]][2] if chain else OUTSIDE] += (e - s) * 1e-9
        #: Device seconds by the innermost range open at their launch.
        self.device_s_by_span = dict(by_span)
        self.merged = _merge((s, e) for s, e, _, _ in self.device)
        idle = gaps(self.merged, t0, t1)
        at = _open_at(self.ranges, ((a, main, k) for k, (a, _) in enumerate(idle)), main)
        idle_by: Dict[str, float] = defaultdict(float)
        for k, (a, b) in enumerate(idle):
            chain = at[k]
            idle_by[self.ranges[chain[-1]][2] if chain else OUTSIDE] += (b - a) * 1e-9
        #: Idle seconds by the innermost range open where each gap starts.
        self.idle_s_by_span = dict(idle_by)

    @property
    def busy_s(self) -> float:
        return union_seconds(self.merged) * 1e-9

    def named(self, name: str) -> List[int]:
        return [i for i, r in enumerate(self.ranges) if r[2] == name]

    def idle_pct(self, name: str) -> Optional[float]:
        """100 x the length of the ranges called ``name`` that no device
        operation covers, over their length; None where none ran."""
        found = self.named(name)
        length = sum(self.ranges[i][1] - self.ranges[i][0] for i in found)
        if not length:
            return None
        starts = [s for s, _ in self.merged]
        covered = sum(_covered(self.merged, starts, *self.ranges[i][:2]) for i in found)
        return 100.0 * (length - covered) / length

    def attention_roofline(self) -> Optional[float]:
        """100 x the least time of the ``attn.*`` ranges at the shapes they
        name, over the device time launched inside them; None where none ran.
        A range with no device operation recorded inside it (the trace lost
        them) counts on neither side (``attention_unrecorded``)."""
        least = device = 0.0
        for i, (_, _, name, _) in enumerate(self.ranges):
            match = ATTENTION.match(name)
            if match is None or self.inclusive_s[i] <= 0:
                continue
            _, dtype, *shape = match.groups()
            least += attention_least_seconds(dtype, *(int(x) for x in shape))
            device += self.inclusive_s[i]
        return 100.0 * least / device if device else None

    def attention_unrecorded(self) -> int:
        """The ``attn.*`` ranges with no device operation recorded inside."""
        return sum(1 for i, r in enumerate(self.ranges)
                   if ATTENTION.match(r[2]) and self.inclusive_s[i] <= 0)

    def device_ms_per(self, name: str) -> Optional[float]:
        """Device milliseconds launched inside each range called ``name``."""
        found = self.named(name)
        if not found:
            return None
        return 1000.0 * sum(self.inclusive_s[i] for i in found) / len(found)

    def readings(self) -> Dict[str, float]:
        """The figures the ranges give: the idle share of null-text
        optimization and of sampling, attention's forward roofline, the
        device milliseconds of a training batch's features; each only where
        its ranges ran."""
        found = {"nto_idle_pct": self.idle_pct("edit.nto"),
                 "sample_idle_pct": self.idle_pct("edit.sample"),
                 "attn_fwd_roofline": self.attention_roofline(),
                 "features_device_ms": self.device_ms_per("train.features")}
        return {k: v for k, v in found.items() if v is not None}

    def summary(self) -> dict:
        idle_s = sum(v for _, v in self.trace.idle_gaps)
        unnamed = sum(v for n, v in self.trace.idle_gaps if n == "_no_host_operation_")
        return {
            "window_s": self.window_s, "idle_pct": 100.0 * (1.0 - self.busy_s / self.window_s),
            "readings": self.readings(), "ranges": len(self.ranges),
            "device_operations": len(self.device), "runtime_calls": len(self.runtime),
            "device_s_by_span": _top(self.device_s_by_span),
            "idle_s_by_span": _top(self.idle_s_by_span),
            "idle_gaps": self.trace.idle_gaps,
            "no_host_operation_share_of_shown_idle": unnamed / idle_s if idle_s else None,
            "attention_calls": _attention_calls(self),
            "attention_unrecorded": self.attention_unrecorded(),
        }


def _top(by: Dict[str, float]) -> List[list]:
    return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:SHOWN]]


def _attention_calls(rt: RangeTrace) -> List[list]:
    """Per attention range name: calls, device seconds, least seconds."""
    rows: Dict[str, List[float]] = {}
    for i, (_, _, name, _) in enumerate(rt.ranges):
        match = ATTENTION.match(name)
        if match:
            row = rows.setdefault(name, [0, 0.0, 0.0])
            row[0] += 1
            row[1] += rt.inclusive_s[i]
            row[2] += attention_least_seconds(match.group(2),
                                              *(int(x) for x in match.groups()[2:]))
    return [[n, *r] for n, r in sorted(rows.items(), key=lambda kv: -kv[1][1])]


def traced_ranges(fn: Callable[[], None]) -> RangeTrace:
    """Run ``fn`` (which ends by waiting for the device) under the profiler
    recording the device, the runtime and the program's ranges, and join
    them. ``window_s`` is the host clock's time from the start of ``fn`` to
    the synchronised end."""
    import torch
    from torch._C._profiler import ProfilerActivity, RecordScope, _ExperimentalConfig
    from torch.autograd import DeviceType
    from torch.autograd.profiler import (ProfilerConfig, ProfilerState, _disable_profiler,
                                         _enable_profiler, _prepare_profiler)
    from torch.profiler import record_function

    config = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                            _ExperimentalConfig())
    activities = {ProfilerActivity.CPU, ProfilerActivity.CUDA}
    torch.cuda.synchronize()
    _prepare_profiler(config, activities)
    _enable_profiler(config, activities, {RecordScope.USER_SCOPE})
    try:
        with record_function(WINDOW):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
    finally:
        result = _disable_profiler()
    device, ranges, runtime, span, main = [], [], [], None, None
    for e in result.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        on_device = e.device_type() == DeviceType.CUDA
        if on_device:
            if not _annotation(e):
                device.append((start, end, e.name(), e.correlation_id()))
        elif e.name() == WINDOW:
            span, main = (start, end), e.start_thread_id()
        elif e.is_user_annotation():
            ranges.append((start, end, e.name(), e.start_thread_id()))
        else:
            runtime.append((start, end, e.name(), e.start_thread_id(), e.correlation_id()))
    if not device or span is None:
        raise RuntimeError("the profiler recorded no device operation or no window")
    return RangeTrace(window_s, device, ranges, runtime, span[0], span[1], main)


def _batch(runner, seed: int) -> Callable[[], object]:
    """One unit of the cell's work, on fresh draws each call: an edit batch
    (returning its ``RunLog``), or 3 s of training steps."""
    import torch

    from benchmark import common

    if runner.name == "train":
        return lambda: runner.window(3.0)
    from benchmark.kinds.edit import Inputs

    gen = torch.Generator(device=runner.device).manual_seed(common.derive_seed(seed, "spans"))
    return lambda: runner.run_batch(runner.program, Inputs(runner, gen, runner.batch))[1]


def main(argv=None) -> int:
    import torch

    from benchmark import common, run
    from benchmark.trace import traced

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rounds", type=int, default=2,
                    help="rounds of (untraced, device-only, ranges), every other one reversed")
    ap.add_argument("--out", default=None, help="also write the JSON object to this file")
    args = ap.parse_args(argv)
    common.check_imports("at the start")
    cell, config, traffic = common.cell_files(args.workload)
    device = run.require_device(cell["chips"])
    runner = run.cell_class(traffic["kind"])(cell, config, traffic, args.seed, device)
    runner.setup()
    batch = _batch(runner, args.seed)

    def untraced():
        t0 = time.perf_counter()
        batch()
        torch.cuda.synchronize()
        return {"window_s": time.perf_counter() - t0}

    def device_only():
        tr = traced(batch)
        return {"window_s": tr.window_s, "idle_pct": 100.0 * (1.0 - tr.busy_s / tr.window_s),
                "idle_gaps": tr.idle_gaps}

    def with_ranges():
        box = {}
        rt = traced_ranges(lambda: box.update(log=batch()))
        out = rt.summary()
        log = box["log"]
        if hasattr(log, "seconds"):
            out["run_log_seconds"] = log.seconds
            out["range_seconds"] = {rt.ranges[i][2]: (rt.ranges[i][1] - rt.ranges[i][0]) * 1e-9
                                    for i in range(len(rt.ranges))
                                    if rt.ranges[i][2].startswith("edit.")}
            out["nto_inner_steps"] = log.nto_inner_steps
        return out

    order = [("untraced", untraced), ("device_only", device_only), ("ranges", with_ranges)]
    rounds = []
    for r in range(args.rounds):
        done = {}
        for name, fn in (order if r % 2 == 0 else order[::-1]):
            done[name] = fn()
        rounds.append(done)
    result = {"workload": args.workload, "seed": args.seed,
              "device": common.device_record(cell["chips"]), "torch": torch.__version__,
              "rounds": rounds}
    common.check_imports("before the result")
    text = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
