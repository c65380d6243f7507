"""One traced window under ``torch.profiler``: the device's intervals, the
time by kernel name and the idle gaps by what the host was doing."""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator, List, Tuple

from benchmark.flops import gaps, union_seconds

NAME_CHARS = 96


class Trace:
    """What the trace of one window holds: ``window_s`` (its length),
    ``busy_s`` (the union of every device operation's interval inside it),
    ``by_name`` (device seconds per kernel name) and the breakdown lists:
    the device operations that took most time, and the idle gaps charged to
    the host call running where each starts."""

    def __init__(self, window_s: float, device: List[Tuple[int, int, str]],
                 host: List[Tuple[int, int, str]], t0_ns: int, t1_ns: int):
        self.device_count = len(device)
        self.window_s = window_s
        spans = [(s, e) for s, e, _ in device]
        self.busy_s = union_seconds(spans) * 1e-9
        by_name: Dict[str, float] = defaultdict(float)
        for s, e, name in device:
            by_name[name] += (e - s) * 1e-9
        self.by_name = dict(by_name)
        self.device_ops = sorted(([n[:NAME_CHARS], v] for n, v in by_name.items()),
                                 key=lambda kv: -kv[1])[:10]
        self.idle_gaps = self._idle_by_host(gaps(spans, t0_ns, t1_ns), host)

    @staticmethod
    def _idle_by_host(idle: List[Tuple[int, int]], host: List[Tuple[int, int, str]]):
        """Each idle gap charged to the innermost host call running where it
        starts (the latest-started one that has not ended)."""
        host = sorted(host)
        starts = [h[0] for h in host]
        charged: Dict[str, float] = defaultdict(float)
        for a, b in idle:
            i = bisect.bisect_right(starts, a) - 1
            name = "_no_host_operation_"
            for j in range(i, max(i - 256, -1), -1):
                if host[j][1] >= a:
                    name = host[j][2]
                    break
            charged[name[:NAME_CHARS]] += (b - a) * 1e-9
        return sorted(([n, v] for n, v in charged.items()), key=lambda kv: -kv[1])[:10]

    def seconds_matching(self, *parts: str) -> float:
        """Device seconds of the kernels whose names hold any of ``parts``."""
        return sum(v for n, v in self.by_name.items() if any(p in n for p in parts))


def traced(fn: Callable[[], None]) -> Trace:
    """Run ``fn`` (which ends by waiting for the device) under the profiler
    and read its trace. Only the device's activity is traced (kernels,
    copies and the runtime calls that launch them): recording every host
    operation as well slows the host so much that the trace would show the
    device idle where the untraced run keeps it busy. ``window_s`` is the
    host clock's time from the start of ``fn`` to the synchronised end."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
    device, host, span = [], [], None
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        on_device = e.device_type() == DeviceType.CUDA
        if on_device and _annotation(e):
            continue        # a span's shadow on the device's timeline, not an operation
        if e.name() == WINDOW:
            span = (start, end)
        elif on_device:
            device.append((start, end, e.name()))
        else:
            host.append((start, end, e.name()))
    if not device:
        raise RuntimeError("the profiler recorded no device operation")
    if span is None:
        # No host span in a device-only trace: the window ends where the
        # synchronised ``fn`` ends, the last device operation.
        last = max(e for _, e, _ in device)
        span = (last - int(window_s * 1e9), last)
    device = [(max(s, span[0]), min(e, span[1]), n) for s, e, n in device
              if e > span[0] and s < span[1]]
    return Trace(window_s, device, host, *span)


@contextlib.contextmanager
def recorded_launches(module, launchers: Dict[str, str]) -> Iterator[List[tuple]]:
    """Within the block, each call of ``module.<launchers[kind]>`` appends
    (kind, its first argument's shape, its bytes per value) to the list
    yielded, and then runs the launcher as it was. A launcher the module
    does not have records nothing."""
    calls: List[tuple] = []
    saved = {kind: getattr(module, name) for kind, name in launchers.items()
             if hasattr(module, name)}

    def recording(kind, launch):
        def call(first, *args, **kwargs):
            calls.append((kind, tuple(first.shape), first.element_size()))
            return launch(first, *args, **kwargs)
        return call

    try:
        for kind, launch in saved.items():
            setattr(module, launchers[kind], recording(kind, launch))
        yield calls
    finally:
        for kind, launch in saved.items():
            setattr(module, launchers[kind], launch)


#: The span that marks the traced window in the profile.
WINDOW = "benchmark.traced_window"


def _annotation(event) -> bool:
    """Whether a device-side event is a host span's annotation (the
    profiler copies ``record_function`` spans onto the device timeline)."""
    check = getattr(event, "is_user_annotation", None)
    return bool(check()) if check is not None else event.name() == WINDOW
