"""The join of ``benchmark/spans.py`` on synthetic events: device time by the
innermost program range open on the launching thread (the main thread's
where that thread has none), idle time by the range open where each gap
starts, the idle share of a range and attention's least time; then, on the
card, a ``torch.cuda._sleep`` kernel launched inside a range is charged to it
and lies inside it on the trace's clock. Run the card test there with

    python3 -m pytest benchmark/tests/test_benchmark_spans.py -m cuda -p no:cacheprovider
"""

from __future__ import annotations

import pytest
import torch

from benchmark import flops, spans

MAIN, AUTOGRAD, OTHER = 1, 7, 9


def synthetic() -> spans.RangeTrace:
    """Main-thread ranges edit.nto [0, 100] > nto.inner [10, 60] >
    nto.loss_grad [10, 40]; thread OTHER's own range [70, 80]. Launches: on
    the main thread at 15 (loss_grad) and 45 (inner) and 90 (nto); from
    AUTOGRAD, which opens no range, at 20 (main's loss_grad, so its backward
    kernel lands there); from OTHER at 75 (its own range). Device operations
    [20, 30], [50, 55], [92, 97], [31, 35], [76, 78]."""
    ranges = [(0, 100, "edit.nto", MAIN), (10, 60, "nto.inner", MAIN),
              (10, 40, "nto.loss_grad", MAIN), (70, 80, "other.range", OTHER)]
    launches = [(15, 16, "cudaLaunchKernel", MAIN, 1), (45, 46, "cudaLaunchKernel", MAIN, 2),
                (90, 91, "cudaLaunchKernel", MAIN, 3), (20, 21, "cudaLaunchKernel", AUTOGRAD, 4),
                (75, 76, "cudaLaunchKernel", OTHER, 5)]
    device = [(20, 30, "fwd", 1), (50, 55, "adam", 2), (92, 97, "cfg", 3), (31, 35, "bwd", 4),
              (76, 78, "side", 5)]
    return spans.RangeTrace(1e-7, device, ranges, launches, 0, 100, MAIN)


def test_device_time_by_launching_thread_and_range():
    rt = synthetic()
    assert rt.device_s_by_span == pytest.approx(
        {"nto.loss_grad": 14e-9, "nto.inner": 5e-9, "edit.nto": 5e-9, "other.range": 2e-9})
    inclusive = dict(zip((r[2] for r in rt.ranges), rt.inclusive_s))
    assert inclusive == pytest.approx({"edit.nto": 24e-9, "nto.inner": 19e-9,
                                       "nto.loss_grad": 14e-9, "other.range": 2e-9})
    assert rt.device_ms_per("nto.inner") == pytest.approx(19e-6)
    assert rt.device_ms_per("train.features") is None


def test_idle_time_by_the_range_open_where_each_gap_starts():
    rt = synthetic()
    # gaps [0, 20] (edit.nto), [30, 31] and [35, 50] (loss_grad), [55, 76]
    # (inner), [78, 92] (edit.nto: OTHER's range is not the main thread's),
    # [97, 100] (edit.nto).
    assert rt.idle_s_by_span == pytest.approx(
        {"edit.nto": 37e-9, "nto.loss_grad": 16e-9, "nto.inner": 21e-9})
    assert rt.busy_s == pytest.approx(26e-9)
    assert rt.idle_pct("edit.nto") == pytest.approx(74.0)
    assert rt.idle_pct("nto.loss_grad") == pytest.approx(100.0 * 16 / 30)
    assert rt.idle_pct("edit.sample") is None
    assert rt.readings() == pytest.approx({"nto_idle_pct": 74.0})
    assert rt.trace.busy_s == pytest.approx(rt.busy_s)


def test_attention_least_time_and_roofline():
    least = spans.attention_least_seconds("bf16", 2, 1, 16384, 16384, 512)
    assert least == pytest.approx(flops.flash_least_seconds("fwd", 2, 1, 16384, 512))
    assert least == pytest.approx(1.112e-3, rel=1e-3)
    # the 77-key cross-attention: 4 B H N M d operations, Q, K, V and O once
    cross = spans.attention_least_seconds("bf16", 16, 5, 4096, 77, 64)
    assert cross == pytest.approx(max(4.0 * 16 * 5 * 4096 * 77 * 64 / 989e12,
                                      16 * 5 * 2 * (4096 + 77) * 64 * 2 / 3.35e12))
    name = "attn.k2.bf16.2x1x16384x16384x512"
    rt = spans.RangeTrace(1.0, [(0, 4_448_000, "flash_fwd", 1)], [(0, 5_000_000, name, MAIN)],
                          [(0, 1, "cudaLaunchKernel", MAIN, 1)], 0, 5_000_000, MAIN)
    assert rt.attention_roofline() == pytest.approx(100.0 * least / 4.448e-3)
    # a range whose operations the trace lost counts on neither side
    lost = spans.RangeTrace(1.0, [(0, 4_448_000, "flash_fwd", 1)],
                            [(0, 5_000_000, name, MAIN), (6_000_000, 7_000_000, name, MAIN)],
                            [(0, 1, "cudaLaunchKernel", MAIN, 1)], 0, 8_000_000, MAIN)
    assert lost.attention_roofline() == pytest.approx(rt.attention_roofline())
    assert lost.attention_unrecorded() == 1
    silent = spans.RangeTrace(1.0, [(0, 10, "k", 1)], [(20, 30, name, MAIN)],
                              [(0, 1, "cudaLaunchKernel", MAIN, 1)], 0, 40, MAIN)
    assert silent.attention_roofline() is None and "attn_fwd_roofline" not in silent.readings()


@pytest.mark.cuda
def test_sleep_kernel_is_charged_to_its_range_on_the_trace_clock():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the join reads the card's own trace")

    def fn():
        torch.cuda._sleep(1_000_000)
        with torch.profiler.record_function("probe.sleep"):
            torch.cuda._sleep(20_000_000)
            torch.cuda.synchronize()
        torch.cuda._sleep(1_000_000)

    rt = spans.traced_ranges(fn)
    (probe,) = rt.named("probe.sleep")
    start, end = rt.ranges[probe][:2]
    assert rt.device_s_by_span["probe.sleep"] == pytest.approx(rt.inclusive_s[probe])
    inside = [(s, e) for s, e, _, c in rt.device if start <= s and e <= end]
    assert len(inside) == 1 and (inside[0][1] - inside[0][0]) * 1e-9 == pytest.approx(
        rt.inclusive_s[probe])
    assert rt.inclusive_s[probe] > 1e-3
