"""The yardstick's arithmetic on synthetic inputs: FLOP counts, the least
time of a flash-attention launch, interval unions and idle gaps, the trace
reduction, the metric readers and the gaps the check compares."""

from __future__ import annotations

import math

import pytest
import torch

from benchmark import common, flops, run
from benchmark.reference.precision import FP8, TF32, lower, round_fp8, round_tf32
from benchmark.trace import Trace
from benchmark.tests import tiny


def test_union_and_gaps():
    spans = [(0, 2), (1, 3), (5, 6), (5.5, 7), (10, 11)]
    assert flops.union_seconds(spans) == pytest.approx(3 + 2 + 1)
    assert flops.union_seconds([]) == 0.0
    assert flops.gaps(spans, -1, 12) == [(-1, 0), (3, 5), (7, 10), (11, 12)]
    assert flops.gaps([(0, 5)], 1, 4) == []


@pytest.mark.parametrize("kind,shape,width,bound", [
    # Operations over 989 TFLOP/s, the bounds of the kernel table in PERF.md:
    # 4 n^2 d per head forward, 8 for dK/dV, 6 for dQ.
    ("fwd", (2, 1, 16384, 512), 2, 1.1117e-3),
    ("bwd_dkv", (1, 1, 16384, 512), 2, 1.1117e-3),
    ("bwd_dq", (1, 1, 16384, 512), 2, 0.8338e-3),
    # float32 on the CUDA cores, over 67 TFLOP/s: 10.257 ms forward at
    # (2, 5, 16384, 64).
    ("fwd", (2, 5, 16384, 64), 4, 10.257e-3),
])
def test_flash_least_seconds_matches_published_bounds(kind, shape, width, bound):
    assert flops.flash_least_seconds(kind, *shape, bytes_per_value=width) == pytest.approx(
        bound, rel=1e-3)


def test_short_flash_launches_are_bounded_by_their_bytes():
    assert flops.flash_least_seconds("fwd", 1, 1, 8, 512) == pytest.approx(
        (4 * 8 * 512 * 2 + 4 * 8) / common.PEAK_HBM_BYTES)
    assert flops.flash_least_seconds("bwd_dq", 1, 1, 8, 512) == pytest.approx(
        (5 * 8 * 512 * 2 + 8 * 8) / common.PEAK_HBM_BYTES)


def test_k2_least_time_sums_the_recorded_launches():
    from benchmark.kinds.edit import k2_least_seconds

    calls = [("fwd", (2, 1, 16384, 512), 2)] * 4 + [("bwd_dkv", (2, 5, 1024, 64), 2),
                                                     ("bwd_dq", (2, 5, 1024, 64), 2)]
    launches = {"fwd": 4, "bwd_dkv": 1, "bwd_dq": 1}
    assert k2_least_seconds(calls, launches) == pytest.approx(
        4 * flops.flash_least_seconds("fwd", 2, 1, 16384, 512)
        + flops.flash_least_seconds("bwd_dkv", 2, 5, 1024, 64)
        + flops.flash_least_seconds("bwd_dq", 2, 5, 1024, 64))
    # A launch the record missed, or none at all: nothing to read.
    assert k2_least_seconds(calls, dict(launches, fwd=5)) is None
    assert k2_least_seconds([], {"fwd": 0, "bwd_dkv": 0, "bwd_dq": 0}) is None


def test_recorded_launches_wrap_and_restore():
    import types

    from benchmark.trace import recorded_launches

    module = types.SimpleNamespace(_go=lambda q, scale: scale * q.sum())
    real = module._go
    with recorded_launches(module, {"fwd": "_go", "bwd_dq": "_missing"}) as calls:
        assert float(module._go(torch.ones(2, 3, dtype=torch.bfloat16), 2.0)) == 12.0
        module._go(torch.ones(1, 1, 4, 8), 1.0)
    assert module._go is real and not hasattr(module, "_missing")
    assert calls == [("fwd", (2, 3), 2), ("fwd", (1, 1, 4, 8), 4)]


def test_edit_flops_composition():
    k = {"unet": 1.0, "unet_grad_embeds": 3.0, "unet_grad_latents": 2.0, "vae_encode": 0.5,
         "vae_decode": 0.7, "midu": 0.01}
    base = 2 * (0.5 + 1.0 + 0.01) + 0.5 + 0.7
    assert flops.edit_flops(k, 1, 4, 4, [], False) == pytest.approx(base + 4 + 4 * (2 + 2))
    with_nto = flops.edit_flops(k, 2, 4, 4, [10, 10, 3, 10], True)
    assert with_nto == pytest.approx(2 * (base + 4 + 4 * 4 + 4 * 3 + 33 * 3))
    assert flops.unet_forward_equivalents(5, 5, [10] * 5, True) == 2 + 5 + 25 + 15 + 150


def test_edit_kinds_on_the_plain_networks():
    kinds = flops.edit_kinds(tiny.config(False))
    assert kinds["unet_grad_embeds"] > kinds["unet"] > 0
    assert kinds["unet_grad_latents"] > kinds["unet"]
    assert kinds["vae_decode"] > 0 and kinds["vae_encode"] > 0 and kinds["midu"] > 0
    assert flops.train_step_flops(tiny.config(False), 2) > 2 * kinds["unet"]


def test_trace_reduction():
    dev = [(0, 2_000, "k1"), (1_000, 3_000, "flash_fwd_wide_kernel"), (6_000, 7_000, "k1")]
    host = [(0, 10_000, "aten::step"), (2_500, 5_500, "aten::sync"), (9_000, 9_500, "late")]
    tr = Trace(10e-6, dev, host, 0, 10_000)
    assert tr.busy_s == pytest.approx(4e-6)
    assert tr.by_name["k1"] == pytest.approx(3e-6)
    assert tr.seconds_matching("flash_fwd") == pytest.approx(2e-6)
    gaps = dict(tr.idle_gaps)
    assert gaps["aten::sync"] == pytest.approx(3e-6)       # (3000, 6000) starts inside it
    assert gaps["aten::step"] == pytest.approx(3e-6)       # (7000, 10000)
    assert sum(gaps.values()) == pytest.approx(tr.window_s - tr.busy_s)


def test_metric_readers():
    tr = Trace(2.0, [(0, 1_500_000_000, "flash_fwd_x"), (1_500_000_000, 1_600_000_000, "y")],
               [], 0, 2_000_000_000)
    ctx = {"kind": "edit", "wall_s": 10.0, "flops": 989e12, "nto_s": 4.0, "nto_inner": 40,
           "sample_s": 1.0, "sample_steps": 5, "trace": tr, "fwd_equivalents": 160,
           "k2_least_s": 0.3}
    read = common.metric_reader
    assert read("edit_mfu")(ctx) == pytest.approx(10.0)
    assert read("nto_inner_ms")(ctx) == pytest.approx(100.0)
    assert read("guided_step_ms")(ctx) == pytest.approx(200.0)
    assert read("device_ms_per_fwd")(ctx) == pytest.approx(10.0)
    assert read("k2_roofline")(ctx) == pytest.approx(20.0)
    assert read("idle_pct.edit")(ctx) == pytest.approx(20.0)
    assert read("idle_pct.train")(ctx) is None and read("train_mfu")(ctx) is None
    assert read("k2_roofline")(dict(ctx, k2_least_s=None)) is None
    train = {"kind": "train", "wall_s": 4.0, "flops": 2 * 989e12, "features_s": [0.1, 0.3],
             "trace": tr}
    assert read("train_mfu")(train) == pytest.approx(50.0)
    assert read("features_ms")(train) == pytest.approx(200.0)
    assert read("idle_pct.train")(train) == pytest.approx(20.0)
    assert read("edit_mfu")(train) is None and read("nto_inner_ms")(train) is None
    # The twins SDXL's cells report under their own end-to-end metric read
    # the same.
    for name, base in (("edit_mfu.xl", "edit_mfu"), ("nto_inner_ms.xl", "nto_inner_ms"),
                       ("guided_step_ms.xl", "guided_step_ms"),
                       ("device_ms_per_fwd.xl", "device_ms_per_fwd"),
                       ("idle_pct.xl", "idle_pct.edit")):
        assert read(name)(ctx) == read(base)(ctx)
        assert read(name)(train) is None


def test_gaps_compared():
    a = torch.tensor([[3.0, 4.0], [1.0, 0.0]])
    b = torch.tensor([[3.0, 4.0], [2.0, 0.0]])
    assert common.relative_gap(a[0], b[0]) == 0.0
    assert common.rows_gap(a, b) == pytest.approx(0.5)
    ref = {"w": torch.ones(4), "b": torch.zeros(4) + 1e-9, "v": torch.full((4,), 3.0)}
    got = {"w": torch.ones(4) * 1.1, "b": torch.zeros(4), "v": torch.full((4,), 3.0)}
    # The near-zero leaf is measured against the median leaf's norm (2).
    assert common.leaf_norm_gap(got, ref) == pytest.approx(0.1)
    assert common.leaf_norm_gap(got, ref, ["v"]) == 0.0


def test_lowered_precisions():
    x = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    t = round_tf32(x)
    assert torch.all((t.view(torch.int32) & 0x1FFF) == 0)
    assert float((t - x).abs().max() / x.abs().max()) < 2 ** -10
    f = round_fp8(x)
    rel = ((f - x).abs() / x.abs().clamp(min=1e-3)).median()
    assert 2 ** -6 < float(rel) < 2 ** -3
    w = x.clone().requires_grad_(True)
    (lower(w, FP8) * 2).sum().backward()
    assert torch.equal(w.grad, torch.full_like(x, 2.0))
    assert torch.equal(lower(x, TF32), t)
    with pytest.raises(ValueError):
        lower(x, "int4")


def test_seeded_weights_repeat_and_scale():
    from benchmark.reference import nets

    cfg = tiny.config(False)
    a, b = (nets.frozen(nets.UNet(cfg["unet"])) for _ in range(2))
    common.fill_weights_(a, 2 ** 40 + 7, "unet")
    common.fill_weights_(b, 2 ** 40 + 7, "unet")
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
        if p.ndim >= 2 and p.numel() > 500:
            assert float(p.std()) == pytest.approx(1 / math.sqrt(math.prod(p.shape[1:])),
                                                   rel=0.15)
        elif p.ndim < 2:
            assert torch.all(p == (0.0 if n.endswith("bias") else 1.0))
    common.fill_weights_(b, 2 ** 40 + 8, "unet")
    assert not torch.equal(a.conv_in.weight, b.conv_in.weight)
