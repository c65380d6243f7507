"""Kernel K2 in bfloat16: the plain PyTorch version, which rounds the
probabilities P and the score gradients dS to bfloat16 before the second
product as the TPU kernels do, against those TPU kernels themselves (forward,
dK/dV and dQ) run on the CPU in Pallas' TPU interpret mode; the float32
results of the plain version unchanged by the rounding code; the route per
kernel, type and head width, and the stride rule of the wrapper that follows
from it.

Tolerances against the TPU kernel: both sides multiply bfloat16 operands with
float32 sums and round P and dS at the same points; they differ by the order
of the sums, by the TPU kernel's normalising P as ``exp(s - m) / l`` where the
plain version takes ``exp(s - lse)``, and by the one rounding of each result
to bfloat16's 8 significant bits: output within one step of that grid (2^-7
of the largest entry), gradients within 2e-2 of their largest entry.
"""

import numpy as np
import pytest
import torch

from rgie_tpu_torch.ops.kernels import flash_attention as FA

torch.set_num_threads(2)


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def _rel(got, expect):
    return float(np.abs(got - expect).max() / np.abs(expect).max())


@pytest.mark.parametrize("shape", [(1, 2, 256, 64), (1, 1, 256, 128), (1, 1, 256, 512)])
def test_plain_bf16_matches_the_tpu_kernels_in_interpret_mode(shape):
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from jax.experimental.pallas.ops.tpu.flash_attention import BlockSizes, flash_attention

    d = shape[3]
    scale = 1.0 / np.sqrt(d)
    q, k, v, do = _inputs(d, shape)
    blocks = BlockSizes(block_q=128, block_k_major=128, block_k=128, block_b=1,
                        block_q_major_dkv=128, block_k_major_dkv=128, block_k_dkv=128,
                        block_q_dkv=128, block_k_major_dq=128, block_k_dq=128, block_q_dq=128)
    qj, kj, vj, doj = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, do))
    with pltpu.force_tpu_interpret_mode():
        o_j, vjp = jax.vjp(lambda q, k, v: flash_attention(q, k, v, sm_scale=scale,
                                                           block_sizes=blocks), qj, kj, vj)
        grads_j = vjp(doj)
    assert o_j.dtype == jnp.bfloat16

    qt, kt, vt, dot = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, do))
    o, lse = FA.reference_flash_attention(qt, kt, vt, scale, block_q=128, block_k=128)
    grads = FA.reference_flash_attention_bwd(qt, kt, vt, o, lse, dot, scale, 128, 128)
    assert o.dtype == torch.bfloat16
    assert _rel(o.float().numpy(), np.asarray(o_j, np.float32)) <= 2.0 ** -7
    for got, expect in zip(grads, grads_j):
        assert got.dtype == torch.bfloat16
        assert _rel(got.float().numpy(), np.asarray(expect, np.float32)) <= 2e-2


def test_plain_bf16_rounds_p_and_ds_before_the_second_product():
    """The rounding points are really there: with them removed the bfloat16
    results move, by less than the stated tolerance but not by nothing."""
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(1, (1, 2, 192, 32)))
    scale = 32 ** -0.5
    o, lse = FA.reference_flash_attention(q, k, v, scale, 64, 64)
    di = FA._row_delta(o, do)
    p = torch.exp(q.float() @ k.float().transpose(-1, -2) * scale - lse[..., None])
    ds = p * (do.float() @ v.float().transpose(-1, -2) - di[..., None]) * scale
    rounded = lambda x: x.to(torch.bfloat16).float()
    expect = dict(
        o=rounded(p) @ v.float(), dv=rounded(p).transpose(-1, -2) @ do.float(),
        dk=rounded(ds).transpose(-1, -2) @ q.float(), dq=rounded(ds) @ k.float())
    unrounded = dict(o=p @ v.float(), dv=p.transpose(-1, -2) @ do.float(),
                     dk=ds.transpose(-1, -2) @ q.float(), dq=ds @ k.float())
    dk, dv = FA.reference_flash_attention_bwd_dkv(q, k, v, do, lse, di, scale, 64, 64)
    dq = FA.reference_flash_attention_bwd_dq(q, k, v, do, lse, di, scale, 64, 64)
    moved = 0
    for name, got in dict(o=o, dv=dv, dk=dk, dq=dq).items():
        # Against the one-shot product with the same rounding: only the order
        # of float32 sums and the final rounding to bfloat16 differ.
        assert _rel(got.float().numpy(), expect[name].numpy()) <= 2.0 ** -7, name
        moved += int((got.float() != unrounded[name].to(torch.bfloat16).float()).sum())
    assert moved > 0


@pytest.mark.parametrize("n,d,block", [(96, 8, 32), (130, 64, 48), (70, 128, 512)])
def test_plain_float32_is_bit_identical_without_the_rounding_code(monkeypatch, n, d, block):
    """For float32 inputs rounding to the inputs' type is the identity: the
    results equal, bit for bit, those with the rounding code taken out."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(n + d, (2, 3, n, d)))
    scale = 1.0 / np.sqrt(d)

    def run():
        o, lse = FA.reference_flash_attention(q, k, v, scale, block, block)
        return (o, lse) + FA.reference_flash_attention_bwd(q, k, v, o, lse, do, scale, block, block)

    assert FA._rounded(q, torch.float32) is q
    with_rounding = run()
    monkeypatch.setattr(FA, "_rounded", lambda x, dtype: x)
    for a, b in zip(with_rounding, run()):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("kernel,dtype,width,expect_route,expect_load", [
    # The forward (and, up to 128, every kernel in bfloat16: one rule).
    ("fwd", torch.float32, 64, "float32", 4), ("fwd", torch.float32, 8, "float32", 4),
    ("fwd", torch.bfloat16, 64, "tensor", 8), ("fwd", torch.bfloat16, 8, "tensor", 8),
    ("fwd", torch.bfloat16, 128, "tensor", 8), ("fwd", torch.bfloat16, 36, "cuda_cores", 4),
    ("fwd", torch.bfloat16, 136, "cuda_cores", 4),
    # Above 128 the forward alone has a tensor-core kernel, at multiples of
    # 64; a tensor any kernel reads that way is loaded 8 elements at a time.
    ("bwd_dkv", torch.bfloat16, 512, "cuda_cores", 8),
    ("fwd", torch.bfloat16, 192, "wide", 8), ("fwd", torch.bfloat16, 256, "wide", 8),
    ("fwd", torch.bfloat16, 512, "wide", 8), ("fwd", torch.bfloat16, 200, "cuda_cores", 4),
    ("fwd", torch.float32, 512, "float32", 4),
    ("bwd_dkv", torch.bfloat16, 64, "tensor", 8), ("bwd_dkv", torch.bfloat16, 136, "cuda_cores", 4),
    ("bwd_dkv", torch.bfloat16, 256, "cuda_cores", 8),
    ("bwd_dq", torch.bfloat16, 8, "tensor", 8), ("bwd_dq", torch.bfloat16, 64, "tensor", 8),
    ("bwd_dq", torch.bfloat16, 128, "tensor", 8), ("bwd_dq", torch.bfloat16, 136, "cuda_cores", 4),
    ("bwd_dq", torch.bfloat16, 512, "cuda_cores", 8), ("bwd_dq", torch.float32, 64, "float32", 4),
    # float32 dQ: the float32 kernels at every width, as dK/dV (the wide one
    # above 128).
    ("bwd_dq", torch.float32, 36, "float32", 4), ("bwd_dq", torch.float32, 128, "float32", 4),
    ("bwd_dq", torch.float32, 132, "float32", 4), ("bwd_dq", torch.float32, 512, "float32", 4)])
def test_route_and_load_width_per_type_and_head_width(kernel, dtype, width, expect_route,
                                                      expect_load):
    assert FA.kernel_route(kernel, dtype, width) == expect_route
    assert FA.load_width(dtype, width) == expect_load
    assert FA.head_width_supported(width)


def test_route_refuses_an_unknown_kernel():
    with pytest.raises(ValueError, match="unknown kernel"):
        FA.kernel_route("bwd", torch.bfloat16, 64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_strided_rule_follows_the_element_size(dtype):
    """A view is read in place exactly when every stride is a multiple of the
    elements one 16-byte load takes (4 float32, 8 bfloat16 on the tensor-core
    route) and the base is 16-byte aligned; otherwise it is copied."""
    b, n, h, d = 2, 10, 3, 8
    base = torch.zeros(b, n, h, d, dtype=dtype)
    heads_first = base.transpose(1, 2)              # strides (240, 8, 24, 1): multiples of 8
    assert FA._strided(heads_first) is heads_first

    # Row stride 12 elements: a multiple of 4, not of 8.
    padded = torch.zeros(b, h, n, 12, dtype=dtype)[..., :8]
    got = FA._strided(padded)
    if dtype == torch.float32:
        assert got is padded
    else:
        assert got is not padded and got.is_contiguous()
        assert torch.equal(got, padded)

    # bfloat16 off the tensor-core route loads 4 elements: width 12, stride 12.
    narrow = torch.zeros(b, h, n, 12, dtype=dtype)
    assert FA._strided(narrow) is narrow

    # The VAE's 512-wide head: the forward reads it 16 bytes at a time in
    # bfloat16, so a row stride of 516 (a multiple of 4, not of 8) is copied.
    wide = torch.zeros(1, 1, n, 516, dtype=dtype)[..., :512]
    got = FA._strided(wide)
    if dtype == torch.float32:
        assert got is wide
    else:
        assert got is not wide and got.stride() == (n * 512, n * 512, 512, 1)
    aligned = torch.zeros(1, 1, n, 520, dtype=dtype)[..., :512]
    assert FA._strided(aligned) is aligned

    # A base that is not 16-byte aligned is copied in both types.
    step = 16 // base.element_size() // 2
    shifted = torch.zeros(b * h * n * d + step, dtype=dtype)[step:].view(b, h, n, d)
    assert shifted.data_ptr() % 16 != 0
    assert FA._strided(shifted) is not shifted
    # A width axis that is not contiguous is copied.
    assert FA._strided(base.transpose(2, 3).transpose(1, 2)).stride(-1) == 1


@pytest.mark.parametrize("kernel,launcher", [("bwd_dkv", "launch_dkv_f32"),
                                             ("bwd_dq", "launch_dq_f32")])
def test_float32_dispatch_in_the_source_follows_kernel_route(kernel, launcher):
    """The ``extern "C"`` entry point of a backward kernel sends float32 to
    its float32 kernel at the chunk counts 1 and 2 of ``chunks_for_width``
    (thresholds read from the shared header) and to its wide float32 kernel
    above (chunk count 8): every float32 width is ``"float32"`` in
    ``kernel_route``."""
    import re

    from rgie_tpu_torch.ops.kernels import build

    text = (build.CSRC_DIR / f"flash_attention_{kernel}.cu").read_text()
    entry = text[text.index(f'extern "C" int rgie_flash_attention_{kernel}('):]
    float32_part = entry[entry.index("if (is_bf16) {"):]
    float32_part = float32_part[float32_part.index("\n  }\n"):]     # past the bfloat16 block
    float32_chunks = {int(c) for c in re.findall(
        r"if \(chunks == (\d)\) \{\s*return " + launcher + r"<\1[,>]", float32_part)}
    assert float32_chunks == {1, 2}
    assert launcher + "_wide<" in float32_part
    common = (build.CSRC_DIR / "flash_attention_common.cuh").read_text()
    body = common[common.index("inline int chunks_for_width(int width) {"):]
    body = body[:body.index("\n}\n")]
    limits = [(int(w), int(c)) for w, c in re.findall(r"if \(width <= (\d+)\) return (\d+);", body)]
    assert limits == [(64, 1), (128, 2), (512, 8)]
    for width in range(4, 513, 4):
        chunks = next(c for w, c in limits if width <= w)
        assert chunks in float32_chunks or chunks == 8
        assert FA.kernel_route(kernel, torch.float32, width) == "float32", width


def test_kernel_sources_name_both_routes():
    from rgie_tpu_torch.ops.kernels import build

    common = (build.CSRC_DIR / "flash_attention_common.cuh").read_text()
    assert "wgmma.mma_async.sync.aligned" in common and "cp.async.cg.shared.global" in common
    for name in FA.KERNEL_SOURCES:
        text = (build.CSRC_DIR / f"{name}.cu").read_text()
        assert "atoms_for_width(width)" in text and "chunks_for_width(width)" in text
        assert "atomicAdd" not in text
    # The forward alone has a second tensor-core kernel, for the wide heads.
    fwd = (build.CSRC_DIR / "flash_attention_fwd.cu").read_text()
    assert "wide_atoms_for_width(width)" in fwd and "wide_atoms_for_width" in common
