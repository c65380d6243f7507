"""Kernel K2 (flash attention): its plain tiled PyTorch version against the JAX
library's ``mha_reference`` and against the JAX package's einsum attention
(``unet.py:212-214``, ``vae.py:93-95``) on the CPU: output, log-sum-exp and
dQ/dK/dV; the differentiable wrapper on CPU tensors; the modules' gate; what
the wrapper refuses. The CUDA kernels against the plain version on the card
are marked ``cuda`` and skip without a card.

JAX is imported inside the parity tests only, so that the card's tests run
where JAX is not installed:
``python -m pytest tests/test_torch_flash_attention.py -m cuda --noconftest``.

Tolerances: float32 on both sides with sums in different orders: 2e-5 on
outputs (order 1), 1e-4 relative to the largest entry on gradients.
"""

import numpy as np
import pytest
import torch

from rgie_tpu_torch.ops.kernels import flash_attention as FA

torch.set_num_threads(2)


def _qkv(seed, shape, count=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(count)]


def _rel(got, expect):
    expect = np.asarray(expect)
    return np.abs(np.asarray(got) - expect).max() / np.abs(expect).max()


@pytest.mark.parametrize("d", [8, 64, 192, 512])
@pytest.mark.parametrize("n,block_q,block_k", [(96, 32, 32), (100, 32, 48), (70, 512, 512),
                                               (130, 64, 16)])
def test_plain_matches_jax_references(d, n, block_q, block_k):
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas.ops.tpu.flash_attention import (mha_reference,
                                                                 mha_reference_no_custom_vjp)

    q, k, v, do = _qkv(n + d, (2, 3, n, d))
    scale = 1.0 / np.sqrt(d)
    qj, kj, vj = map(jnp.asarray, (q, k, v))

    def einsum_attention(q, k, v):     # rgie_tpu/diffusion/unet.py:212-214, heads first
        attn = jnp.einsum("bhnd,bhmd->bhnm", q, k) / np.sqrt(d)
        return jnp.einsum("bhnm,bhmd->bhnd", jax.nn.softmax(attn, axis=-1), v)

    # The library's reference: its jitted entry point (which fixes bfloat16
    # matmul precision for itself and differentiates only at sm_scale 1) is
    # held loosely on the output; its plain function gives the residuals and,
    # through autodiff, the gradients.
    o_lib = mha_reference(qj, kj, vj, None, sm_scale=scale)
    _, l_j, m_j = mha_reference_no_custom_vjp(qj, kj, vj, sm_scale=scale, save_residuals=True)
    o_plain, vjp_lib = jax.vjp(lambda q, k, v: mha_reference_no_custom_vjp(
        q, k, v, sm_scale=scale), qj, kj, vj)
    o_ein, vjp_ein = jax.vjp(einsum_attention, qj, kj, vj)

    qt, kt, vt, dot = map(torch.from_numpy, (q, k, v, do))
    o, lse = FA.reference_flash_attention(qt, kt, vt, scale, block_q, block_k)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ein), atol=2e-5, rtol=0)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_plain), atol=2e-5, rtol=0)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_lib), atol=3e-2, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(m_j + jnp.log(l_j)), atol=2e-5, rtol=0)
    grads = FA.reference_flash_attention_bwd(qt, kt, vt, o, lse, dot, scale, block_q, block_k)
    for got, a, b in zip(grads, vjp_ein(jnp.asarray(do)), vjp_lib(jnp.asarray(do))):
        assert _rel(got.numpy(), a) <= 1e-4
        assert _rel(got.numpy(), b) <= 1e-4


def test_plain_matches_vae_einsum_path():
    import jax
    import jax.numpy as jnp

    q, k, v, do = _qkv(3, (2, 75, 16))
    c = 16

    def vae_attention(q, k, v):        # rgie_tpu/diffusion/vae.py:93-95
        attn = jax.nn.softmax(jnp.einsum("bnc,bmc->bnm", q, k) / jnp.sqrt(c), axis=-1)
        return jnp.einsum("bnm,bmc->bnc", attn, v)

    o_j, vjp = jax.vjp(vae_attention, *map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a)[:, None].requires_grad_() for a in (q, k, v)]
    o = FA.flash_attention(*ts, sm_scale=1.0 / np.sqrt(c))
    grads = torch.autograd.grad(o, ts, torch.from_numpy(do)[:, None])
    np.testing.assert_allclose(o[:, 0].detach().numpy(), np.asarray(o_j), atol=2e-5, rtol=0)
    for got, expect in zip(grads, vjp(jnp.asarray(do))):
        assert _rel(got[:, 0].numpy(), expect) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_on_cpu_tensors_matches_autograd(dtype):
    """The differentiable wrapper on CPU tensors (the plain version with its
    hand-written backward) against autograd through matmul-softmax-matmul,
    with the (B, N, H, d) projections seen as (B, H, N, d)."""
    q, k, v, do = (torch.from_numpy(a).to(dtype).transpose(1, 2)
                   for a in _qkv(5, (2, 600, 3, 16)))
    scale = 0.25
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = FA.flash_attention(*leaves, sm_scale=scale)
    grads = torch.autograd.grad(out, leaves, do)
    plain = FA.plain_flash_attention(*leaves, scale)
    np.testing.assert_array_equal(plain.detach().float().numpy(), out.detach().float().numpy())

    ref_leaves = [t.detach().float().clone().requires_grad_() for t in (q, k, v)]
    attn = torch.softmax(ref_leaves[0] @ ref_leaves[1].transpose(-1, -2) * scale, dim=-1)
    ref = attn @ ref_leaves[2]
    ref_grads = torch.autograd.grad(ref, ref_leaves, do.float())
    tol_out, tol_grad = (2e-5, 1e-4) if dtype == torch.float32 else (2.0 ** -7, 2e-2)
    assert out.dtype == dtype and out.shape == q.shape
    assert _rel(out.detach().float().numpy(), ref.detach().numpy()) <= tol_out
    for got, expect in zip(grads, ref_grads):
        assert got.dtype == dtype
        assert _rel(got.float().numpy(), expect.numpy()) <= tol_grad
    o2, lse = FA.flash_attention_with_lse(q, k, v, scale)
    expect_lse = torch.logsumexp(q.float() @ k.float().transpose(-1, -2) * scale, dim=-1)
    np.testing.assert_allclose(lse.numpy(), expect_lse.numpy(), atol=2e-5)


#: (n, m, head width) -> whether the gate sends the call to the kernels.
GATE_CASES = {
    "unet-512px-level0": ((4096, 4096, 64), True),      # closed before the H100's crossover
    "unet-512px-level1": ((1024, 1024, 64), True),
    "unet-512px-level2": ((256, 256, 64), True),        # the smallest admitted N
    "unet-1024px-level0": ((16384, 16384, 64), True),
    "old-threshold": ((8192, 8192, 64), True),
    "ragged-last-tile": ((16000, 16000, 64), True),
    "narrowest-head": ((300, 300, 4), False),           # off the tensor cores: 8192
    "narrowest-head-wide-threshold": ((8192, 8192, 4), True),
    "tensor-core-width-32": ((256, 256, 32), True),
    "cuda-core-width": ((4096, 4096, 36), False),       # bf16 on the CUDA-core kernels: 8192
    "cuda-core-width-threshold": ((8192, 8192, 36), True),
    "widest-narrow-head": ((300, 300, 64), True),
    "float32-wide-forward-width": ((4096, 4096, 128), False),   # float32 loses there: 8192
    "float32-wide-forward-width-threshold": ((8192, 8192, 128), True),
    "vae-1024px": ((16384, 16384, 512), True),          # the VAE's single head
    "wide-head-threshold": ((8192, 8192, 132), True),
    "cross-attention": ((16384, 77, 64), False),
    "cross-attention-512px": ((4096, 77, 64), False),
    "unet-512px-mid-block": ((64, 64, 64), False),      # loses forward + backward at batch 16
    "below-threshold": ((255, 255, 64), False),
    "vae-512px": ((4096, 4096, 512), False),            # the wide kernels lose there
    "wide-below-threshold": ((8191, 8191, 132), False),
    "not-a-multiple-of-4": ((16384, 16384, 65), False),
    "not-a-multiple-of-4-short": ((4096, 4096, 66), False),
    "wider-than-512": ((16384, 16384, 1024), False),
    "wider-than-512-by-4": ((16384, 16384, 516), False),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_gate_matches_the_jax_gate_on_shapes(case):
    """The gate on every shape it admits and refuses: self-attention with a
    head width the kernels take, from 256 positions at the widths where
    bfloat16 runs on the tensor cores and float32 on the narrow forward
    (multiples of 8 up to 64) and from 8192 at the others (the H100's
    crossovers, ``cli/check_flash_attn.py``).
    Unlike the TPU gate (8192 at every width) it does not ask for N % 512 ==
    0 (the kernels mask the ragged tile) and takes every multiple of 4 up to
    512."""
    (n, m, d), admitted = GATE_CASES[case]
    assert FA.flash_self_attention_ok(n, m, d) is admitted


def test_modules_take_the_flash_route_above_the_gate(monkeypatch):
    """CrossAttention and VaeAttention call the wrapper exactly when the gate
    holds, and both routes give the same result."""
    from rgie_tpu_torch.diffusion import unet as U
    from rgie_tpu_torch.diffusion import vae as V

    calls = []
    real = FA.flash_attention

    def counting(q, k, v, **kw):
        calls.append(tuple(q.shape))
        return real(q, k, v, **kw)

    g = torch.Generator().manual_seed(0)
    attn = U.CrossAttention(16, 16, heads=2, dim_head=8)
    vattn = V.VaeAttention(8, groups=2)
    x = torch.randn(1, 96, 16, generator=g)
    ctx = torch.randn(1, 7, 16, generator=g)
    xv = torch.randn(1, 8, 12, 8, generator=g)
    with torch.no_grad():
        expect, expect_v, expect_x = attn(x), vattn(xv), attn(x, ctx)
        monkeypatch.setattr(U, "flash_attention", counting)
        monkeypatch.setattr(V, "flash_attention", counting)
        assert attn(x) is not None and not calls           # 96 positions: matmul route
        monkeypatch.setattr(FA, "MIN_FLASH_SEQ_LEN", 96)     # the gate itself, lowered
        got, got_v, got_x = attn(x), vattn(xv), attn(x, ctx)
    assert calls == [(1, 2, 96, 8), (1, 1, 96, 8)]          # the cross-attention call is not one
    np.testing.assert_allclose(got.numpy(), expect.numpy(), atol=2e-6)
    np.testing.assert_allclose(got_v.numpy(), expect_v.numpy(), atol=2e-6)
    np.testing.assert_array_equal(got_x.numpy(), expect_x.numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [FA.MIN_FLASH_SEQ_LEN, 4096])
def test_modules_at_the_admitted_lengths_match_the_matmul_route(monkeypatch, n, dtype):
    """CrossAttention and VaeAttention (narrow heads) at the smallest length
    the gate admits and at 4096 positions, through the gate as it is: each
    calls the wrapper once, and its output and its gradients to the input
    and to the weights match the matmul route (``RGIE_FLASH_ATTN=0``) within
    7.5e-6 of the largest entry in float32 and 1.5e-2 in bfloat16. The key
    projection's bias is left out: it shifts each row's scores by one
    constant, so its gradient is zero and both routes give rounding noise."""
    from rgie_tpu_torch.diffusion import unet as U
    from rgie_tpu_torch.diffusion import vae as V

    calls = []
    real = FA.flash_attention

    def counting(q, k, v, **kw):
        calls.append(tuple(q.shape))
        return real(q, k, v, **kw)

    monkeypatch.setattr(U, "flash_attention", counting)
    monkeypatch.setattr(V, "flash_attention", counting)
    g = torch.Generator().manual_seed(n)
    attn = U.CrossAttention(16, 16, heads=2, dim_head=8).to(dtype)
    vattn = V.VaeAttention(8, groups=2).to(dtype)
    cases = [(attn, torch.randn(1, n, 16, generator=g)),
             (vattn, torch.randn(1, 8, 1, n, generator=g))]
    assert FA.flash_self_attention_ok(n, n, 8)
    tol = 7.5e-6 if dtype == torch.float32 else 1.5e-2
    for module, x in cases:
        x = x.to(dtype)
        cotangent = torch.randn(x.shape, generator=g).to(dtype)
        routes = []
        for switch in ("auto", "0"):
            monkeypatch.setattr(FA, "FLASH_ATTN", switch)
            leaves = [x.detach().clone().requires_grad_()] + [
                p for name, p in module.named_parameters() if name != "to_k.bias"]
            out = module(leaves[0])
            routes.append([out.detach()] + list(torch.autograd.grad(out, leaves, cotangent)))
        for got, expect in zip(*routes):
            assert got.dtype == expect.dtype
            assert _rel(got.float().numpy(), expect.float().numpy()) <= tol
    assert calls == [(1, 2, n, 8), (1, 1, n, 8)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_route_table_over_widths(dtype):
    """The route of every kernel at every head width 4..512 in steps of 4,
    written out here as a table of ranges: what each C entry point runs."""
    for width in range(4, 513, 4):
        if dtype == torch.float32:
            expect = dict.fromkeys(FA.KERNELS, "float32")
        elif width <= 128 and width % 8 == 0:
            expect = dict.fromkeys(FA.KERNELS, "tensor")
        elif width > 128 and width % 64 == 0:
            expect = dict.fromkeys(FA.KERNELS, "wide")
        else:
            expect = dict.fromkeys(FA.KERNELS, "cuda_cores")
        got = {kn: FA.kernel_route(kn, dtype, width) for kn in FA.KERNELS}
        assert got == expect, width
    for width in (0, 6, 516, 1024):
        with pytest.raises(ValueError, match="multiples of 4"):
            FA.kernel_route("fwd", dtype, width)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        FA.kernel_route("fwd", torch.float16, 64)


def test_wrapper_refuses_masks_and_mismatched_inputs():
    q = torch.zeros(1, 2, 16, 8)
    for kw in (dict(ab=torch.zeros(1, 2, 16, 16)), dict(segment_ids=object()),
               dict(causal=True)):
        with pytest.raises(NotImplementedError, match="no bias, segment ids or causal mask"):
            FA.flash_attention(q, q, q, **kw)
    with pytest.raises(ValueError, match="one shape"):
        FA.flash_attention(q, q[:, :, :8], q)
    with pytest.raises(ValueError, match="one type"):
        FA.flash_attention(q, q.double(), q)
    assert FA.LAUNCHES_FWD == 0 and FA.LAUNCHES_BWD_DKV == 0 and FA.LAUNCHES_BWD_DQ == 0


def test_kernel_sources_are_in_the_package():
    from rgie_tpu_torch.ops.kernels import build

    for name in FA.KERNEL_SOURCES:
        text = (build.CSRC_DIR / f"{name}.cu").read_text()
        assert 'extern "C" int rgie_' + name in text
        assert "cudaGetLastError" in text and "torch/" not in text
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


@pytest.mark.parametrize("kernel,launcher", [("bwd_dkv", "launch_dkv_f32_wide"),
                                             ("bwd_dq", "launch_dq_f32_wide")])
def test_backward_entry_points_send_wide_float32_to_the_wide_kernels(kernel, launcher):
    """Past the bfloat16 block and the chunk counts 1 and 2 (widths up to
    128), the float32 branch of each backward entry point launches its wide
    float32 kernel at 2 and 4 groups of 128 columns, and nothing else: no
    first CUDA-core kernel for float32. ``wide_groups_for_width`` gives 2 up
    to 256 and 4 above, for every multiple of 4 from 132 to 512."""
    import re

    from rgie_tpu_torch.ops.kernels import build

    text = (build.CSRC_DIR / f"flash_attention_{kernel}.cu").read_text()
    entry = text[text.index(f'extern "C" int rgie_flash_attention_{kernel}('):]
    float32_part = entry[entry.index("if (is_bf16) {"):]
    float32_part = float32_part[float32_part.index("\n  }\n"):]     # past the bfloat16 block
    wide_part = float32_part[float32_part.index("if (wide_groups_for_width(width) == 2) {"):]
    assert re.findall(launcher + r"<(\d)>", wide_part) == ["2", "4"]
    assert "(float, " not in float32_part and "launch_dkv<" not in float32_part
    assert "launch_dq<" not in float32_part
    common = (build.CSRC_DIR / "flash_attention_common.cuh").read_text()
    body = common[common.index("inline int wide_groups_for_width(int width) {"):]
    body = body[:body.index("\n}\n")]
    assert "width <= 128 || width % 4 != 0 || width > 512" in body
    assert "return width <= 256 ? 2 : 4;" in body
    for width in range(132, 513, 4):
        assert FA.kernel_route(kernel, torch.float32, width) == "float32", width


def test_kernel_variants_still_apply_to_the_sources():
    """``cli/kernel_variants.py`` edits copies of the kernel sources by exact
    text: every edit finds its lines exactly once in the source it names."""
    from rgie_tpu_torch.cli import kernel_variants as KV
    from rgie_tpu_torch.ops.kernels import build
    from rgie_tpu_torch.ops.kernels import pointwise_chain as PC

    assert KV.VARIANTS
    for name, (source, edits) in KV.VARIANTS.items():
        assert source in FA.KERNEL_SOURCES + (PC.KERNEL_SOURCE,)
        texts = {}
        for edit in edits:      # (old, new) on the source, or (file, old, new)
            target, old, new = edit if len(edit) == 3 else (f"{source}.cu", *edit)
            text = texts.get(target) or (build.CSRC_DIR / target).read_text()
            assert text.count(old) == 1 and new != old, name
            texts[target] = text.replace(old, new)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are CUDA C++ built with nvcc)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 2, 8192, 64), (2, 3, 1000, 32), (1, 1, 2100, 512),
                                   (1, 2, 300, 128), (1, 1, 77, 8), (1, 5, 9000, 64),
                                   (1, 2, 2100, 128), (1, 2, 520, 72), (1, 2, 1000, 36),
                                   (1, 1, 130, 136), (1, 2, 1000, 256), (1, 2, 700, 192)])
def test_kernels_match_plain_on_the_card(cuda_device, shape, dtype):
    """In bfloat16 the widths 8, 32, 64, 72 and 128 run all three kernels on
    the tensor cores (zero-filled to 64 or 128 columns), at a ragged N too;
    192, 256 and 512 run all three on the wide tensor-core kernels (192
    zero-filled to 256 columns; dK/dV in one group of output columns at 192
    and 256, two at 512), at a ragged N (700, 1000, 2100) too; 36 and 136 run
    the first CUDA-core kernels throughout. float32 runs the float32 kernels at every width
    (``kernel_route``): the forward, and dK/dV and dQ up to 128 (zero-filled
    to 64 or 128 columns); above 128 dK/dV and dQ run the wide float32
    kernels, at 136, 192 and 256 with 2 groups of 128 columns (136 and 192
    zero-filled to 256) and at 512 with 4, on ragged N (130, 700, 1000,
    2100) too."""
    b, h, n, d = shape
    q, k, v, do = (torch.from_numpy(a).to(cuda_device).to(dtype).transpose(1, 2)
                   for a in _qkv(n + d, (b, n, h, d)))
    scale = 1.0 / np.sqrt(d)
    before = (FA.LAUNCHES_FWD, FA.LAUNCHES_BWD_DKV, FA.LAUNCHES_BWD_DQ)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = FA.flash_attention(*leaves, sm_scale=scale)
    grads = torch.autograd.grad(out, leaves, do)
    _, lse = FA.flash_attention_with_lse(q, k, v, scale)
    torch.cuda.synchronize()
    assert (FA.LAUNCHES_FWD, FA.LAUNCHES_BWD_DKV, FA.LAUNCHES_BWD_DQ) == (
        before[0] + 2, before[1] + 1, before[2] + 1)
    o_ref, lse_ref = FA.reference_flash_attention(q, k, v, scale)
    ref_grads = FA.reference_flash_attention_bwd(q, k, v, o_ref, lse_ref, do, scale)
    tol_out, tol_grad = (2e-5, 1e-4) if dtype == torch.float32 else (2.0 ** -7, 1e-2)
    err_out = float((out.detach().float() - o_ref.float()).abs().max())
    if dtype == torch.bfloat16:      # one step of the bfloat16 grid at the largest entry
        err_out /= float(o_ref.float().abs().max())
    assert err_out <= tol_out
    np.testing.assert_allclose(lse.cpu().numpy(), lse_ref.cpu().numpy(), atol=2e-5)
    for got, expect in zip(grads, ref_grads):
        assert _rel(got.float().cpu().numpy(), expect.float().cpu().numpy()) <= tol_grad


@pytest.mark.cuda
@pytest.mark.parametrize("width", [64, 512])
@pytest.mark.parametrize("scale", [-0.3, 0.0])
def test_tensor_core_kernels_take_any_scale(cuda_device, scale, width):
    """The tensor-core forwards (width 64, and the wide kernel at 512) take
    the row maximum over the raw scores and fold the scale into the exponent:
    a negative or zero scale, on a ragged shape, goes through the branches
    that a positive one does not. dK/dV and dQ (on the tensor cores at width
    64, on the wide tensor-core kernels at 512) fold it into the exponent and
    into dS; at scale 0 dS is 0 and the keys past N are set to 0, not
    multiplied to it."""
    scale = scale * (64.0 / width) ** 0.5     # the same spread of scores at both widths
    q, k, v, do = (torch.from_numpy(a).to(cuda_device).to(torch.bfloat16).transpose(1, 2)
                   for a in _qkv(11, (1, 300, 2, width)))
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = FA.flash_attention(*leaves, sm_scale=scale)
    grads = torch.autograd.grad(out, leaves, do)
    o_ref, lse_ref = FA.reference_flash_attention(q, k, v, scale)
    ref_grads = FA.reference_flash_attention_bwd(q, k, v, o_ref, lse_ref, do, scale)
    assert _rel(out.detach().float().cpu().numpy(), o_ref.float().cpu().numpy()) <= 2.0 ** -7
    for got, expect in zip(grads, ref_grads):     # dq and dk are identically 0 at scale 0
        err = float((got.float() - expect.float()).abs().max())
        assert err <= 1e-2 * max(float(expect.float().abs().max()), 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [64, 128, 512])
@pytest.mark.parametrize("scale", [-0.3, 0.0])
def test_float32_kernels_take_any_scale(cuda_device, scale, width):
    """The float32 forward folds the scale into one multiply a score before
    the row maximum, and dK/dV and dQ into the exponent and dS: a negative or
    zero scale, on a ragged shape, against the plain version."""
    scale = scale * (64.0 / width) ** 0.5
    q, k, v, do = (torch.from_numpy(a).to(cuda_device).transpose(1, 2)
                   for a in _qkv(13, (1, 300, 2, width)))
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = FA.flash_attention(*leaves, sm_scale=scale)
    grads = torch.autograd.grad(out, leaves, do)
    o_ref, lse_ref = FA.reference_flash_attention(q, k, v, scale)
    ref_grads = FA.reference_flash_attention_bwd(q, k, v, o_ref, lse_ref, do, scale)
    assert float((out.detach() - o_ref).abs().max()) <= 2e-5
    for got, expect in zip(grads, ref_grads):     # dq and dk are identically 0 at scale 0
        err = float((got - expect).abs().max())
        assert err <= 1e-4 * max(float(expect.abs().max()), 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [64, 128])
def test_backward_takes_a_strided_output_gradient(cuda_device, width):
    """A dO that is a view with strides the 16-byte copies cannot take (a
    row stride that is not a multiple of 8 elements) is cloned by the wrapper:
    the gradients equal those of the same values held contiguously."""
    b, h, n = 1, 2, 333
    q, k, v, do = (torch.from_numpy(a).to(cuda_device).to(torch.bfloat16).transpose(1, 2)
                   for a in _qkv(5, (b, n, h, width)))
    padded = torch.zeros(b, h, n, width + 4, dtype=torch.bfloat16, device=cuda_device)
    padded[..., :width] = do
    view = padded[..., :width]
    assert view.stride(2) % 8 != 0 and FA._strided(view) is not view
    results = []
    for grad_out in (view, do.contiguous()):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = FA.flash_attention(*leaves, sm_scale=width ** -0.5)
        results.append(torch.autograd.grad(out, leaves, grad_out))
    torch.cuda.synchronize()
    for got, expect in zip(*results):
        assert torch.equal(got, expect)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [192, 512])
def test_wide_float32_backward_reads_a_strided_output_gradient(cuda_device, width):
    """A float32 dO whose row stride is the width plus 4 (a multiple of 4:
    the 16-byte copies take it) is read in place by the wide float32 dK/dV
    and dQ: the gradients equal those of the same values held contiguously,
    and two calls give the same bits."""
    b, h, n = 1, 2, 333
    q, k, v, do = (torch.from_numpy(a).to(cuda_device).transpose(1, 2)
                   for a in _qkv(7, (b, n, h, width)))
    padded = torch.zeros(b, h, n, width + 4, device=cuda_device)
    padded[..., :width] = do
    view = padded[..., :width]
    assert FA._strided(view) is view
    results = []
    for grad_out in (view, do.contiguous(), view):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = FA.flash_attention(*leaves, sm_scale=width ** -0.5)
        results.append(torch.autograd.grad(out, leaves, grad_out))
    torch.cuda.synchronize()
    for got, contiguous, again in zip(*results):
        assert torch.equal(got, contiguous) and torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [192, 512])
def test_wide_bf16_backward_reads_a_strided_output_gradient(cuda_device, width):
    """A bfloat16 dO whose row stride is the width plus 8 (a multiple of 8:
    the 16-byte copies take it) is read in place by the wide tensor-core
    dK/dV and dQ: the gradients equal those of the same values held
    contiguously, and two calls give the same bits."""
    b, h, n = 1, 2, 333
    q, k, v, do = (torch.from_numpy(a).to(cuda_device).to(torch.bfloat16).transpose(1, 2)
                   for a in _qkv(9, (b, n, h, width)))
    padded = torch.zeros(b, h, n, width + 8, dtype=torch.bfloat16, device=cuda_device)
    padded[..., :width] = do
    view = padded[..., :width]
    assert FA._strided(view) is view
    assert FA.kernel_route("bwd_dkv", torch.bfloat16, width) == "wide"
    results = []
    for grad_out in (view, do.contiguous(), view):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = FA.flash_attention(*leaves, sm_scale=width ** -0.5)
        results.append(torch.autograd.grad(out, leaves, grad_out))
    torch.cuda.synchronize()
    for got, contiguous, again in zip(*results):
        assert torch.equal(got, contiguous) and torch.equal(got, again)


@pytest.mark.cuda
def test_wide_bf16_backward_repeats_bit_for_bit(cuda_device):
    """The wide tensor-core dK/dV and dQ sum every output element in a fixed
    order, without atomics: two calls at (1, 1, 2100, 512) (two groups of
    output columns, a ragged last tile) give the same bits."""
    q, k, v, do = (torch.from_numpy(a).to(cuda_device).to(torch.bfloat16).transpose(1, 2)
                   for a in _qkv(17, (1, 2100, 1, 512)))
    scale = 512 ** -0.5
    o, lse = FA.flash_attention_with_lse(q, k, v, scale)
    di = FA._row_delta(o, do)
    q, k, v, do = (FA._strided(t) for t in (q, k, v, do))
    calls = [FA._launch_bwd_dkv(q, k, v, do, lse, di, scale)
             + (FA._launch_bwd_dq(q, k, v, do, lse, di, scale),) for _ in range(2)]
    torch.cuda.synchronize()
    for first, second in zip(*calls):
        assert torch.equal(first, second)
        assert bool(torch.isfinite(first).all())


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    q = torch.zeros(1, 2, 64, 6, device=cuda_device)
    with pytest.raises(ValueError, match="multiples of 4"):
        FA.flash_attention(q, q, q)
    q = torch.zeros(1, 2, 64, 8, device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        FA.flash_attention(q, q, q)
    q = torch.zeros(1, 2, 64, 8, device=cuda_device)
    with pytest.raises(NotImplementedError):
        FA.flash_attention(q, q, q, causal=True)
