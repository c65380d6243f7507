"""Kernel K1 (the fused pointwise filter prefix): its plain PyTorch versions
(the kernel's two-pass order, and the separate ops) against the JAX
package's Pallas kernel in interpret mode and against its plain reference,
the source's constants and C signature against the wrapper, on the CPU; the
CUDA kernel against the plain version on the card (marked ``cuda``, skipped
without a card).

JAX is imported inside the parity tests only, so that the card's tests run
where JAX is not installed:
``python -m pytest tests/test_torch_pointwise_chain.py -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

from rgie_tpu_torch.ops import chain as CH
from rgie_tpu_torch.ops.kernels import pointwise_chain as PC

torch.set_num_threads(2)


def _draw(rng):
    """Parameters as tests/test_pallas.py:12-20 draws them, contrast included."""
    return dict(exposure=np.float32(rng.uniform(-0.4, 0.4)),
                saturation=np.float32(rng.uniform(0.4, 1.8)),
                contrast=np.float32(rng.uniform(0.5, 1.6)),
                tone=rng.uniform(0.6, 1.4, (8, 1)).astype(np.float32),
                color=rng.uniform(0.6, 1.4, (8, 3)).astype(np.float32))


def _params(values, device="cpu"):
    p = CH.init_params(device=device)
    for k, v in values.items():
        setattr(p, k, torch.tensor(v, device=device))
    return p


def _params_j(values):
    import jax.numpy as jnp

    from rgie_tpu.ops import chain as CH_j

    return CH_j.init_params().replace(**{k: jnp.asarray(v) for k, v in values.items()})


def test_plain_matches_pallas_interpret(rng):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from rgie_tpu.ops.pallas import pointwise_chain as PC_j

    img = rng.uniform(0, 1, (2, 16, 128, 3)).astype(np.float32)
    values = _draw(rng)
    with pltpu.force_tpu_interpret_mode():
        expect = np.asarray(PC_j.fused_pointwise_chain(jnp.asarray(img), _params_j(values), rows=8))
    got = PC.pointwise_chain(torch.from_numpy(img), _params(values)).numpy()
    np.testing.assert_allclose(got, expect, atol=2e-5, rtol=0)


def test_plain_matches_reference_on_ragged_shape(rng):
    import jax.numpy as jnp

    from rgie_tpu.ops.pallas import pointwise_chain as PC_j

    img = rng.uniform(0, 1, (1, 13, 37, 3)).astype(np.float32)
    values = _draw(rng)
    expect = np.asarray(PC_j.reference_pointwise_chain(jnp.asarray(img), _params_j(values)))
    got = PC.reference_pointwise_chain(torch.from_numpy(img), _params(values)).numpy()
    np.testing.assert_allclose(got, expect, atol=2e-5, rtol=0)


@pytest.mark.parametrize("pixels_per_block", [1024, PC.PIXELS_PER_BLOCK])
def test_two_pass_order_matches_pallas_interpret_on_ragged_shape(rng, pixels_per_block):
    """The kernel's order in plain PyTorch: gray partial sums per block of
    pixels (the last one short: 24 x 203 pixels an image), summed into the
    mean, then the prefix recomputed and the contrast; against JAX's fused
    kernel run in interpret mode."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from rgie_tpu.ops.pallas import pointwise_chain as PC_j

    img = rng.uniform(0, 1, (2, 24, 203, 3)).astype(np.float32)
    values = _draw(rng)
    with pltpu.force_tpu_interpret_mode():
        expect = np.asarray(PC_j.fused_pointwise_chain(jnp.asarray(img), _params_j(values), rows=8))
    got = PC.two_pass_pointwise_chain(torch.from_numpy(img), _params(values),
                                      pixels_per_block=pixels_per_block).numpy()
    np.testing.assert_allclose(got, expect, atol=1e-5, rtol=0)


def test_table_curve_equals_the_knot_by_knot_sum(rng):
    """The kernel's curve, C_k + (v - k/8) w_k from a table of running sums,
    is bit for bit the JAX kernel's sum of clip(v - i/8, 0, 1/8) w_i over the
    knots in order (float32 throughout), at the knots, next to them and in
    between, with weights of either sign."""
    knots = np.arange(9, dtype=np.float32) / 8
    v = np.concatenate([knots, np.nextafter(knots, np.float32(-1)), np.nextafter(knots, np.float32(2)),
                        rng.uniform(0, 1, 2000).astype(np.float32)])
    v = np.clip(v, 0, 1).astype(np.float32)
    w = rng.uniform(-0.5, 1.8, (8, 3)).astype(np.float32)
    x = np.stack([v, v[::-1], np.roll(v, 7)], axis=-1)
    total = np.zeros_like(x)
    for i in range(8):
        total = total + np.clip(x - np.float32(i / 8), np.float32(0), np.float32(0.125)) * w[i]
    expect = np.clip(np.minimum(total, np.float32(1)), 0, 1)
    got = PC._table_curve(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got, expect)
    got_tone = PC._table_curve(torch.from_numpy(x), torch.from_numpy(w[:, :1])).numpy()
    total = np.zeros_like(x)
    for i in range(8):
        total = total + np.clip(x - np.float32(i / 8), np.float32(0), np.float32(0.125)) * w[i, 0]
    np.testing.assert_array_equal(got_tone, np.clip(np.minimum(total, np.float32(1)), 0, 1))


def test_source_matches_the_wrapper():
    """What the wrapper assumes of ``csrc/pointwise_chain.cu``: its block
    takes ``PIXELS_PER_BLOCK`` pixels, its C entry point has as many
    parameters as ``ctypes`` is told, and it returns the launch status."""
    import re

    from rgie_tpu_torch.ops.kernels import build

    text = (build.CSRC_DIR / f"{PC.KERNEL_SOURCE}.cu").read_text()
    consts = {name: int(value) for name, value in
              re.findall(r"constexpr int (kThreads|kGroups) = (\d+);", text)}
    assert "constexpr int kPixels = kThreads * kGroups * 4;" in text
    assert consts["kThreads"] * consts["kGroups"] * 4 == PC.PIXELS_PER_BLOCK
    signature = text[text.index('extern "C" int rgie_pointwise_chain('):]
    signature = signature[:signature.index(")")]
    assert signature.count(",") + 1 == len(PC._ARGTYPES)
    assert "cudaGetLastError" in text and "torch/" not in text and "atomicAdd" not in text


def test_identity_parameters(rng):
    img = rng.uniform(0, 1, (1, 8, 128, 3)).astype(np.float32)
    got = PC.pointwise_chain(torch.from_numpy(img), CH.init_params()).numpy()
    np.testing.assert_allclose(got, img, atol=1e-5, rtol=0)


def test_cpu_tensor_runs_the_plain_version_without_counting(rng):
    img = torch.from_numpy(rng.uniform(0, 1, (1, 8, 8, 3)).astype(np.float32))
    params = _params(_draw(rng))
    before = PC.LAUNCHES
    got = PC.pointwise_chain(img, params)
    assert PC.LAUNCHES == before
    np.testing.assert_array_equal(got.numpy(), PC.two_pass_pointwise_chain(img, params).numpy())


def test_kernel_input_check_refuses_bfloat16_and_non_contiguous(rng):
    """The checks a CUDA tensor meets before a launch, on CPU tensors: only a
    contiguous float32 image passes."""
    img = torch.from_numpy(rng.uniform(0, 1, (1, 8, 16, 3)).astype(np.float32))
    PC.check_kernel_input(img)
    with pytest.raises(TypeError, match="float32"):
        PC.check_kernel_input(img.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        PC.check_kernel_input(img[:, :, ::2])
    with pytest.raises(ValueError, match="contiguous"):
        PC.check_kernel_input(img.permute(0, 2, 1, 3))


def test_rejects_what_the_kernel_does_not_take(rng):
    img = torch.from_numpy(rng.uniform(0, 1, (1, 8, 8, 3)).astype(np.float32))
    with pytest.raises(ValueError):
        PC.pointwise_chain(img[..., :2], CH.init_params())
    batched = CH.unpack_params(CH.pack_params(CH.init_params()).expand(2, -1))
    with pytest.raises(ValueError):
        PC.pointwise_chain(img, batched)


def test_edit_image_fused_matches_jax(rng):
    """The re-render entry point (prefix fused, then sharp, blur, scale) at
    64 px against JAX's edit_image_fused on the CPU."""
    import jax.numpy as jnp

    from rgie_tpu.ops import chain as CH_j

    img = rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    x = np.asarray(CH_j.pack_params(CH_j.init_params()), np.float32).copy()
    x[0], x[1], x[34], x[35], x[36] = 0.1, 1.2, 1.1, 0.3, 0.7
    x[2:34] += rng.uniform(-0.1, 0.1, 32).astype(np.float32)
    x[37:41] = [1.1, 1.05, 30.0, 34.0]
    expect = np.asarray(CH_j.edit_image_fused(jnp.asarray(img), jnp.asarray(x), input_size=64))
    got = CH.edit_image_fused(torch.from_numpy(img), torch.from_numpy(x), input_size=64).numpy()
    np.testing.assert_allclose(got, expect, atol=2e-5, rtol=0)


# ---------------------------------------------------------------------------
# On the card only
# ---------------------------------------------------------------------------


@pytest.fixture
def card_rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel is CUDA C++ built with nvcc)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 16, 128, 3), (1, 13, 37, 3), (4, 256, 256, 3),
                                   (1, 1000, 760, 3)])
def test_kernel_matches_plain_on_card(card_rng, cuda_device, shape):
    rng = card_rng
    img = torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32)).to(cuda_device)
    params = _params(_draw(rng), cuda_device)
    if shape[0] == 4:     # parameters read in place from a vector's views, as the re-render does
        params = CH.unpack_params(CH.pack_params(params))
    before = PC.LAUNCHES
    got = PC.pointwise_chain(img, params)
    assert PC.LAUNCHES == before + 1
    expect = PC.reference_pointwise_chain(img, params)
    torch.cuda.synchronize()
    assert float((got - expect).abs().max()) <= 2e-5


@pytest.mark.cuda
def test_kernel_rejects_non_contiguous_on_card(cuda_device):
    img = torch.rand(1, 8, 16, 3, device=cuda_device)
    with pytest.raises(ValueError):
        PC.pointwise_chain(img[:, :, ::2], CH.init_params(device=cuda_device))
    with pytest.raises(TypeError):
        PC.pointwise_chain(img.double(), CH.init_params(device=cuda_device))
