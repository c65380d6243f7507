"""Kernel K1 (the fused pointwise filter prefix): its plain PyTorch version
against the JAX package's Pallas kernel in interpret mode and against its
plain reference, on the CPU; the Triton kernel against the plain version on
the card (marked ``cuda``, skipped without a card and Triton).

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


def test_identity_parameters(rng):
    img = rng.uniform(0, 1, (1, 8, 128, 3)).astype(np.float32)
    got = PC.pointwise_chain(torch.from_numpy(img), CH.init_params()).numpy()
    np.testing.assert_allclose(got, img, atol=1e-5, rtol=0)


def test_cpu_tensor_runs_the_plain_version_without_counting(rng):
    img = torch.from_numpy(rng.uniform(0, 1, (1, 8, 8, 3)).astype(np.float32))
    before = PC.LAUNCHES
    PC.pointwise_chain(img, _params(_draw(rng)))
    assert PC.LAUNCHES == before


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
def cuda_triton():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pytest.importorskip("triton")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 16, 128, 3), (1, 13, 37, 3), (4, 256, 256, 3),
                                   (1, 1000, 760, 3)])
def test_kernel_matches_plain_on_card(card_rng, cuda_triton, shape):
    rng = card_rng
    img = torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32)).to(cuda_triton)
    params = _params(_draw(rng), cuda_triton)
    before = PC.LAUNCHES
    got = PC.pointwise_chain(img, params)
    assert PC.LAUNCHES == before + 1
    expect = PC.reference_pointwise_chain(img, params)
    torch.cuda.synchronize()
    assert float((got - expect).abs().max()) <= 2e-5


@pytest.mark.cuda
def test_kernel_rejects_non_contiguous_on_card(cuda_triton):
    img = torch.rand(1, 8, 16, 3, device=cuda_triton)
    with pytest.raises(ValueError):
        PC.pointwise_chain(img[:, :, ::2], CH.init_params(device=cuda_triton))
    with pytest.raises(TypeError):
        PC.pointwise_chain(img.double(), CH.init_params(device=cuda_triton))
