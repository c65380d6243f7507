"""``rgie_tpu_torch/models/layers.py`` against ``rgie_tpu/models/layers.py`` on
the CPU, after ``tests/test_layers.py``: each layer built in JAX, its weights
moved with ``utils.from_jax.layer_state_dict`` (the UNIT autoencoder's with
``unit_autoencoder_state_dict``) into the port's layer with ``strict=True``,
then both run on the same numpy inputs from a seed. Parameters that start
at zero (gains, noise scales, biases) are drawn away from zero first, so
each term counts.

Tolerance: float32 on both sides, summed in other orders: 1e-5 of the
output's largest entry (``RTOL``); masks and the noise-free paths equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgie_tpu.config import MunitGenConfig as MunitGenConfig_j
from rgie_tpu.models import layers as LJ
from rgie_tpu_torch.config import MunitGenConfig
from rgie_tpu_torch.models import layers as L
from rgie_tpu_torch.utils.from_jax import layer_state_dict, unit_autoencoder_state_dict

torch.set_num_threads(2)

RTOL = 1e-5


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _perturb(variables, rng):
    """Every parameter plus a draw of scale 0.3: zero-initialized gains and
    biases count."""
    return jax.tree.map(lambda p: p + 0.3 * jnp.asarray(_rand(rng, *p.shape)), variables)


def _port(module, variables, convert=layer_state_dict):
    module.load_state_dict(convert(variables), strict=True)
    return module.eval()


def _close(got, expect):
    expect = np.asarray(expect)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == expect.shape
    np.testing.assert_allclose(got, expect, rtol=0, atol=RTOL * max(np.abs(expect).max(), 1.0))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_non_local_block(key, rng):
    x = _rand(rng, 2, 8, 6, 16)
    mod = LJ.NonLocal2dBlock(16)
    v = _perturb(mod.init(key, jnp.asarray(x)), rng)
    _close(_port(L.NonLocal2dBlock(16), v)(_t(x)), mod.apply(v, jnp.asarray(x)))


@pytest.mark.parametrize("demodulate", [True, False])
def test_modulated_conv(key, rng, demodulate):
    x, style = _rand(rng, 2, 8, 8, 8), _rand(rng, 2, 4)
    mod = LJ.ModulatedConv2d(16, demodulate=demodulate)
    v = _perturb(mod.init(key, jnp.asarray(x), jnp.asarray(style)), rng)
    port = _port(L.ModulatedConv2d(8, 16, 4, demodulate=demodulate), v)
    _close(port(_t(x), _t(style)), mod.apply(v, jnp.asarray(x), jnp.asarray(style)))


@pytest.mark.parametrize("stride", [1, 2])
def test_partial_conv_and_its_mask(key, rng, stride):
    x = _rand(rng, 2, 8, 8, 4)
    mask = np.zeros((2, 8, 8, 1), np.float32)
    mask[:, 2:6, 1:5] = 1.0
    mod = LJ.PartialConv2d(6, stride=stride)
    v = _perturb(mod.init(key, jnp.asarray(x), jnp.asarray(mask)), rng)
    port = _port(L.PartialConv2d(4, 6, stride=stride), v)
    y, new_mask = port(_t(x), _t(mask))
    y_j, new_mask_j = mod.apply(v, jnp.asarray(x), jnp.asarray(mask))
    _close(y, y_j)
    assert np.array_equal(new_mask.numpy(), np.asarray(new_mask_j))
    y, _ = port(_t(x))
    _close(y, mod.apply(v, jnp.asarray(x))[0])


@pytest.mark.parametrize("with_bias", [False, True])
def test_hyper_conv(key, rng, with_bias):
    x, w = _rand(rng, 2, 6, 6, 3), 0.1 * _rand(rng, 2, 3, 3, 3, 5)
    bias = _rand(rng, 2, 5) if with_bias else None
    mod = LJ.HyperConv2d(kernel=3)
    v = mod.init(key, jnp.asarray(x), jnp.asarray(w))
    args_j = (jnp.asarray(x), jnp.asarray(w)) + ((jnp.asarray(bias),) if with_bias else ())
    got = L.HyperConv2d(kernel=3)(_t(x), _t(w), None if bias is None else _t(bias))
    _close(got, mod.apply(v, *args_j))


def test_apply_noise_and_constant_input(key, rng):
    x, noise = _rand(rng, 2, 4, 4, 3), _rand(rng, 2, 4, 4, 1)
    mod = LJ.ApplyNoise()
    v = _perturb(mod.init(key, jnp.asarray(x), noise=jnp.asarray(noise)), rng)
    port = _port(L.ApplyNoise(), v)
    _close(port(_t(x), noise=_t(noise)), mod.apply(v, jnp.asarray(x), noise=jnp.asarray(noise)))
    assert torch.equal(port(_t(x)), _t(x))
    # One draw per pixel from the generator, shared over the channels, times
    # the learned scale.
    drawn = port(torch.zeros(2, 4, 4, 3), generator=torch.Generator().manual_seed(3))
    expect = port.scale * torch.randn((2, 4, 4, 1), generator=torch.Generator().manual_seed(3))
    assert torch.equal(drawn, expect.expand(2, 4, 4, 3)) and expect.abs().max() > 0

    ci = LJ.ConstantInput(8, size=4)
    v = ci.init(key, 3)
    _close(_port(L.ConstantInput(8, size=4), v)(3), ci.apply(v, 3))


def test_pixel_norm(rng):
    x = 5 * _rand(rng, 2, 4, 4, 8)
    _close(L.pixel_norm(_t(x)), LJ.pixel_norm(jnp.asarray(x)))


def test_unit_autoencoder(key, rng):
    kw = dict(num_filters=4, max_num_filters=16, num_res_blocks=1, num_downsamples_content=2)
    img = rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    mod = LJ.UnitAutoEncoder(MunitGenConfig_j(**kw))
    v = _perturb(mod.init(key, jnp.asarray(img)), rng)
    cfg = MunitGenConfig(**kw)
    port = _port(L.UnitAutoEncoder(cfg), v, lambda var: unit_autoencoder_state_dict(var, cfg))
    content = port.encode(_t(img))
    content_j = mod.apply(v, jnp.asarray(img), method=LJ.UnitAutoEncoder.encode)
    _close(content, content_j)
    assert content.shape == (1, 8, 8, 16)
    _close(port(_t(img)), mod.apply(v, jnp.asarray(img)))


@pytest.mark.parametrize("cond_hw", [(4, 4), (6, 10)])
def test_spade(key, rng, cond_hw):
    """The conditioning map resized up and to a shape that does not divide
    evenly (nearest, half-pixel centers)."""
    x, cond = _rand(rng, 1, 8, 8, 6), _rand(rng, 1, *cond_hw, 3)
    mod = LJ.SpatiallyAdaptiveNorm(6, hidden=8)
    v = _perturb(mod.init(key, jnp.asarray(x), jnp.asarray(cond)), rng)
    port = _port(L.SpatiallyAdaptiveNorm(6, 3, hidden=8), v)
    _close(port(_t(x), _t(cond)), mod.apply(v, jnp.asarray(x), jnp.asarray(cond)))


def test_norms_and_equalized_dense(key, rng):
    x = _rand(rng, 2, 8, 8, 6)
    for mod, port in ((LJ.LayerNorm2d(), L.LayerNorm2d(6)), (LJ.ScaleNorm(), L.ScaleNorm())):
        v = _perturb(mod.init(key, jnp.asarray(x)), rng)
        _close(_port(port, v)(_t(x)), mod.apply(v, jnp.asarray(x)))
    d = _rand(rng, 3, 7)
    eq = LJ.EqualizedDense(5, lr_mul=0.5)
    v = _perturb(eq.init(key, jnp.asarray(d)), rng)
    _close(_port(L.EqualizedDense(7, 5, lr_mul=0.5), v)(_t(d)), eq.apply(v, jnp.asarray(d)))


@pytest.mark.parametrize("spatial", [(16,), (6, 8), (4, 4, 5)])
def test_convnd_and_resnd_blocks(key, rng, spatial):
    nd = len(spatial)
    x = _rand(rng, 2, *spatial, 4)
    for mod, port in (
            (LJ.ConvNdBlock(8, 3, spatial_dims=nd, pad=1, norm="instance"),
             L.ConvNdBlock(4, 8, 3, spatial_dims=nd, pad=1, norm="instance")),
            (LJ.ConvNdBlock(6, 3, spatial_dims=nd, stride=2, activation="tanh"),
             L.ConvNdBlock(4, 6, 3, spatial_dims=nd, stride=2, activation="tanh")),
            (LJ.ResNdBlock(4, spatial_dims=nd), L.ResNdBlock(4, spatial_dims=nd))):
        v = _perturb(mod.init(key, jnp.asarray(x)), rng)
        _close(_port(port, v)(_t(x)), mod.apply(v, jnp.asarray(x)))


@pytest.mark.parametrize("activation", ["none", "relu"])
def test_embedding_block(key, activation):
    ids = np.asarray([[1, 2, 3], [9, 0, 4]], np.int32)
    mod = LJ.EmbeddingBlock(10, 6, activation=activation)
    v = mod.init(key, jnp.asarray(ids))
    got = _port(L.EmbeddingBlock(10, 6, activation=activation), v)(torch.from_numpy(ids).long())
    _close(got, mod.apply(v, jnp.asarray(ids)))
