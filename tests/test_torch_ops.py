"""CPU parity of the port's image ops (rgie_tpu_torch.ops) against the JAX
package's (rgie_tpu.ops): values at atol 1e-5; gradients with respect to the
image and the parameters at rtol 1e-3, atol 1e-5. Every input is made with
numpy from a seed and handed to both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgie_tpu.ops import chain as CH_j
from rgie_tpu.ops import color as C_j
from rgie_tpu.ops import curves as CU_j
from rgie_tpu.ops import filters as F_j
from rgie_tpu.ops import geometry as G_j
from rgie_tpu_torch.ops import chain as CH
from rgie_tpu_torch.ops import color as C
from rgie_tpu_torch.ops import curves as CU
from rgie_tpu_torch.ops import filters as F
from rgie_tpu_torch.ops import geometry as G

torch.set_num_threads(2)

VAL = dict(atol=1e-5, rtol=0)
GRAD = dict(rtol=1e-3, atol=1e-5)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a, np.float32), requires_grad=grad)


def _np(t):
    return t.detach().numpy()


def _image(rng, shape=(2, 32, 32, 3)):
    return rng.uniform(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("name", ["rgb_to_hsv", "rgb_to_hsl", "rgb_to_gray", "rgb_to_lum",
                                  "hsv_to_rgb", "hsl_to_rgb"])
def test_color_conversions(rng, name):
    x = _image(rng, (2, 9, 11, 3))
    x[0, 0, 0] = 0.0                 # black: zero-max / zero-delta guards
    x[0, 0, 1] = [0.5, 0.5, 0.5]     # gray: zero delta
    x[0, 0, 2] = [0.7, 0.7, 0.2]     # tied max channels
    got = getattr(C, name)(_t(x))
    expect = getattr(C_j, name)(jnp.asarray(x))
    np.testing.assert_allclose(_np(got), np.asarray(expect), **VAL)


def test_lerp(rng):
    a, b = _image(rng, (4, 4, 3)), _image(rng, (4, 4, 3))
    np.testing.assert_allclose(_np(C.lerp(_t(a), _t(b), 0.3)),
                               np.asarray(C_j.lerp(jnp.asarray(a), jnp.asarray(b), 0.3)), **VAL)


@pytest.mark.parametrize("channels,normalize", [(1, False), (3, False), (3, True)])
def test_curve_adjustment(rng, channels, normalize):
    x = _image(rng, (2, 8, 8, 3))
    p = rng.uniform(0.5, 1.5, (8, channels)).astype(np.float32)
    got = CU.apply_curve_adjustment(_t(x), _t(p), normalize=normalize)
    expect = CU_j.apply_curve_adjustment(jnp.asarray(x), jnp.asarray(p), normalize=normalize)
    np.testing.assert_allclose(_np(got), np.asarray(expect), **VAL)


# (op name, parameter) pairs; each op is checked on values and on gradients
# with respect to the image and the parameter.
OPS = [
    ("apply_exposure", 0.3), ("apply_saturation", 1.3), ("apply_contrast", 1.2),
    ("apply_brightness", 0.1), ("apply_gamma", 1.3), ("apply_hue", 0.4),
    ("apply_black_white", 0.3), ("apply_white_balance", 0.4),
    ("apply_tone_curve", "tone"), ("apply_color_curve", "color"),
    ("apply_gaussian_blur", 1.5), ("apply_sharpness", 0.7), ("apply_scale", "scale"),
]


def _op_param(rng, p):
    if p == "tone":
        return rng.uniform(0.6, 1.4, (8, 1)).astype(np.float32)
    if p == "color":
        return rng.uniform(0.6, 1.4, (8, 3)).astype(np.float32)
    if p == "scale":
        return np.asarray([[1.07, 1.12, 13.0, 17.0], [1.2, 1.05, 16.5, 9.0]], np.float32)
    return np.asarray(p, np.float32)


@pytest.mark.parametrize("name,p", OPS, ids=[o[0] for o in OPS])
def test_filter_values_and_grads(rng, name, p):
    x = _image(rng)
    p = _op_param(rng, p)
    w = rng.normal(size=x.shape).astype(np.float32)

    def loss_j(img, q):
        return jnp.sum(getattr(F_j, name)(img, q) * w)

    val_j = getattr(F_j, name)(jnp.asarray(x), jnp.asarray(p))
    gx_j, gp_j = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(p))

    xt, pt = _t(x, True), _t(p, True)
    out = getattr(F, name)(xt, pt)
    torch.sum(out * _t(w)).backward()
    np.testing.assert_allclose(_np(out), np.asarray(val_j), **VAL)
    np.testing.assert_allclose(_np(xt.grad), np.asarray(gx_j), **GRAD)
    np.testing.assert_allclose(_np(pt.grad), np.asarray(gp_j), **GRAD)


def test_per_image_parameters_match_one_image_at_a_time(rng):
    """A (B,) parameter applies image by image, as vmap does in JAX."""
    x = _image(rng)
    sig = np.asarray([0.8, 2.0], np.float32)
    got = _np(F.apply_gaussian_blur(_t(x), _t(sig)))
    for b in range(2):
        expect = F_j.apply_gaussian_blur(jnp.asarray(x[b:b + 1]), jnp.asarray(sig[b]))
        np.testing.assert_allclose(got[b:b + 1], np.asarray(expect), **VAL)


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["zeros", "border"])
def test_bilinear_sample_and_warp_affine(rng, mode):
    x = _image(rng, (2, 12, 14, 3))
    m = np.asarray([[[1.1, 0.1, -1.5], [-0.05, 0.95, 2.0]],
                    [[0.9, -0.2, 3.0], [0.15, 1.2, -2.5]]], np.float32)
    got = G.warp_affine(_t(x), _t(m), padding_mode=mode)
    expect = G_j.warp_affine(jnp.asarray(x), jnp.asarray(m), padding_mode=mode)
    np.testing.assert_allclose(_np(got), np.asarray(expect), **VAL)
    sx = rng.uniform(-2, 15, (5, 7)).astype(np.float32)
    sy = rng.uniform(-2, 13, (5, 7)).astype(np.float32)
    got = G.bilinear_sample(_t(x[0]), _t(sx), _t(sy), mode)
    expect = G_j.bilinear_sample(jnp.asarray(x[0]), jnp.asarray(sx), jnp.asarray(sy), mode)
    np.testing.assert_allclose(_np(got), np.asarray(expect), **VAL)


@pytest.mark.parametrize("center", [True, False])
def test_scale_about_center_identity_ties(rng, center):
    """At scale 1 every sampled coordinate sits on an interpolation-tap corner:
    the gradient with respect to the scale follows JAX's 0.5 tie split."""
    x = _image(rng, (2, 10, 12, 3))
    s = np.ones((2, 2), np.float32)
    c = np.asarray([[5.5, 4.5], [3.0, 6.0]], np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)

    def loss_j(img, s_, c_):
        out = G_j.scale_about_center(img, s_, c_ if center else None)
        return jnp.sum(out * w)

    gx_j, gs_j, gc_j = jax.grad(loss_j, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(s), jnp.asarray(c))
    xt, st, ct = _t(x, True), _t(s, True), _t(c, True)
    out = G.scale_about_center(xt, st, ct if center else None)
    torch.sum(out * _t(w)).backward()
    np.testing.assert_allclose(_np(out), x, **VAL)
    np.testing.assert_allclose(_np(xt.grad), np.asarray(gx_j), **GRAD)
    np.testing.assert_allclose(_np(st.grad), np.asarray(gs_j), **GRAD)
    if center:
        np.testing.assert_allclose(_np(ct.grad), np.asarray(gc_j), **GRAD)


@pytest.mark.parametrize("src,dst,antialias", [
    ((1, 96, 96, 3), (45, 45), False),   # the CLIP resize shape class, shrink
    ((1, 96, 96, 3), (45, 45), True),
    ((1, 51, 51, 3), (96, 96), True),    # upsampling
    ((2, 64, 64, 3), (56, 56), True),
    ((64, 48, 3), (32, 24), True),       # unbatched HWC
])
def test_resize(rng, src, dst, antialias):
    # jax.image.resize and F.interpolate(bilinear, half-pixel, antialias)
    # agree to a few 1e-6 (different weight arithmetic).
    x = rng.uniform(0, 1, src).astype(np.float32)
    got = G.resize(_t(x), dst, antialias=antialias)
    expect = G_j.resize(jnp.asarray(x), dst, antialias=antialias)
    np.testing.assert_allclose(_np(got), np.asarray(expect), **VAL)


@pytest.mark.parametrize("hw", [(40, 60), (60, 40), (33, 33)])
def test_resize_shorter_side_and_center_crop(rng, hw):
    x = _image(rng, (1,) + hw + (3,))
    got = G.resize_shorter_side(_t(x), 24)
    expect = G_j.resize_shorter_side(jnp.asarray(x), 24)
    assert got.shape == expect.shape
    np.testing.assert_allclose(_np(got), np.asarray(expect), **VAL)
    np.testing.assert_array_equal(_np(G.center_crop(_t(x), 20)),
                                  np.asarray(G_j.center_crop(jnp.asarray(x), 20)))
    np.testing.assert_array_equal(_np(G.center_crop(_t(x[0]), 20)),
                                  np.asarray(G_j.center_crop(jnp.asarray(x[0]), 20)))


def test_ten_crops(rng):
    for h, w, c in [(480, 480, 448), (64, 64, 56), (50, 70, 31)]:
        assert G.ten_crop_offsets(h, w, c) == G_j.ten_crop_offsets(h, w, c)
    x = _image(rng, (2, 20, 24, 3))
    got = G.replicate_and_crop(_t(x), 16)
    expect = G_j.replicate_and_crop(jnp.asarray(x), 16)
    np.testing.assert_array_equal(_np(got), np.asarray(expect))
    y = rng.normal(size=(20, 4)).astype(np.float32)
    np.testing.assert_allclose(_np(G.mean_replicated(_t(y))),
                               np.asarray(G_j.mean_replicated(jnp.asarray(y))), **VAL)


def test_random_crops_follow_the_generator(rng):
    x = _image(rng, (2, 20, 24, 3))
    got = _np(G.replicate_and_crop(_t(x), 16, 5, generator=torch.Generator().manual_seed(3)))
    g = torch.Generator().manual_seed(3)
    tops = torch.randint(0, 5, (5,), generator=g).tolist()
    lefts = torch.randint(0, 9, (5,), generator=g).tolist()
    assert got.shape == (10, 16, 16, 3)
    for b in range(2):
        for i, (t, l) in enumerate(zip(tops, lefts)):
            np.testing.assert_array_equal(got[b * 5 + i], x[b, t:t + 16, l:l + 16])


# ---------------------------------------------------------------------------
# The chain and its vector
# ---------------------------------------------------------------------------


def _perturbed_x0(rng):
    """The kink-free start of tests/test_fullstack_parity.py:66-73."""
    x0 = np.asarray(CH_j.pack_params(CH_j.init_params()), np.float32).copy()
    x0[0] = 0.08
    x0[1] = 0.93
    x0[2:34] += rng.uniform(-0.05, 0.05, 32).astype(np.float32)
    x0[34] = 1.07
    x0[35] = 0.25
    x0[36] = 0.4
    x0[37:41] = [1.07, 1.12, 13.0, 17.0]
    return x0


def test_pack_unpack_layout(rng):
    x = rng.normal(size=41).astype(np.float32)
    x[34] = -0.5                      # contrast gated at 0
    x[37] = 0.5                       # scale floored at 1
    x[39] = 900.0                     # center capped at input_size
    pj = CH_j.unpack_params(jnp.asarray(x), input_size=480)
    pt = CH.unpack_params(_t(x), input_size=480)
    for f in ("exposure", "saturation", "tone", "color", "contrast", "sharp", "blur", "scale"):
        np.testing.assert_array_equal(_np(getattr(pt, f)), np.asarray(getattr(pj, f)), err_msg=f)
    np.testing.assert_array_equal(_np(CH.pack_params(CH.init_params())),
                                  np.asarray(CH_j.pack_params(CH_j.init_params())))
    y = np.abs(rng.normal(size=(3, 41))).astype(np.float32)   # inside every clamp
    y[:, 37:39] += 1.0
    np.testing.assert_array_equal(_np(CH.pack_params(CH.unpack_params(_t(y), 480))), y)
    assert CH.NUM_PARAMS == CH_j.NUM_PARAMS == 41


@pytest.mark.parametrize("start", ["perturbed", "identity"])
def test_edit_image_values_and_grads(rng, start):
    """The full chain, gradient with respect to the vector and the image, at
    the perturbed start and at the identity init (where clamp ties decide)."""
    x = _image(rng)
    if start == "perturbed":
        v = _perturbed_x0(rng)
    else:
        v = np.asarray(CH_j.pack_params(CH_j.init_params()), np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)

    def loss_j(img, vec):
        return jnp.sum(CH_j.edit_image(img, vec, input_size=32) * w)

    val_j = CH_j.edit_image(jnp.asarray(x), jnp.asarray(v), input_size=32)
    gx_j, gv_j = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(v))
    xt, vt = _t(x, True), _t(v, True)
    out = CH.edit_image(xt, vt, input_size=32)
    torch.sum(out * _t(w)).backward()
    np.testing.assert_allclose(_np(out), np.asarray(val_j), **VAL)
    np.testing.assert_allclose(_np(xt.grad), np.asarray(gx_j), **GRAD)
    np.testing.assert_allclose(_np(vt.grad), np.asarray(gv_j), **GRAD)


def test_batched_vectors_edit_each_image(rng):
    """A (B, 41) vector edits image b with row b, as the vmapped JAX edit."""
    x = _image(rng)
    v = np.stack([_perturbed_x0(rng), _perturbed_x0(rng)])
    got = _np(CH.edit_image(_t(x), _t(v), input_size=32))
    for b in range(2):
        expect = CH_j.edit_image(jnp.asarray(x[b:b + 1]), jnp.asarray(v[b]), input_size=32)
        np.testing.assert_allclose(got[b:b + 1], np.asarray(expect), **VAL)
