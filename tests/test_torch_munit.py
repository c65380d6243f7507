"""CPU parity of the port's MUNIT generator (rgie_tpu_torch.models.munit)
against the JAX package's, with the JAX weights carried over by
``utils.from_jax.munit_state_dict``, in float32 and bfloat16; and the MUNIT
checkpoint reader on the torch twin's imaginaire-keyed state dict with
spectral norms, against the twin itself and against JAX through
``convert_munit_autoencoder``.

bfloat16 tolerance: both packages round to 8 significant bits at the same
points (each convolution's input, weights and output, each instance norm's
statistics and result), so they differ where a float32 sum lands on the
other side of a rounding boundary: one step of the grid, 2^-8 of the value,
which the following instance norms rescale and the layers pass on. Eight
steps of the grid at the largest entry, 2^-5, bounds that through the
generator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgie_tpu.config import MunitGenConfig as MunitGenConfigJ
from rgie_tpu.models import munit as MJ
from rgie_tpu_torch.config import MunitGenConfig
from rgie_tpu_torch.models import munit as M
from rgie_tpu_torch.models.init import freeze_
from rgie_tpu_torch.utils import from_jax as FJ

torch.set_num_threads(2)

SMALL_KW = dict(num_filters=8, max_num_filters=32, num_filters_mlp=16, num_res_blocks=2,
                num_downsamples_style=3, num_downsamples_content=2)
SMALL, SMALL_J = MunitGenConfig(**SMALL_KW), MunitGenConfigJ(**SMALL_KW)
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
TOLERANCE = {"float32": 1e-5, "bfloat16": 2.0 ** -5}


def rel_err(got, expect):
    """Max abs error relative to the largest entry of ``expect``."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    expect = np.asarray(expect, np.float32)
    return float(np.abs(got - expect).max() / np.abs(expect).max())


def nchw(x):
    return torch.from_numpy(np.asarray(x, np.float32)).permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1)


def _carry(variables, dtype=torch.float32, cfg=SMALL):
    ae = M.AutoEncoder(cfg, dtype)
    ae.load_state_dict(FJ.munit_state_dict(jax.tree.map(np.asarray, variables), cfg), strict=True)
    return freeze_(ae)


@pytest.fixture(scope="module", params=list(DTYPES))
def generators(request):
    """A JAX generator of SMALL width in the given type and the port's domain
    a with its weights; plus inputs."""
    dtype, dtype_j = DTYPES[request.param]
    gen_j = MJ.create_generator(jax.random.PRNGKey(0), SMALL_J, image_size=32, dtype=dtype_j)
    rng = np.random.default_rng(0)
    return dict(name=request.param, dtype=dtype, gen_j=gen_j, ae=_carry(gen_j.variables_a, dtype),
                images=rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32),
                style=rng.normal(size=(2, 8)).astype(np.float32))


# ---------------------------------------------------------------------------
# The layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(DTYPES))
def test_instance_norm_matches_jax(rng, name):
    dtype, dtype_j = DTYPES[name]
    x = rng.normal(2.0, 3.0, (2, 8, 8, 4)).astype(np.float32)
    expect = MJ.instance_norm(jnp.asarray(x, dtype_j))
    got = M.instance_norm(nchw(x).to(dtype))
    assert got.dtype == dtype
    assert rel_err(nhwc(got), expect) <= TOLERANCE[name]


def test_instance_norm_and_adain_layers_match_jax(rng):
    x = rng.normal(size=(2, 6, 6, 4)).astype(np.float32)
    style = rng.normal(size=(2, 8)).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, 4).astype(np.float32), rng.normal(size=4).astype(np.float32)
    norm = M.InstanceNorm(4)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(scale))
        norm.bias.copy_(torch.from_numpy(bias))
    expect = MJ.InstanceNorm().apply({"params": {"scale": scale, "bias": bias}}, jnp.asarray(x))
    assert rel_err(nhwc(norm(nchw(x))), expect) <= 1e-5

    adain_j = MJ.AdaIN(4)
    variables = adain_j.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(style))
    adain = M.AdaIN(4, 8)
    fc = variables["params"]["fc"]
    adain.load_state_dict({"fc.layers.conv.weight": torch.from_numpy(np.array(fc["kernel"]).T),
                           "fc.layers.conv.bias": torch.from_numpy(np.array(fc["bias"]))})
    expect = adain_j.apply(variables, jnp.asarray(x), jnp.asarray(style))
    assert rel_err(nhwc(adain(nchw(x), torch.from_numpy(style))), expect) <= 1e-5


@pytest.mark.parametrize("order,norm,pad", [("CNA", "instance", 1), ("NAC", "instance", 2),
                                            ("CNA", "none", 0), ("NAC", "adaptive", 1)])
def test_conv_block_orders_match_jax(rng, order, norm, pad):
    x = rng.normal(size=(2, 9, 9, 4)).astype(np.float32)
    style = rng.normal(size=(2, 16)).astype(np.float32)
    block_j = MJ.ConvBlock(6, 3, 1, pad, order=order, norm=norm)
    variables = block_j.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(style))
    p = jax.tree.map(np.array, variables["params"])
    block = M.ConvBlock(4, 6, 3, 1, pad, order, norm, style_dim=16)
    sd = {"layers.conv.weight": torch.from_numpy(p["conv"]["kernel"].transpose(3, 2, 0, 1).copy()),
          "layers.conv.bias": torch.from_numpy(p["conv"]["bias"])}
    if norm == "instance":
        sd.update({"layers.norm.weight": torch.from_numpy(p["norm"]["scale"]),
                   "layers.norm.bias": torch.from_numpy(p["norm"]["bias"])})
    elif norm == "adaptive":
        sd.update({"layers.norm.fc.layers.conv.weight": torch.from_numpy(p["norm"]["fc"]["kernel"].T.copy()),
                   "layers.norm.fc.layers.conv.bias": torch.from_numpy(p["norm"]["fc"]["bias"])})
    block.load_state_dict(sd, strict=True)
    expect = block_j.apply(variables, jnp.asarray(x), jnp.asarray(style))
    with torch.no_grad():
        got = block(nchw(x), torch.from_numpy(style))
    assert rel_err(nhwc(got), expect) <= 1e-5


@pytest.mark.parametrize("order", ["NACNAC", "CNACNA"])
def test_res_block_matches_jax(rng, order):
    x = rng.normal(size=(1, 6, 6, 4)).astype(np.float32)
    block_j = MJ.ResBlock(4, order=order, norm="instance")
    variables = block_j.init(jax.random.PRNGKey(3), jnp.asarray(x))
    p = jax.tree.map(np.array, variables["params"])
    block = M.ResBlock(4, order, "instance")
    sd = {}
    for b in (0, 1):
        cb = p[f"conv_block_{b}"]
        sd[f"conv_block_{b}.layers.conv.weight"] = torch.from_numpy(
            cb["conv"]["kernel"].transpose(3, 2, 0, 1).copy())
        sd[f"conv_block_{b}.layers.conv.bias"] = torch.from_numpy(cb["conv"]["bias"])
        sd[f"conv_block_{b}.layers.norm.weight"] = torch.from_numpy(cb["norm"]["scale"])
        sd[f"conv_block_{b}.layers.norm.bias"] = torch.from_numpy(cb["norm"]["bias"])
    block.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = block(nchw(x))
    assert rel_err(nhwc(got), block_j.apply(variables, jnp.asarray(x))) <= 1e-5


def test_nearest_upsample_matches_jax(rng):
    x = rng.normal(size=(2, 3, 5, 4)).astype(np.float32)
    np.testing.assert_array_equal(nhwc(M.nearest_upsample(nchw(x), 2)).numpy(),
                                  np.asarray(MJ.nearest_upsample(jnp.asarray(x), 2)))


# ---------------------------------------------------------------------------
# The generator, float32 and bfloat16
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("part", ["style_encoder", "content_encoder", "mlp", "decoder"])
def test_generator_parts_match_jax(generators, part):
    s = generators
    model_j = MJ.AutoEncoder(SMALL_J, s["gen_j"].dtype)
    x, style = jnp.asarray(s["images"]), jnp.asarray(s["style"])
    vec = model_j.apply(s["gen_j"].variables_a, style, method=lambda m, v: m.mlp(v))
    content = model_j.apply(s["gen_j"].variables_a, x, method=lambda m, i: m.content_encoder(i))
    ae = s["ae"]
    with torch.no_grad():
        if part == "style_encoder":
            expect = model_j.apply(s["gen_j"].variables_a, x, method=lambda m, i: m.style_encoder(i))
            got = ae.style_encoder(nchw(s["images"]))
        elif part == "content_encoder":
            expect, got = content, nhwc(ae.content_encoder(nchw(s["images"])))
        elif part == "mlp":
            expect, got = vec, ae.mlp(torch.from_numpy(s["style"]))
        else:
            expect = model_j.apply(s["gen_j"].variables_a, content, vec,
                                   method=lambda m, c, v: m.decoder(c, v))
            got = nhwc(ae.decoder(nchw(content), torch.from_numpy(np.asarray(vec))))
    assert got.dtype == torch.float32 and expect.dtype == jnp.float32
    assert rel_err(got, expect) <= TOLERANCE[s["name"]], part


def test_encode_decode_both_domains_match_jax(generators):
    s = generators
    gen = M.MunitGenerator(SMALL, s["dtype"])
    gen.autoencoder_a = s["ae"]
    gen.autoencoder_b = _carry(s["gen_j"].variables_b, s["dtype"])
    x, style = s["images"], s["style"]
    tol = TOLERANCE[s["name"]]
    for encode, decode, encode_j, decode_j in [
            (gen.encode_a, gen.decode_a, s["gen_j"].encode_a, s["gen_j"].decode_a),
            (gen.encode_b, gen.decode_b, s["gen_j"].encode_b, s["gen_j"].decode_b)]:
        content_j, style_j = encode_j(jnp.asarray(x))
        with torch.no_grad():
            content, style0 = encode(torch.from_numpy(x))
            image = decode(torch.from_numpy(np.asarray(content_j)), torch.from_numpy(style))
        assert content.shape == content_j.shape == (2, 8, 8, 32)
        assert rel_err(content, content_j) <= tol and rel_err(style0, style_j) <= tol
        assert rel_err(image, decode_j(content_j, jnp.asarray(style))) <= tol


def test_mixed_precision_types_follow_jax(generators):
    """AdaIN projections, the style MLP, the style head and the output conv
    are float32 whatever the compute type; the other convolutions hold it;
    content, style and image come out float32 as in the JAX package."""
    s = generators
    ae, dtype = s["ae"], s["dtype"]
    float32_keys = ("norm.fc.", "mlp.", "style_encoder.model.5.", "decoder.decoder.7.",
                    ".layers.norm.")
    for name, p in ae.named_parameters():
        expect = torch.float32 if any(k in name for k in float32_keys) else dtype
        assert p.dtype == expect, name
    with torch.no_grad():
        content, style = ae.encode(torch.from_numpy(s["images"]))
        image = ae.decode(content, style)
    assert content.dtype == style.dtype == image.dtype == torch.float32


def test_create_generator_shipped_width_shapes():
    """The shipped width (yaml:54-67) on a 64 px image: content (8, 8, 256),
    an 8-dim style, the image back at 64 px; a different style changes it."""
    gen = M.create_generator(torch.Generator().manual_seed(0))
    x = torch.rand((1, 64, 64, 3), generator=torch.Generator().manual_seed(1)) * 2 - 1
    with torch.no_grad():
        content, style = gen.encode_a(x)
        out = gen.decode_a(content, style)
        out2 = gen.decode_a(content, style + 1.0)
    assert content.shape == (1, 8, 8, 256) and style.shape == (1, 8)
    assert out.shape == (1, 64, 64, 3) and torch.isfinite(out).all()
    assert not torch.allclose(out, out2)
    assert not any(p.requires_grad for p in gen.parameters())


# ---------------------------------------------------------------------------
# The checkpoint reader
# ---------------------------------------------------------------------------


def _spectral_twin(seed):
    """The torch twin (imaginaire keys) with spectral norm on every conv and
    linear layer, its u and v moved by a few power iterations."""
    import torch_twin as TT

    torch.manual_seed(seed)
    twin = TT.TorchMunitAutoEncoder(nf=8, max_nf=32, nf_mlp=16, latent=8, res=2, d_style=3,
                                    d_content=2, mlp_blocks=2)
    targets = [m for name, m in twin.named_modules() if name.endswith("layers.conv")]
    for m in targets:
        torch.nn.utils.spectral_norm(m)
    x = torch.rand(1, 3, 32, 32) * 2 - 1
    with torch.no_grad():
        for _ in range(3):
            c, s = twin.encode(x)
            twin.decode(c, s)
    return twin.eval()


def test_munit_checkpoint_reader_matches_twin_and_jax(tmp_path, rng):
    from rgie_tpu.utils import torch_convert as TC
    from rgie_tpu_torch.utils.checkpoint import load_munit_checkpoint

    twin_a, twin_b = _spectral_twin(0), _spectral_twin(1)
    sd_a, sd_b = twin_a.state_dict(), twin_b.state_dict()
    assert any(k.endswith("weight_orig") for k in sd_a) and any(k.endswith("weight_v") for k in sd_a)
    net_g = {**{f"module.autoencoder_a.{k}": v for k, v in sd_a.items()},
             **{f"module.autoencoder_b.{k}": v for k, v in sd_b.items()},
             "module.averaged_model.autoencoder_a.mlp.model.0.layers.conv.bias": torch.zeros(16)}
    path = tmp_path / "munit.pt"
    torch.save({"net_G": net_g}, path)
    gen, dis = load_munit_checkpoint(str(path), SMALL, weight_dis=0.1)
    assert dis is None   # no net_D in this checkpoint

    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    style = rng.normal(size=(2, 8)).astype(np.float32)
    with torch.no_grad():
        content, style0 = gen.encode(torch.from_numpy(x))
        image = gen.decode(content, torch.from_numpy(style))
        content_t, style_t = twin_a.encode(nchw(x))
        image_t = twin_a.decode(content_t, torch.from_numpy(style))
    assert rel_err(content, nhwc(content_t)) <= 1e-5 and rel_err(style0, style_t) <= 1e-5
    assert rel_err(image, nhwc(image_t)) <= 1e-5

    numpy_sd = {k.replace("module.", ""): v.numpy() for k, v in net_g.items()
                if "averaged_model" not in k}
    variables = jax.tree.map(jnp.asarray, TC.convert_munit_autoencoder(
        numpy_sd, "a", num_downsamples_content=2, num_downsamples_style=3, num_res_blocks=2))
    gen_j = MJ.MunitGenerator(variables_a=variables, variables_b=variables, cfg=SMALL_J)
    content_j, style_j = gen_j.encode_a(jnp.asarray(x))
    assert rel_err(content, content_j) <= 1e-5 and rel_err(style0, style_j) <= 1e-5
    assert rel_err(image, gen_j.decode_a(content_j, jnp.asarray(style))) <= 1e-5


def test_realize_spectral_norm_matches_jax_converter(rng):
    from rgie_tpu.utils import torch_convert as TC
    from rgie_tpu_torch.utils.checkpoint import realize_spectral_norm

    w = rng.normal(size=(6, 4, 3, 3)).astype(np.float32)
    u, v = rng.normal(size=6).astype(np.float32), rng.normal(size=36).astype(np.float32)
    for vv in (v, None):
        got = realize_spectral_norm(torch.from_numpy(w), torch.from_numpy(u),
                                    None if vv is None else torch.from_numpy(vv))
        np.testing.assert_allclose(got.numpy(), TC.realize_spectral_norm(w, u, vv), rtol=1e-5,
                                   atol=1e-6)
