"""The compute type of the frozen models on the CPU: the port's bfloat16
ResNet-50 regressor, CLIP image encoder and parametric objective against the
JAX package's at ``dtype=jnp.bfloat16``, with the same float32 weights
(rounded by each package where it computes); and the bench's measurement at
a tiny size. The float32 tests (tests/test_torch_models.py,
tests/test_torch_param_edit.py) are unchanged.

bfloat16 tolerances. Both packages round to 8 significant bits at the same
points (the Flax compute type's cast points, mirrored by the port), so they
differ where a float32 sum lands on the other side of a rounding boundary:
one step of the grid, 2^-8 of a value, passed on by the following layers.
Outputs are held to 2^-5 of their largest entry (eight steps of the grid),
as in tests/test_torch_munit.py.

The parametric objective is held term by term at a vector away from the
identity, the VA term and the CLIP term each with its own weight 1:
* values: the VA term within 2^-3 of JAX's (one step of the bfloat16 grid
  of the predictions moves a term of 0.018 by ~9 %; reading 0), the CLIP
  term 1 - cos, a value on bfloat16's grid of 2^-8, within two steps of it
  (2^-7; readings 0 and one step), the objective within the weighted sum of
  the two (reading one step of 2^-8 at 8.1e-3). Each holds at least one
  image whose term is 4 times its tolerance, so that a term left out fails;
* gradients: JAX's float32 gradient of the same rounded weights is the
  reference. In bfloat16 a gradient that is small against the per-pixel
  terms it sums is mostly rounding noise: JAX's own VA gradient is 1.53 of
  the reference's norm away from it at image 0. The port's may be no farther from the reference than
  JAX's is, plus a quarter of the reference's norm (readings, port against
  JAX: VA 0.38 / 1.53 and 0.081 / 0.097, CLIP 0.013 / 0.011 and
  0.042 / 0.025, objective 0.012 / 0.013 and 0.043 / 0.026).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgie_tpu.utils import torch_convert as TC
from rgie_tpu_torch.models import clip as CL
from rgie_tpu_torch.models import emotion as E
from rgie_tpu_torch.ops import geometry as G

torch.set_num_threads(2)

SIZE, VA_CROP = 64, 56
CLIP_SMALL = dict(width=64, layers=2, heads=2, patch_size=16, input_resolution=64, output_dim=32)
BF16_TOLERANCE = 2.0 ** -5
VA_RTOL, CLIP_ATOL = 2.0 ** -3, 2.0 ** -7
GRAD_SLACK = 0.25


def rel_err(got, expect):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    expect = np.asarray(expect, np.float32)
    return float(np.abs(got - expect).max() / np.abs(expect).max())


@pytest.fixture(scope="module")
def models():
    """The full ResNet-50 regressor at 64/56 and a narrow CLIP, float32
    weights from a seed, in both packages at bfloat16; and JAX's at float32
    holding the bfloat16-rounded weights."""
    from rgie_tpu.losses.emotion_loss import ValenceArousalLoss as VAJ
    from rgie_tpu.models.clip import ClipImageEncoder, VisionTransformer
    from rgie_tpu.models.emotion import EmotionRegressor
    from rgie_tpu_torch.losses.emotion_loss import ValenceArousalLoss

    g = torch.Generator().manual_seed(0)
    reg32 = E.create_regressor(g, input_size=SIZE, crop_size=VA_CROP)
    with torch.no_grad():
        for m in reg32.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g) * 0.05)
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) * 0.4 + 0.8)
    reg = E.create_regressor(torch.Generator(), input_size=SIZE, crop_size=VA_CROP,
                             dtype=torch.bfloat16)
    reg.load_state_dict(reg32.state_dict())
    enc32 = CL.create_clip_image_encoder(g, **CLIP_SMALL)
    enc = CL.create_clip_image_encoder(torch.Generator(), dtype=torch.bfloat16, **CLIP_SMALL)
    enc.load_state_dict(enc32.state_dict())

    reg_r = E.create_regressor(torch.Generator(), input_size=SIZE, crop_size=VA_CROP)
    reg_r.load_state_dict(reg.state_dict())
    enc_r = CL.create_clip_image_encoder(torch.Generator(), **CLIP_SMALL)
    enc_r.load_state_dict(enc.state_dict())

    reg_j = EmotionRegressor(
        variables=jax.tree.map(jnp.asarray, TC.convert_resnet50(reg32.net.state_dict())),
        input_size=SIZE, crop_size=VA_CROP, dtype=jnp.bfloat16)
    params = TC.convert_clip_visual({k: v.numpy() for k, v in enc32.model.state_dict().items()},
                                    layers=2, heads=2, width=64)
    params = jax.tree.map(jnp.asarray, params)
    # Flax creates these four in the compute type (rgie_tpu/models/clip.py:79-97)
    for name in ("conv1_kernel", "class_embedding", "positional_embedding", "proj"):
        params["params"][name] = params["params"][name].astype(jnp.bfloat16)
    enc_j = ClipImageEncoder(variables=params,
                             model=VisionTransformer(dtype=jnp.bfloat16, **CLIP_SMALL))
    params_r = TC.convert_clip_visual({k: v.numpy() for k, v in enc_r.model.state_dict().items()},
                                      layers=2, heads=2, width=64)
    rounded_j = dict(
        va_j=VAJ(regressor=EmotionRegressor(
            variables=jax.tree.map(jnp.asarray, TC.convert_resnet50(reg_r.net.state_dict())),
            input_size=SIZE, crop_size=VA_CROP)),
        enc_j=ClipImageEncoder(variables=jax.tree.map(jnp.asarray, params_r),
                               model=VisionTransformer(**CLIP_SMALL)))
    return dict(reg=reg, enc=enc, reg_j=reg_j, enc_j=enc_j, va=ValenceArousalLoss(reg),
                va_j=VAJ(regressor=reg_j), rounded_j=rounded_j)


def test_weights_round_where_flax_computes(models):
    """Convolutions, dense layers, embeddings and the projection hold
    bfloat16; BatchNorm and LayerNorm keep float32, as Flax's parameters
    stay float32 there."""
    for name, p in models["reg"].named_parameters():
        expect = torch.float32 if ".bn" in name or "downsample.1" in name else torch.bfloat16
        assert p.dtype == expect, name
    for name, p in models["enc"].named_parameters():
        expect = torch.float32 if ".ln_" in f".{name}" else torch.bfloat16
        assert p.dtype == expect, name


@pytest.mark.parametrize("shape", [(2, 64, 64, 3), (1, 72, 80, 3)])
def test_regressor_bf16_matches_jax(rng, models, shape):
    x = rng.uniform(0, 1, shape).astype(np.float32)
    got = models["reg"](torch.from_numpy(x))
    expect = models["reg_j"](jnp.asarray(x))
    assert got.dtype == torch.bfloat16 and expect.dtype == jnp.bfloat16
    assert rel_err(got, expect) <= BF16_TOLERANCE


def test_clip_bf16_matches_jax(rng, models):
    x = rng.uniform(0, 1, (2, 80, 80, 3)).astype(np.float32)
    with torch.no_grad():
        got = models["enc"](torch.from_numpy(x))
        normed = models["enc"].embed_normalized(torch.from_numpy(x))
    expect = models["enc_j"](jnp.asarray(x))
    assert got.dtype == torch.bfloat16 and expect.dtype == jnp.bfloat16
    assert rel_err(got, expect) <= BF16_TOLERANCE
    assert rel_err(normed, models["enc_j"].embed_normalized(jnp.asarray(x))) <= BF16_TOLERANCE


def test_resize_of_bfloat16_matches_jax(rng):
    """The regressor's resize of a bfloat16 image on the CPU (antialiased:
    in float32, rounded once, as PyTorch's CPU has no bfloat16 antialiased
    kernel) and the plain bfloat16 resize, against JAX's, whose weights are
    bfloat16: at most one step of the grid apart."""
    from rgie_tpu.ops import geometry as G_j

    x = rng.uniform(0, 1, (2, 40, 50, 3)).astype(np.float32)
    for size, antialias in [((64, 80), True), ((20, 25), True), ((32, 32), False)]:
        image = torch.from_numpy(x).to(torch.bfloat16)
        got = G.resize(image.float() if antialias else image, size,
                       antialias=antialias).to(torch.bfloat16)
        expect = G_j.resize(jnp.asarray(x, jnp.bfloat16), size, antialias=antialias)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(expect, np.float32),
                                   rtol=0, atol=2.0 ** -8)


def test_parametric_objective_bf16_matches_jax(rng, models):
    """One value-and-grad step of the parametric objective at a vector away
    from the identity, the models in bfloat16 and the 41 parameters in
    float32: the VA term and the CLIP term separately (each weight 1, the
    other 0) and the objective at the bench's weights. Values against JAX's
    (a term left out would be 100 % off); gradients against JAX's float32
    gradient of the rounded weights, no farther from it than JAX's bfloat16
    gradient is, plus a quarter of its norm (module docstring)."""
    from rgie_tpu.config import OptimizeConfig as OptimizeConfigJ
    from rgie_tpu.config import ParamEditConfig as ParamEditConfigJ
    from rgie_tpu.engine import parametric as P_j
    from rgie_tpu_torch.config import OptimizeConfig, ParamEditConfig
    from rgie_tpu_torch.engine import parametric as P
    from rgie_tpu_torch.ops import chain as CH

    images = rng.uniform(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    alphas = np.asarray([[0.2, 0.2], [-0.1, 0.1]], np.float32)
    x = np.asarray(CH.pack_params(CH.init_params()), np.float32)
    x = np.stack([x, x]) + rng.uniform(-0.1, 0.1, (2, x.shape[0])).astype(np.float32)
    opt = dict(num_steps=1, learning_rate=0.05)
    edit_models = P.EditModels(va_loss=models["va"], clip=models["enc"])
    bench = ParamEditConfig(optimize=OptimizeConfig(**opt), input_size=SIZE, crop_size=SIZE)

    def port(weight_clf, weight_recon):
        cfg = ParamEditConfig(optimize=OptimizeConfig(**opt), input_size=SIZE, crop_size=SIZE,
                              weight_clf=weight_clf, weight_recon=weight_recon)
        ctx = P.make_context(edit_models, cfg, torch.from_numpy(images),
                             torch.from_numpy(alphas))
        v = torch.from_numpy(x).requires_grad_(True)
        loss = P.make_objective(edit_models, cfg)(v, ctx)
        loss.sum().backward()
        assert loss.dtype == torch.float32 and v.grad.dtype == torch.float32
        return loss.detach().double().numpy(), v.grad.double().numpy()

    def jax_side(weight_clf, weight_recon, va_j=models["va_j"], enc_j=models["enc_j"]):
        cfg_j = ParamEditConfigJ(optimize=OptimizeConfigJ(**opt), input_size=SIZE,
                                 crop_size=SIZE, weight_clf=weight_clf,
                                 weight_recon=weight_recon)
        objective_j = P_j.make_objective(va_j, enc_j, cfg_j)
        models_j = P_j.models_of(va_j, enc_j)

        def one(image, alpha, v):
            image = image[None]
            target = jnp.clip(va_j.predict_loss_metric(image) + alpha, 0.0, 1.0)
            ctx = P_j.EditContext(image=image, target=target,
                                  clip_features=enc_j.embed_normalized(image))
            return jax.value_and_grad(objective_j)(v, ctx, models_j)

        loss, grad = jax.jit(jax.vmap(one))(jnp.asarray(images), jnp.asarray(alphas),
                                            jnp.asarray(x))
        assert loss.dtype == grad.dtype == jnp.float32
        return np.asarray(loss, np.float64), np.asarray(grad, np.float64)

    weights = {"VA": (1.0, 0.0), "CLIP": (0.0, 1.0),
               "objective": (bench.weight_clf, bench.weight_recon)}
    got = {term: port(*w) for term, w in weights.items()}
    expect = {"VA": jax_side(1.0, 0.0), "CLIP": jax_side(0.0, 1.0)}
    expect["objective"] = tuple(bench.weight_clf * va + bench.weight_recon * cl
                                for va, cl in zip(expect["VA"], expect["CLIP"]))
    reference = {"VA": jax_side(1.0, 0.0, **models["rounded_j"])[1],
                 "CLIP": jax_side(0.0, 1.0, **models["rounded_j"])[1]}
    reference["objective"] = (bench.weight_clf * reference["VA"]
                              + bench.weight_recon * reference["CLIP"])
    va_tol = VA_RTOL * np.abs(expect["VA"][0])
    tolerance = {"VA": va_tol, "CLIP": CLIP_ATOL,
                 "objective": bench.weight_clf * va_tol + bench.weight_recon * CLIP_ATOL}
    for term, (loss, grad) in got.items():
        loss_j, grad_j = expect[term]
        assert (np.abs(loss_j) > 4 * tolerance[term]).any(), term
        assert (np.abs(loss - loss_j) <= tolerance[term]).all(), (term, loss, loss_j)
        assert np.isfinite(grad).all(), term
        norm = np.linalg.norm(reference[term], axis=-1)
        dist = np.linalg.norm(grad - reference[term], axis=-1) / norm
        dist_j = np.linalg.norm(grad_j - reference[term], axis=-1) / norm
        assert (dist <= dist_j + GRAD_SLACK).all(), (term, dist, dist_j)


def test_bench_run_on_cpu(models):
    """bench.run at a tiny size on the CPU: the row's fields, device figures
    null, the parameters and the losses float32."""
    from rgie_tpu_torch.cli import bench
    from rgie_tpu_torch.config import OptimizeConfig, ParamEditConfig
    from rgie_tpu_torch.engine import parametric as P

    cfg = ParamEditConfig(optimize=OptimizeConfig(num_steps=2, learning_rate=0.05),
                          input_size=SIZE, crop_size=SIZE)
    images = torch.rand((2, SIZE, SIZE, 3), generator=torch.Generator().manual_seed(1))
    alphas = torch.full((2, 2), 0.1)
    row, result, edited = bench.run(P.EditModels(va_loss=models["va"], clip=models["enc"]),
                                    cfg, images, alphas, runs=1)
    d = row["detail"]
    assert set(d) >= {"batch", "edit_seconds", "per_step_ms_batched", "dtype", "remat",
                      "achieved_tflops", "mfu_pct", "device", "power_limit", "torch", "cuda",
                      "peak_memory_gib", "step_tflop"}
    assert row["value"] == pytest.approx(2 / d["edit_seconds"])
    assert d["dtype"] == "bfloat16" and d["device"] == "cpu" and d["mfu_pct"] is None
    assert d["step_tflop"] > 0
    assert result.losses.dtype == torch.float32 and torch.isfinite(result.losses).all()
    assert float(edited.min()) >= 0.0 and float(edited.max()) <= 1.0


def test_bench_profile_runs_the_counted_step(models, monkeypatch, capsys):
    """``bench --profile`` hands the profiler the objective step whose FLOPs
    the bench counts (the profiler itself needs CUDA: stubbed)."""
    from rgie_tpu_torch.cli import bench, profile_adapt_images
    from rgie_tpu_torch.config import OptimizeConfig, ParamEditConfig
    from rgie_tpu_torch.engine import parametric as P

    cfg = ParamEditConfig(optimize=OptimizeConfig(num_steps=2, learning_rate=0.05),
                          input_size=SIZE, crop_size=SIZE)
    edit_models = P.EditModels(va_loss=models["va"], clip=models["enc"])
    images = torch.rand((2, SIZE, SIZE, 3), generator=torch.Generator().manual_seed(1))
    alphas = torch.full((2, 2), 0.1)
    monkeypatch.setattr(bench, "build", lambda *a: (edit_models, cfg, images, alphas))
    profiled = []
    monkeypatch.setattr(profile_adapt_images, "profile_phase",
                        lambda what, step, **kw: profiled.append((what, bench.step_flops(step),
                                                                  kw)))
    bench.main(["--profile", "--device", "cpu", "--batch", "2"])
    expect = bench.step_flops(bench.objective_step(edit_models, cfg, images, alphas))
    assert profiled == [("parametric objective step (256 px, batch 2, bfloat16)", expect,
                         {"top": 12, "logdir": None})]
    assert expect > 0 and "{" not in capsys.readouterr().out     # no JSON row


@pytest.mark.parametrize("module", ["bench", "bench_gan"])
def test_bench_clis_refuse_without_cuda(monkeypatch, module):
    import importlib

    cli = importlib.import_module(f"rgie_tpu_torch.cli.{module}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main([])
