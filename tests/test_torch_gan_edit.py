"""The GAN slice on the CPU: the port's GAN losses, MUNIT patch discriminator,
style-code objective and batched edit against the JAX package's
(rgie_tpu.losses.gan, models.discriminators, engine.gan) with shared weights,
in float32 and bfloat16; the batched edit's rows against single-image edits;
bench_gan's measurement at a tiny size; and the CLI on a tiny feed.

Tolerances. The style gradient sums many per-pixel terms that largely
cancel: each package's float32 gradient is 2.0e-3 of its largest entry from
its float64 one, while the two float32 gradients, which round at the same
points, are 9.0e-5 apart and the two float64 ones 7.1e-7 (JAX's output conv
stays float32). Adam's ratio of moments carries such differences on where
the moments cancel: after 4 steps of lr 0.05 the best styles differ by
3.4e-4, held to 1e-3; the loss curves to rtol 1e-3. bfloat16 objective
values are held to 2^-5, as the generator's outputs are in
tests/test_torch_munit.py: both packages round at the same points, so they
differ by single roundings that land on the other side of a boundary (2^-8
of a value) and the layers pass on. A bfloat16 style gradient is mostly
rounding noise (each package's is about half its norm from the float32
gradient of the same rounded weights), so it is held to be no noisier than
JAX's.
"""

import copy
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgie_tpu.config import GanEditConfig as GanEditConfigJ
from rgie_tpu.config import MunitGenConfig as MunitGenConfigJ
from rgie_tpu.config import OptimizeConfig as OptimizeConfigJ
from rgie_tpu.utils import torch_convert as TC
from rgie_tpu_torch.config import GanEditConfig, MunitGenConfig, OptimizeConfig
from rgie_tpu_torch.engine import gan as GE
from rgie_tpu_torch.losses.gan import gan_loss
from rgie_tpu_torch.models import discriminators as D
from rgie_tpu_torch.models.init import freeze_
from rgie_tpu_torch.utils import from_jax as FJ

torch.set_num_threads(2)

SIZE, VA_SIZE, VA_CROP, STEPS = 48, 64, 56, 4
SMALL_KW = dict(num_filters=8, max_num_filters=32, num_filters_mlp=16, num_res_blocks=2,
                num_downsamples_style=3, num_downsamples_content=2)
DIS_KW = dict(num_filters=8, num_layers=3, max_num_filters=32)
BF16_TOLERANCE = 2.0 ** -5


def rel_err(got, expect):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    expect = np.asarray(expect, np.float32)
    return float(np.abs(got - expect).max() / np.abs(expect).max())


# ---------------------------------------------------------------------------
# GAN losses and the patch discriminator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,t_real,dis_update,k", [
    ("hinge", True, True, 1.0), ("hinge", False, True, 1.0), ("hinge", True, False, 1.0),
    ("hinge", True, False, 0.3), ("non_saturated", True, True, 1.0),
    ("non_saturated", False, True, 1.0), ("softplus", True, False, 0.5),
    ("least_square", True, True, 1.0), ("least_square", False, True, 1.0),
    ("wasserstein", True, True, 1.0), ("wasserstein", False, True, 1.0),
    ("wasserstein", True, False, 0.25)])
def test_gan_loss_matches_jax(rng, mode, t_real, dis_update, k):
    from rgie_tpu.losses.gan import gan_loss as gan_loss_j

    outs = [rng.normal(size=(2, s, s, 1)).astype(np.float32) for s in (6, 3)]
    outs[0][0, 0, 0, 0] = 0.0          # a tie at every kink
    kw = dict(gan_mode=mode, dis_update=dis_update, real_label=0.9, fake_label=0.1, k=k)

    def value_j(xs):
        return gan_loss_j(list(xs), t_real, **kw)

    expect, grads_j = jax.value_and_grad(value_j)(tuple(jnp.asarray(o) for o in outs))
    xs = [torch.from_numpy(o).requires_grad_(True) for o in outs]
    got = gan_loss(xs, t_real, **kw)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(expect), rtol=1e-6, atol=1e-7)
    for x, g in zip(xs, grads_j):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), rtol=1e-6, atol=1e-7)
    per_scale = gan_loss([torch.from_numpy(o) for o in outs], t_real, reduce=False, **kw)
    per_scale_j = gan_loss_j([jnp.asarray(o) for o in outs], t_real, reduce=False, **kw)
    np.testing.assert_allclose([float(v) for v in per_scale], [float(v) for v in per_scale_j],
                               rtol=1e-6, atol=1e-7)
    single = gan_loss(torch.from_numpy(outs[1]), t_real, **kw)
    np.testing.assert_allclose(float(single), float(gan_loss_j(jnp.asarray(outs[1]), t_real, **kw)),
                               rtol=1e-6, atol=1e-7)


def test_generator_update_needs_a_real_target():
    with pytest.raises(ValueError, match="real"):
        gan_loss(torch.zeros(2), False, dis_update=False)


@pytest.mark.parametrize("shape", [(2, 48, 48, 3), (1, 13, 10, 2), (1, 3, 2, 1)])
def test_bilinear_half_matches_jax(rng, shape):
    from rgie_tpu.models.discriminators import bilinear_half as bilinear_half_j

    x = rng.normal(size=shape).astype(np.float32)
    np.testing.assert_allclose(D.bilinear_half(torch.from_numpy(x)).numpy(),
                               np.asarray(bilinear_half_j(jnp.asarray(x))), rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def discriminators():
    from rgie_tpu.models.discriminators import MultiResPatchDiscriminator as MRJ

    dis_j = MRJ(**DIS_KW)
    variables = jax.jit(dis_j.init)(jax.random.PRNGKey(5), jnp.zeros((1, SIZE, SIZE, 3)))
    dis = D.MultiResPatchDiscriminator(**DIS_KW)
    dis.load_state_dict(FJ.multires_patch_discriminator_state_dict(
        jax.tree.map(np.asarray, variables), num_layers=DIS_KW["num_layers"]), strict=True)
    return freeze_(dis), dis_j, variables


def test_multires_patch_discriminator_matches_jax(rng, discriminators):
    dis, dis_j, variables = discriminators
    x = rng.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    outs_j, feats_j, inputs_j = jax.jit(dis_j.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        outs, feats, inputs = dis(torch.from_numpy(x))
    assert len(outs) == len(outs_j) == 3
    for o, o_j, fs, fs_j, i, i_j in zip(outs, outs_j, feats, feats_j, inputs, inputs_j):
        assert o.shape == o_j.shape and len(fs) == len(fs_j) == 4
        assert rel_err(o, o_j) <= 1e-5 and rel_err(i, i_j) <= 1e-5
        for f, f_j in zip(fs, fs_j):
            assert rel_err(f, f_j) <= 1e-5


def test_discriminator_reader_folds_spectral_norm(tmp_path, rng):
    """A net_D with spectral norm on every conv loads through the MUNIT
    checkpoint reader into the plain module, which then equals the
    spectral-normed module and the JAX module through
    convert_multires_patch_discriminator."""
    from rgie_tpu.models.discriminators import MultiResPatchDiscriminator as MRJ
    from rgie_tpu_torch.models.munit import create_generator
    from rgie_tpu_torch.utils.checkpoint import load_munit_checkpoint

    torch.manual_seed(0)
    sn = D.MultiResPatchDiscriminator(num_discriminators=2)   # the shipped widths
    for name, m in list(sn.named_modules()):
        if name.endswith("layers.conv"):
            torch.nn.utils.spectral_norm(m)
    x = torch.rand(1, SIZE, SIZE, 3) * 2 - 1
    with torch.no_grad():
        sn(x)          # one power iteration moves u and v
    sn.eval()
    cfg = MunitGenConfig(**SMALL_KW)
    gen = create_generator(torch.Generator().manual_seed(0), cfg)
    torch.save({"net_G": gen.state_dict(),
                "net_D": {f"module.discriminator_a.{k}": v for k, v in sn.state_dict().items()}},
               tmp_path / "munit.pt")
    _, none = load_munit_checkpoint(str(tmp_path / "munit.pt"), cfg, 0.0)
    assert none is None
    _, dis = load_munit_checkpoint(str(tmp_path / "munit.pt"), cfg, 0.1)
    assert len(dis.discriminators) == 2
    x = rng.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    with torch.no_grad():
        outs, _, _ = dis(torch.from_numpy(x))
        outs_sn, _, _ = sn(torch.from_numpy(x))
    variables = TC.convert_multires_patch_discriminator(
        {f"discriminator_a.{k}": v.numpy() for k, v in sn.state_dict().items()}, "a")
    outs_j, _, _ = jax.jit(MRJ(num_discriminators=2).apply)(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(x))
    for o, o_sn, o_j in zip(outs, outs_sn, outs_j):
        assert rel_err(o, o_sn) <= 1e-5 and rel_err(o, o_j) <= 1e-5


# ---------------------------------------------------------------------------
# The objective and the edit
# ---------------------------------------------------------------------------


def _randomize_bn(module, g):
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g) * 0.05)
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) * 0.4 + 0.8)
    return module


@pytest.fixture(scope="module")
def stacks(discriminators):
    """The SMALL MUNIT (JAX weights), the full ResNet-50 regressor at 64/56 on
    [-1, 1] images (port weights) and the patch discriminator, in both
    packages; two images and their alphas."""
    from rgie_tpu.engine import gan as GE_j
    from rgie_tpu.losses.emotion_loss import ValenceArousalLoss as VAJ
    from rgie_tpu.models.emotion import EmotionRegressor as ERJ
    from rgie_tpu.models import munit as MJ
    from rgie_tpu_torch.losses.emotion_loss import ValenceArousalLoss
    from rgie_tpu_torch.models.emotion import create_regressor
    from rgie_tpu_torch.models.munit import AutoEncoder

    g = torch.Generator().manual_seed(0)
    reg = _randomize_bn(create_regressor(g, normalize=False, input_size=VA_SIZE,
                                         crop_size=VA_CROP), g)
    reg_vars = jax.tree.map(jnp.asarray, TC.convert_resnet50(reg.net.state_dict()))
    out = dict(GE_j=GE_j, reg=reg, reg_vars=reg_vars)
    cfg = MunitGenConfig(**SMALL_KW)
    for name, dtype, dtype_j in [("float32", torch.float32, jnp.float32),
                                 ("bfloat16", torch.bfloat16, jnp.bfloat16)]:
        # create_generator's domain a, its init jitted
        model_j = MJ.AutoEncoder(MunitGenConfigJ(**SMALL_KW), dtype_j)
        variables = jax.jit(model_j.init)(jax.random.split(jax.random.PRNGKey(0))[0],
                                          jnp.zeros((1, SIZE, SIZE, 3)))
        gen_j = MJ.MunitGenerator(variables, variables, MunitGenConfigJ(**SMALL_KW), dtype_j)
        ae = AutoEncoder(cfg, dtype)
        ae.load_state_dict(FJ.munit_state_dict(jax.tree.map(np.asarray, gen_j.variables_a), cfg),
                           strict=True)
        reg_t = create_regressor(torch.Generator(), normalize=False, input_size=VA_SIZE,
                                 crop_size=VA_CROP, dtype=dtype)
        reg_t.load_state_dict(reg.state_dict())
        va_j = VAJ(regressor=ERJ(variables=reg_vars, input_size=VA_SIZE, crop_size=VA_CROP,
                                 normalize=False, dtype=dtype_j))
        out[name] = dict(gen_j=gen_j, va_j=va_j, ae=freeze_(ae),
                         va=ValenceArousalLoss(freeze_(reg_t)))
    dis, dis_j, dis_vars = discriminators
    rng = np.random.default_rng(0)
    out.update(dis=dis, dis_j=dis_j, dis_vars=dis_vars,
               images=rng.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32),
               alphas=np.asarray([[0.2, 0.2], [-0.1, 0.1]], np.float32))
    return out


def _configs(steps, weight_dis=0.0):
    opt = dict(num_steps=steps, learning_rate=0.05)
    kw = dict(input_size=SIZE, crop_size=SIZE, weight_dis=weight_dis)
    return (GanEditConfig(optimize=OptimizeConfig(**opt), **kw),
            GanEditConfigJ(optimize=OptimizeConfigJ(**opt), **kw))


def test_batched_edit_matches_jax(stacks):
    """make_batched_edit for 4 steps, with the discriminator term, against the
    JAX package's vmapped edit: loss curves rtol 1e-3, best style atol 1e-3,
    edited images."""
    s, f = stacks, stacks["float32"]
    cfg, cfg_j = _configs(STEPS, weight_dis=0.1)
    edit_j = jax.jit(s["GE_j"].make_batched_edit(f["gen_j"], f["va_j"], cfg_j, s["dis_j"]))
    res_j, edited_j = edit_j(s["GE_j"].models_of(f["gen_j"], f["va_j"], s["dis_vars"]),
                             jnp.asarray(s["images"]), jnp.asarray(s["alphas"]))
    models = GE.GanEditModels(generator=f["ae"], va_loss=f["va"], dis=s["dis"])
    res, edited = GE.make_batched_edit(models, cfg)(torch.from_numpy(s["images"]),
                                                    torch.from_numpy(s["alphas"]))
    assert res.losses.shape == (2, STEPS) and res.best_x.dtype == torch.float32
    np.testing.assert_allclose(res.losses.numpy(), np.asarray(res_j.losses), rtol=1e-3)
    np.testing.assert_allclose(res.best_x.numpy(), np.asarray(res_j.best_x), rtol=0, atol=1e-3)
    np.testing.assert_array_equal(res.best_step.numpy(), np.asarray(res_j.best_step))
    assert rel_err(edited, edited_j) <= 1e-3
    assert float(edited.abs().max()) <= 1.0
    unit = GE.to_unit_range(edited)
    assert float(unit.min()) >= 0.0 and float(unit.max()) <= 1.0


def _jax_value_and_grad(s, gen_j, va_j, dis_vars, weight_dis, dtype=jnp.float32):
    """The JAX objective and its style gradient per image, at each image's
    own style + 0.3."""
    GE_j = s["GE_j"]
    _, cfg_j = _configs(1, weight_dis)
    objective_j = GE_j.make_objective(gen_j, va_j, cfg_j, s["dis_j"] if weight_dis else None)
    models_j = GE_j.models_of(gen_j, va_j, dis_vars if weight_dis else None)

    def one(image, alpha):
        content, style = gen_j.encode_a(image[None])
        target = jnp.clip(va_j.predict_loss_metric(image[None]) + alpha, 0.0, 1.0)
        ctx = GE_j.GanEditContext(content=content, target=target)
        return jax.value_and_grad(objective_j)(style[0] + 0.3, ctx, models_j)

    loss, grad = jax.jit(jax.vmap(one))(jnp.asarray(s["images"], dtype),
                                        jnp.asarray(s["alphas"], dtype))
    return np.asarray(loss), np.asarray(grad)


def _port_value_and_grad(s, ae, va, weight_dis, dtype=torch.float32):
    models = GE.GanEditModels(generator=ae, va_loss=va, dis=s["dis"] if weight_dis else None)
    if dtype != torch.float32:     # .to() converts a module in place: the fixture's stay
        models = GE.GanEditModels(*(copy.deepcopy(m).to(dtype) for m in models))
    cfg, _ = _configs(1, weight_dis)
    ctx, style0 = GE.make_context(models, torch.from_numpy(s["images"]).to(dtype),
                                  torch.from_numpy(s["alphas"]).to(dtype))
    style = (style0 + 0.3).requires_grad_(True)
    loss = GE.make_objective(models, cfg)(style, ctx)
    loss.sum().backward()
    assert loss.shape == (2,) and loss.dtype == style.grad.dtype == dtype
    assert torch.isfinite(style.grad).all()
    return loss.detach().numpy(), style.grad.numpy()


@pytest.mark.parametrize("name,weight_dis", [("float32", 0.1), ("bfloat16", 0.0)])
def test_objective_matches_jax(stacks, name, weight_dis):
    """One objective value and its style gradient per image away from the
    initial style. float32, with the discriminator term: the value within
    rtol 1e-5, the gradient within 1e-3 of its largest entry (reading
    9.0e-5; each package's float32 gradient is 2.0e-3 from its float64 one,
    test_style_gradient_matches_jax_in_float64). bfloat16, without: the value
    within 2^-5; the gradient against the float32 gradient of the same
    rounded weights, no farther from it than JAX's bfloat16 gradient is,
    plus a quarter of its norm, as in tests/test_torch_models_bf16.py
    (readings 0.72 / 0.58 and 0.50 / 0.48 of the norm, port / JAX)."""
    from rgie_tpu_torch.losses.emotion_loss import ValenceArousalLoss
    from rgie_tpu_torch.models.emotion import create_regressor
    from rgie_tpu_torch.models.munit import AutoEncoder

    s, m = stacks, stacks[name]
    loss_j, grad_j = _jax_value_and_grad(s, m["gen_j"], m["va_j"], s["dis_vars"], weight_dis)
    loss, grad = _port_value_and_grad(s, m["ae"], m["va"], weight_dis)
    if name == "float32":
        np.testing.assert_allclose(loss, loss_j, rtol=1e-5)
        assert rel_err(torch.from_numpy(grad), grad_j) <= 1e-3
        return
    np.testing.assert_allclose(loss, loss_j, rtol=BF16_TOLERANCE)
    ae32 = AutoEncoder(MunitGenConfig(**SMALL_KW))
    ae32.load_state_dict(m["ae"].state_dict())
    reg32 = create_regressor(torch.Generator(), normalize=False, input_size=VA_SIZE,
                             crop_size=VA_CROP)
    reg32.load_state_dict(m["va"].regressor.state_dict())
    _, grad32 = _port_value_and_grad(s, freeze_(ae32), ValenceArousalLoss(freeze_(reg32)),
                                     weight_dis)
    norm = np.linalg.norm(grad32, axis=-1)
    dist = np.linalg.norm(grad - grad32, axis=-1) / norm
    dist_j = np.linalg.norm(grad_j - grad32, axis=-1) / norm
    assert (dist <= dist_j + 0.25).all(), (dist, dist_j)


def test_style_gradient_matches_jax_in_float64(stacks):
    """The float32 objective's weights in float64 in both packages (JAX under
    jax_enable_x64; its output conv stays float32, rgie_tpu/models/munit.py
    :235), the discriminator term on: the style gradient within 2e-6 of its
    largest entry (reading 7.1e-7) and the objective within 1e-8 (3.6e-9).
    The float32 gradient is farther from it than test_objective_matches_jax's
    1e-3 (reading 2.0e-3): float32 rounding alone moves it more than the two
    packages differ."""
    from rgie_tpu.losses.emotion_loss import ValenceArousalLoss as VAJ
    from rgie_tpu.models import munit as MJ
    from rgie_tpu.models.emotion import EmotionRegressor as ERJ

    s, f = stacks, stacks["float32"]
    loss, grad = _port_value_and_grad(s, f["ae"], f["va"], 0.1, torch.float64)
    with jax.enable_x64(True):
        def to64(tree):
            return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)

        gen_j = MJ.MunitGenerator(to64(f["gen_j"].variables_a), to64(f["gen_j"].variables_a),
                                  MunitGenConfigJ(**SMALL_KW), jnp.float64)
        va_j = VAJ(regressor=ERJ(variables=to64(s["reg_vars"]), input_size=VA_SIZE,
                                 crop_size=VA_CROP, normalize=False, dtype=jnp.float64))
        loss_j, grad_j = _jax_value_and_grad(s, gen_j, va_j, to64(s["dis_vars"]), 0.1,
                                             jnp.float64)
    assert loss_j.dtype == grad_j.dtype == np.float64
    np.testing.assert_allclose(loss, loss_j, rtol=1e-8)
    assert float(np.abs(grad - grad_j).max() / np.abs(grad_j).max()) <= 2e-6
    _, grad32 = _port_value_and_grad(s, f["ae"], f["va"], 0.1)
    assert float(np.abs(grad32 - grad).max() / np.abs(grad).max()) > 1e-3


def test_batched_rows_equal_single_image_edits(stacks):
    """The batching trap: with the discriminator term on, each row of a batch
    of 2 equals the single-image edit of that image."""
    s, f = stacks, stacks["float32"]
    cfg, _ = _configs(3, weight_dis=0.1)
    models = GE.GanEditModels(generator=f["ae"], va_loss=f["va"], dis=s["dis"])
    images, alphas = torch.from_numpy(s["images"]), torch.from_numpy(s["alphas"])
    res, edited = GE.make_batched_edit(models, cfg)(images, alphas)
    single = GE.make_single_edit(models, cfg)
    for b in range(2):
        res_b, edited_b = single(images[b:b + 1], s["alphas"][b])
        np.testing.assert_allclose(res.losses[b].numpy(), res_b.losses[0].numpy(), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(res.best_x[b].numpy(), res_b.best_x[0].numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(edited[b].numpy(), edited_b[0].numpy(), rtol=1e-5, atol=1e-5)


def test_remat_objective_equals_plain(stacks):
    s, f = stacks, stacks["float32"]
    cfg, _ = _configs(1)
    models = GE.GanEditModels(generator=f["ae"], va_loss=f["va"])
    ctx, style0 = GE.make_context(models, torch.from_numpy(s["images"]),
                                  torch.from_numpy(s["alphas"]))
    grads = []
    for remat in (False, True):
        style = (style0 + 0.2).requires_grad_(True)
        loss = GE.make_objective(models, dataclasses.replace(cfg, remat=remat))(style, ctx)
        loss.sum().backward()
        grads.append((loss.detach(), style.grad))
    torch.testing.assert_close(grads[0][0], grads[1][0], rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(grads[0][1], grads[1][1], rtol=1e-5, atol=1e-7)


def test_bench_gan_run_on_cpu(stacks):
    from rgie_tpu_torch.cli import bench_gan

    s, m = stacks, stacks["bfloat16"]
    cfg, _ = _configs(2)
    models = GE.GanEditModels(generator=m["ae"], va_loss=m["va"])
    row, result, edited = bench_gan.run(models, cfg, torch.from_numpy(s["images"]),
                                        torch.from_numpy(s["alphas"]), runs=1)
    d = row["detail"]
    assert row["value"] == pytest.approx(2 / d["edit_seconds"])
    assert d["dtype"] == "bfloat16" and d["batch"] == 2 and d["steps"] == 2
    assert d["step_tflop"] > 0 and d["device"] == "cpu"
    assert d["mfu_pct"] is None and d["achieved_tflops"] is None
    assert result.best_x.dtype == torch.float32 and torch.isfinite(edited).all()


def test_bench_gan_profile_runs_the_counted_step(stacks, monkeypatch, capsys):
    """``bench_gan --profile`` hands the profiler the objective step whose
    FLOPs the bench counts (the profiler itself needs CUDA: stubbed)."""
    from rgie_tpu_torch.cli import bench_gan, profile_adapt_images

    s, m = stacks, stacks["bfloat16"]
    cfg, _ = _configs(2)
    models = GE.GanEditModels(generator=m["ae"], va_loss=m["va"])
    images, alphas = torch.from_numpy(s["images"]), torch.from_numpy(s["alphas"])
    monkeypatch.setattr(bench_gan, "build", lambda *a: (models, cfg, images, alphas))
    profiled = []
    monkeypatch.setattr(profile_adapt_images, "profile_phase",
                        lambda what, step, **kw: profiled.append((what, bench_gan.step_flops(step),
                                                                  kw)))
    bench_gan.main(["--profile", "--device", "cpu", "--batch", "2"])
    expect = bench_gan.step_flops(bench_gan.objective_step(models, cfg, images, alphas))
    assert profiled == [("MUNIT objective step (1024 px, batch 2, bfloat16)", expect,
                         {"top": 12, "logdir": None})]
    assert expect > 0 and "{" not in capsys.readouterr().out     # no JSON row


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def _feed(tmp_path, rng, n=2):
    import json

    from PIL import Image

    os.makedirs(tmp_path / "annotations")
    os.makedirs(tmp_path / "images")
    captions = {}
    for i in range(n):
        arr = (rng.uniform(0, 1, (40, 36, 3)) * 255).astype(np.uint8)
        Image.fromarray(arr).save(tmp_path / "images" / f"{i + 1:012d}.jpg")
        captions[str(i + 1)] = f"image {i}"
    with open(tmp_path / "annotations" / "captions.json", "w") as f:
        json.dump(captions, f)
    return tmp_path


def _cli_args(tmp_path):
    return ["--data-dir", str(tmp_path / "data"), "--out-dir", str(tmp_path / "out"),
            "--num-steps", "2", "--input-size", "32", "--batch", "2",
            "--adaptations", "pos:0.1,neg:-0.1:0.1", "--weight-dis", "0.1",
            "--va-model", str(tmp_path / "missing_va_pred_all"),
            "--munit-model", str(tmp_path / "missing_munit.pt")]


def test_cli_runs_on_cpu(tmp_path, rng, capsys, monkeypatch):
    """Random full-width MUNIT and patch discriminator stand-ins at 32 px; the
    regressor's ten-crop geometry cut to 64/56 for the CPU."""
    from rgie_tpu_torch.cli.optimize_image_imaginaire import main
    from rgie_tpu_torch.models import loader

    load_va_loss = loader.load_va_loss
    monkeypatch.setattr(loader, "load_va_loss", lambda *a, **kw: load_va_loss(
        *a, input_size=VA_SIZE, crop_size=VA_CROP, **kw))
    _feed(tmp_path / "data", rng)
    main(_cli_args(tmp_path) + ["--device", "cpu"])
    written = sorted(os.listdir(tmp_path / "out"))
    assert written == ["000000000001_neg.jpg", "000000000001_pos.jpg",
                       "000000000002_neg.jpg", "000000000002_pos.jpg"]
    from PIL import Image

    assert Image.open(tmp_path / "out" / written[0]).size == (32, 32)
    out = capsys.readouterr().out
    assert "random-weight MUNIT stand-in" in out and "discriminator stand-in" in out
    assert out.count("batch of 2 edited") == 2


def test_cli_refuses_without_cuda_and_several_processes(tmp_path, monkeypatch):
    from rgie_tpu_torch.cli.optimize_image_imaginaire import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(_cli_args(tmp_path))
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="--batch 3 must divide over 2 processes"):
        main(_cli_args(tmp_path) + ["--device", "cpu", "--batch", "3"])
    assert not os.path.exists(tmp_path / "out")
