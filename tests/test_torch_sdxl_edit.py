"""The SDXL edit of the port against ``rgie_tpu`` on the CPU, tiny configs:
the tiled VAE transport, SDXL prompt encoding (two towers, pooled and
projected embeddings, time ids), and the edit with the sigma-space
DPM-Solver++ schedules (karras + lu, forward and inverse): end to end with
the tiled VAE, and step by step (inversion, null-text optimization, guided
sampling) with the whole VAE. Weights go port -> ``torch_convert`` -> JAX.
The helpers here build the JAX side of any port pipeline; the table-DPM
edit of the SD stack uses them in test_torch_schedulers_dpm.py.

Tolerances: float32 on both sides. The VAE and the towers agree to their
single-pass tolerances (5e-5 on decoded images, 2e-5 on latents and
embeddings); the loops as in test_torch_diffusion_edit.py: 2e-5 on the
inversion pivots, 2e-3 on the null-text embeddings (SDXL's lr is 1e-1, ten
times SD's step and ten times its rounding), 5e-4 on guided latents and 1e-3
on decoded images in [0, 1]. DDIM's latents are of order 1 to 3; the
sigma-space inversion ends at sigma 14.6, where pivots reach 3 or more and
a UNet's rounding comes back multiplied by sigma, and sampling from there
gives latents of order 10: pivots and guided latents are held to their
tolerance times the larger of 1 and each one's largest entry.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgie_tpu.utils import torch_convert as TC
from rgie_tpu_torch.adapt.adapter import ImageAdapter, ImageScorer
from rgie_tpu_torch.config import GuidanceConfig
from rgie_tpu_torch.diffusion import schedulers as S
from rgie_tpu_torch.diffusion import text_encoder as TE
from rgie_tpu_torch.diffusion import vae as V
from rgie_tpu_torch.diffusion.pipeline import InversionResamplingPipeline, RunLog, SdxlCond
from rgie_tpu_torch.diffusion.unet import UNetConfig, create_unet
from rgie_tpu_torch.models.midu import create_midu

torch.set_num_threads(2)

STEPS = 3
# MiduSDXL reads 32 x 32 mid-block features: the tiny VAE halves the image and
# the tiny UNet halves the latent once, so 128 px. The UNet is ``tiny_xl``
# with SDXL's block order (UNetConfig.sdxl(): no attention at the top level),
# which keeps the 64 x 64 latent's 4096 positions out of attention on the CPU.
SIZE = 128
TINY_XL = dataclasses.replace(UNetConfig.tiny_xl(),
                              down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"),
                              up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"))
TILE = 24          # latent tiles of 24 at the default stride 18: a ragged last tile
# Tower widths add up to the tiny UNet's cross-attention width; the second
# tower's projection is its pooled width.
TOWER1 = dict(width=16, layers=2, heads=2, act="quick_gelu", skip_last=1)
TOWER2 = dict(width=16, layers=2, heads=2, act="gelu", skip_last=1, proj_dim=16)


def _np_state(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def _as_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _randomize_biases(module, g, scale=0.1):
    """Biases away from zero (the stand-in init zeroes them), so that a
    swapped bias or a score that does not move would show."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=g) * scale)
    return module


def jax_prompt_encoder(enc):
    """The JAX package's PromptEncoder with the towers of ``enc``."""
    from rgie_tpu.diffusion import text_encoder as TE_j

    def tower(t):
        layer = t.text_model.encoder.layers[0]
        heads = layer.self_attn.heads
        variables = _as_jax(TC.convert_clip_text_hf(_np_state(t), heads=heads))
        cfg = TE_j.tower_config_from_params(
            variables["params"], skip_last=t.skip_last,
            act=next(k for k, f in TE.ACTIVATIONS.items() if f is layer.mlp.act))
        return TE_j.TextEncoderHidden(**{**cfg, "heads": heads}), variables

    t1, v1 = tower(enc.tower1)
    if enc.tower2 is None:
        return TE_j.PromptEncoder(tower1=t1, variables1=v1)
    t2, v2 = tower(enc.tower2)
    return TE_j.PromptEncoder(tower1=t1, variables1=v1, tower2=t2, variables2=v2)


def jax_pipeline(pipe, **kw):
    """The JAX package's pipeline and parameters with the modules and the
    settings of the port's ``pipe``."""
    from rgie_tpu.diffusion import pipeline as P_j
    from rgie_tpu.diffusion import schedulers as S_j
    from rgie_tpu.diffusion import unet as U_j
    from rgie_tpu.diffusion import vae as V_j
    from rgie_tpu.models import midu as M_j

    ucfg = U_j.UNetConfig(**dataclasses.asdict(pipe.unet.cfg))
    vcfg = V_j.VaeConfig(**dataclasses.asdict(pipe.vae.cfg))
    params = P_j.PipelineParams(
        unet=_as_jax(TC.convert_unet_diffusers(_np_state(pipe.unet), ucfg)),
        vae=_as_jax(TC.convert_vae_diffusers(_np_state(pipe.vae), vcfg)),
        midu=_as_jax(TC.convert_midu(_np_state(pipe.midu_model), pipe.is_xl)))
    sigma = {}
    for name in ("sigma_sched", "sigma_sched_inv"):
        table = getattr(pipe, name)
        if table is not None:
            sigma[name] = S_j.DpmSigmaSchedule(jnp.asarray(table.sigmas.numpy()),
                                               jnp.asarray(table.timesteps.numpy(), jnp.int32),
                                               table.num_inference_steps)
    pipe_j = P_j.InversionResamplingPipeline(
        unet=U_j.UNet2DCondition(ucfg), vae=V_j.AutoencoderKL(vcfg),
        sched=S_j.make_schedule(pipe.sched.num_inference_steps),
        midu_model=M_j.MiduSDXL(2) if pipe.is_xl else M_j.MiduSD(2), is_xl=pipe.is_xl,
        scheduler_type=pipe.scheduler_type, vae_tile=pipe.vae_tile, **sigma, **kw)
    return pipe_j, params


def assert_close_at_scale(got, expect, atol):
    """Each entry of the leading axis held to ``atol`` times the larger of 1
    and its largest entry."""
    for k, (a, b) in enumerate(zip(got.numpy(), np.asarray(expect))):
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a / scale, b / scale, atol=atol, err_msg=f"entry {k}")


def sigma_tables(steps, **kw):
    return {name: S.make_dpm_sigma_schedule(steps, use_karras_sigmas=True, use_lu_lambdas=True,
                                            inverse=inverse, **kw)
            for name, inverse in (("sigma_sched", False), ("sigma_sched_inv", True))}


def run_edit_pair(pipe, enc, image, caption="a photo of a dog", prompt="happy", jax_side=None):
    """One edit through both packages' adapters (``revert_and_sample``: invert,
    null-text optimization, guided sampling with CFG, the null-text
    embeddings, classifier guidance and a reference value, decode). The JAX
    side is ``jax_side`` (pipeline, parameters, prompt encoder) or, by
    default, built from the port's modules. Returns {"port": (outputs, log),
    "jax": outputs, "pipe_j": ..., "params_j": ...}."""
    from rgie_tpu.adapt.adapter import ImageAdapter as Adapter_j
    from rgie_tpu.adapt.adapter import ImageScorer as Scorer_j
    from rgie_tpu.config import GuidanceConfig as Guidance_j
    from rgie_tpu.diffusion.pipeline import SdxlCond as SdxlCond_j

    if jax_side is None:
        jax_side = jax_pipeline(pipe) + (jax_prompt_encoder(enc),)
    pipe_j, params_j, enc_j = jax_side
    size = image.shape[1]
    fns, fns_j = {}, {}
    if pipe.is_xl:
        fns = dict(embeds_fn=lambda p, n: enc.encode_sdxl(p, n, size)[0][1:2],
                   cfg_embeds_fn=lambda p, n: enc.encode_sdxl(p, n, size)[0],
                   added_cond_fn=lambda p, n: SdxlCond(*enc.encode_sdxl(p, n, size)[1:]))
        fns_j = dict(embeds_fn=lambda p, n: enc_j.encode_sdxl(p, n, size)[0][1:2],
                     cfg_embeds_fn=lambda p, n: enc_j.encode_sdxl(p, n, size)[0],
                     added_cond_fn=lambda p, n: SdxlCond_j(*enc_j.encode_sdxl(p, n, size)[1:]))
    else:
        fns = dict(embeds_fn=lambda p, n: enc.encode_sd(p, n, do_cfg=False),
                   cfg_embeds_fn=lambda p, n: enc.encode_sd(p, n, do_cfg=True))
        fns_j = dict(embeds_fn=lambda p, n: enc_j.encode_sd(p, n, do_cfg=False),
                     cfg_embeds_fn=lambda p, n: enc_j.encode_sd(p, n, do_cfg=True))
    scorer = ImageScorer(pipe=pipe, embeds_fn=fns["embeds_fn"],
                         added_cond_fn=fns.get("added_cond_fn"))
    adapter = ImageAdapter(pipe=pipe, scorer=scorer, **fns)
    scorer_j = Scorer_j(pipe=pipe_j, params=params_j, embeds_fn=fns_j["embeds_fn"],
                        added_cond_fn=fns_j.get("added_cond_fn"))
    adapter_j = Adapter_j(pipe=pipe_j, params=params_j, scorer=scorer_j, input_size=size,
                          **fns_j)

    score, score_j = scorer.score(torch.from_numpy(image)), scorer_j.score(jnp.asarray(image))
    np.testing.assert_allclose(score, score_j, atol=2e-5)
    reference = np.clip(score + 0.1, 0.0, 1.0)
    setting = dict(clf_scale=0.2, cfg_scale=2.0, is_nto=True, prompt=prompt)
    outputs = adapter.revert_and_sample(torch.from_numpy(image), caption, None,
                                        {"a": GuidanceConfig(**setting)},
                                        reference_value=torch.from_numpy(reference))
    outputs_j = adapter_j.revert_and_sample(jnp.asarray(image), caption, None,
                                            {"a": Guidance_j(**setting)},
                                            reference_value=jnp.asarray(reference))
    return {"port": (outputs, adapter.last_log), "jax": outputs_j, "pipe_j": pipe_j,
            "params_j": params_j}


# ---------------------------------------------------------------------------
# The tiled VAE transport
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vae_pair():
    from rgie_tpu.diffusion import vae as V_j

    g = torch.Generator().manual_seed(3)
    vae = _randomize_biases(V.create_vae(g, V.VaeConfig.tiny()), g)
    model_j = V_j.AutoencoderKL(V_j.VaeConfig.tiny())
    variables = _as_jax(TC.convert_vae_diffusers(_np_state(vae), V_j.VaeConfig.tiny()))
    return vae, model_j, variables


def test_tile_helpers_match_jax():
    from rgie_tpu.diffusion import vae as V_j

    for extent, tile, stride in [(16, 16, 12), (40, 16, 12), (41, 16, 12), (64, 24, 18),
                                 (7, 3, 1), (100, 32, 24)]:
        assert V.tile_positions(extent, tile, stride) == V_j.tile_positions(extent, tile, stride)
    for args in [(32, 8, True, True), (32, 8, False, True), (16, 1, True, False),
                 (8, 0, True, True), (8, 12, True, True)]:
        np.testing.assert_array_equal(V._edge_ramp(*args), V_j._edge_ramp(*args))


@pytest.mark.parametrize("hw,tile,stride", [((40, 40), 16, 12), ((38, 52), 16, 12),
                                            ((20, 20), 16, None), ((12, 12), 16, 12)])
def test_decode_tiled_matches_jax(vae_pair, rng, hw, tile, stride):
    """Square and ragged extents (the last tile clamped), the default stride
    (3/4 of the tile, through the pipeline), and a latent that fits one tile
    (equal to the whole decode)."""
    from rgie_tpu.diffusion import vae as V_j

    vae, model_j, variables = vae_pair
    lat = (rng.standard_normal((1,) + hw + (4,)) * 0.5).astype(np.float32)
    stride = stride or (tile * 3) // 4
    with torch.no_grad():
        got = V.decode_tiled(vae, torch.from_numpy(lat), tile=tile, stride=stride)
    expect = V_j.decode_tiled(model_j, variables, jnp.asarray(lat), tile=tile, stride=stride)
    assert got.shape == (1, hw[0] * 2, hw[1] * 2, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=5e-5)
    if max(hw) <= tile:
        with torch.no_grad():
            np.testing.assert_array_equal(got.numpy(), vae.decode(torch.from_numpy(lat)).numpy())


@pytest.mark.parametrize("hw,tile,stride", [((80, 80), 16, 12), ((76, 104), 16, 12),
                                            ((24, 24), 16, 12)])
def test_encode_tiled_matches_jax(vae_pair, rng, hw, tile, stride):
    from rgie_tpu.diffusion import vae as V_j

    vae, model_j, variables = vae_pair
    img = rng.uniform(-1, 1, (1,) + hw + (3,)).astype(np.float32)
    with torch.no_grad():
        got = V.encode_tiled(vae, torch.from_numpy(img), tile=tile, stride=stride)
    expect = V_j.encode_tiled(model_j, variables, jnp.asarray(img), tile=tile, stride=stride)
    assert got.shape == (1, hw[0] // 2, hw[1] // 2, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=2e-5)


def test_encode_tiled_samples_each_tile(vae_pair, rng):
    """With a generator each tile draws its own posterior noise: the same
    generator state gives the same latents, another state other latents, and
    all stay near the posterior mode."""
    vae = vae_pair[0]
    img = torch.from_numpy(rng.uniform(-1, 1, (1, 80, 80, 3)).astype(np.float32))
    with torch.no_grad():
        mode = V.encode_tiled(vae, img, tile=16, stride=12)
        a = V.encode_tiled(vae, img, torch.Generator().manual_seed(1), tile=16, stride=12)
        b = V.encode_tiled(vae, img, torch.Generator().manual_seed(1), tile=16, stride=12)
        c = V.encode_tiled(vae, img, torch.Generator().manual_seed(2), tile=16, stride=12)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert float((a - c).abs().max()) > 0 and float((a - mode).abs().max()) > 0


# ---------------------------------------------------------------------------
# SDXL prompt encoding
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sdxl_encoder():
    g = torch.Generator().manual_seed(5)
    enc = TE.create_sdxl_prompt_encoder(g, TOWER1, TOWER2)
    for tower in (enc.tower1, enc.tower2):
        _randomize_biases(tower, g)
    return enc


def test_encode_sdxl_matches_jax(sdxl_encoder):
    from rgie_tpu.diffusion import text_encoder as TE_j

    enc = sdxl_encoder
    enc_j = jax_prompt_encoder(enc)
    for prompt, negative, size in [("a photo of a dog", "blurry", 1024), ("", "", 128)]:
        embeds, pooled, time_ids = enc.encode_sdxl(prompt, negative, image_size=size)
        embeds_j, pooled_j, time_ids_j = enc_j.encode_sdxl(prompt, negative, image_size=size)
        assert embeds.shape == (2, 77, 32) and pooled.shape == (2, 16)
        assert time_ids.shape == (2, 6)
        assert embeds.dtype == pooled.dtype == time_ids.dtype == torch.float32
        np.testing.assert_allclose(embeds.numpy(), np.asarray(embeds_j), atol=2e-5)
        np.testing.assert_allclose(pooled.numpy(), np.asarray(pooled_j), atol=2e-5)
        np.testing.assert_array_equal(time_ids.numpy(), np.asarray(time_ids_j))
        np.testing.assert_array_equal(embeds[:, :, :16].numpy(),
                                      enc.tower1(TE.tokenize([negative, prompt]))[0].numpy())
    for args in [(1024, 1024), (768, 1024, 8, 16), (512, 512, 0, 0, 1024, 1024)]:
        np.testing.assert_array_equal(TE.get_add_time_ids(*args).numpy(),
                                      np.asarray(TE_j.get_add_time_ids(*args)))


def test_tower_config_from_params_matches_jax(sdxl_encoder):
    from rgie_tpu.diffusion import text_encoder as TE_j

    for tower, act in ((sdxl_encoder.tower1, "quick_gelu"), (sdxl_encoder.tower2, "gelu")):
        state = tower.state_dict()
        got = TE.tower_config_from_params(state, skip_last=1, act=act)
        expect = TE_j.tower_config_from_params(TC.convert_clip_text_hf(_np_state(tower))["params"],
                                               skip_last=1, act=act)
        assert got == expect
        # the config rebuilds the tower, which takes the state dict as it is
        TE.TextEncoderHidden(**got).load_state_dict(state, strict=True)


def test_sdxl_prompt_encoder_stand_ins_are_float32():
    g = torch.Generator().manual_seed(0)
    enc = TE.create_sdxl_prompt_encoder(g, TOWER1, TOWER2, dtype=torch.float32)
    assert enc.tower1.skip_last == enc.tower2.skip_last == 1
    assert not hasattr(enc.tower1, "text_projection")
    assert enc.tower2.text_projection.weight.shape == (16, 16)
    assert all(p.dtype == torch.float32 and not p.requires_grad
               for t in (enc.tower1, enc.tower2) for p in t.parameters())
    assert TE.TextTowerConfig.clip_vit_l()["act"] == "quick_gelu"
    assert TE.TextTowerConfig.open_clip_big_g()["proj_dim"] == 1280


# ---------------------------------------------------------------------------
# The tiny SDXL edit end to end
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sdxl_stack(sdxl_encoder):
    g = torch.Generator().manual_seed(11)
    unet = _randomize_biases(create_unet(g, TINY_XL), g, 0.02)
    vae = _randomize_biases(V.create_vae(g, V.VaeConfig(
        block_out_channels=(8, 16), layers_per_block=1, norm_num_groups=4,
        scaling_factor=V.SDXL_SCALING)), g, 0.02)
    midu = _randomize_biases(create_midu(g, is_sdxl=True, in_channels=16), g)
    pipe = InversionResamplingPipeline(unet=unet, vae=vae, sched=S.make_schedule(STEPS),
                                       midu_model=midu, is_xl=True, scheduler_type="dpm",
                                       **sigma_tables(STEPS))
    image = np.random.default_rng(4).uniform(0, 1, (1, SIZE, SIZE, 3)).astype(np.float32)
    return pipe, sdxl_encoder, image


def test_sdxl_edit_matches_jax(sdxl_stack):
    """Score, sigma-space DPM inversion, null-text optimization (SDXL's lr
    1e-1, the DDIM step), sigma-space DPM sampling with CFG and classifier
    guidance, decode: the adapter's edit end to end, through the tiled VAE
    (64 x 64 latents in tiles of 24: a ragged last tile)."""
    pipe, enc, image = sdxl_stack
    pipe = dataclasses.replace(pipe, vae_tile=TILE)
    run = run_edit_pair(pipe, enc, image)
    outputs, log = run["port"]
    lat_j = run["pipe_j"].encode_image(run["params_j"], jnp.asarray(image))
    np.testing.assert_allclose(log.tensors["latents"].numpy(), np.asarray(lat_j), atol=2e-5)
    assert log.tensors["noisy"].shape == (1, SIZE // 2, SIZE // 2, 4)
    assert len(log.nto_inner_steps) == STEPS
    assert log.tensors["nto_embeds"].shape == (STEPS, 77, 32)
    assert log.tensors["nto_embeds"].dtype == torch.float32
    assert len(log.clf_grad_norms) == STEPS and all(float(g) > 0 for g in log.clf_grad_norms)
    img = outputs["a"]
    assert img.shape == (1, SIZE, SIZE, 3) and float(img.min()) >= 0 and float(img.max()) <= 1
    np.testing.assert_allclose(img.numpy(), np.asarray(run["jax"]["a"]), atol=1e-3)


def test_sdxl_nto_and_sampling_steps_match_jax(sdxl_stack):
    """The edit step by step with the whole VAE: latents, the sigma-space
    inversion's pivots (the dedup'd inverse table's length), the null-text
    embeddings with every inner step run (epsilon below any loss), the guided
    latents and the decoded image."""
    from rgie_tpu.diffusion.pipeline import SdxlCond as SdxlCond_j

    pipe, enc, image = sdxl_stack
    pipe_j, params_j = jax_pipeline(pipe)
    enc_j = jax_prompt_encoder(enc)
    row = lambda c, i: type(c)(c.text_embeds[i:i + 1], c.time_ids[i:i + 1])
    embeds, pooled, ids = enc.encode_sdxl("a photo", "", SIZE)
    embeds_j, pooled_j, ids_j = enc_j.encode_sdxl("a photo", "", SIZE)
    both, both_j = SdxlCond(pooled, ids), SdxlCond_j(pooled_j, ids_j)

    latents = pipe.encode_image(torch.from_numpy(image))
    lat_j = pipe_j.encode_image(params_j, jnp.asarray(image))
    np.testing.assert_allclose(latents.numpy(), np.asarray(lat_j), atol=2e-5)
    _, pivots = pipe.reverse_sample(latents, embeds[:1], added=row(both, 0))
    noisy_j, pivots_j = jax.jit(pipe_j.reverse_sample)(params_j, lat_j, embeds_j[:1],
                                                       added=row(both_j, 0))
    k = pipe.sigma_sched_inv.num_inference_steps
    assert pivots.shape[0] == k + 1 and k == pipe_j.sigma_sched_inv.num_inference_steps
    assert_close_at_scale(pivots, pivots_j, 2e-5)

    nto = pipe.null_optimization(pivots, embeds[1:], embeds[:1], 2.0, added_cond=row(both, 1),
                                 added_uncond=row(both, 0), num_inner_steps=2, epsilon=-1.0)
    nto_j = jax.jit(pipe_j.null_optimization, static_argnames=(
        "guidance_scale", "num_inner_steps", "epsilon"))(
        params_j, pivots_j, embeds_j[1:], embeds_j[:1], guidance_scale=2.0,
        added_cond=row(both_j, 1), added_uncond=row(both_j, 0), num_inner_steps=2, epsilon=-1.0)
    assert float((nto[0] - embeds[0]).abs().max()) > 1e-2       # lr 1e-1 moved them
    np.testing.assert_allclose(nto.numpy(), np.asarray(nto_j), atol=2e-3)

    log = RunLog()
    noisy = torch.from_numpy(np.array(noisy_j))
    got = pipe.sample(noisy, embeds, added=both, guidance_scale=2.0, guidance_clf_scale=0.2,
                      uncond_embeds_per_step=torch.from_numpy(np.array(nto_j)),
                      midu_reference_value=torch.tensor([[0.4, 0.6]]), log=log)
    expect = jax.jit(pipe_j.sample, static_argnames=("guidance_scale", "guidance_clf_scale"))(
        params_j, noisy_j, embeds_j, added=both_j, guidance_scale=2.0, guidance_clf_scale=0.2,
        uncond_embeds_per_step=nto_j, midu_reference_value=jnp.asarray([[0.4, 0.6]]))
    assert_close_at_scale(got, expect, 5e-4)
    assert len(log.clf_grad_norms) == STEPS
    img = pipe.decode_latents(got)
    assert img.shape == (1, SIZE, SIZE, 3)
    np.testing.assert_allclose(img.numpy(), np.asarray(pipe_j.decode_latents(params_j, expect)),
                               atol=1e-3)


def test_sigma_tables_of_the_pipeline_match_jax(sdxl_stack):
    pipe, _, _ = sdxl_stack
    pipe_j, _ = jax_pipeline(pipe)
    for end in (None, 2):
        for got, expect in zip(pipe.invert_tables(end), pipe_j.invert_tables(end)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(expect))
    for start in (0, 1):
        for got, expect in zip(pipe.sample_tables(start), pipe_j.sample_tables(start)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(expect))
