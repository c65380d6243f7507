"""The diffusion edit as a whole at the tiny scale against ``rgie_tpu`` on the
CPU: the same weights (port -> ``torch_convert`` -> JAX), the same image and
prompts through both pipelines: inversion pivots, null-text embeddings (all
inner steps, and the early stop on its own), guided sampling with CFG,
null-text embeddings, classifier guidance and a reference value, decoding,
and ``ImageAdapter.revert_and_sample`` end to end; then the CLI on the CPU.

Tolerances: float32 on both sides. Single passes agree to 1e-5; the loops
compound rounding through Adam's normalized steps and the normalized guidance
gradient, so their results are held to 2e-4 (embeddings), 5e-4 (sampled
latents, of order 1 to 3: the guidance step divides by the gradient's norm)
and 1e-3 (decoded images in [0, 1]).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgie_tpu.utils import torch_convert as TC
from rgie_tpu_torch.adapt.adapter import ImageAdapter, ImageScorer, transform_image
from rgie_tpu_torch.config import GuidanceConfig
from rgie_tpu_torch.diffusion import schedulers as S
from rgie_tpu_torch.diffusion import text_encoder as TE
from rgie_tpu_torch.diffusion.pipeline import (InversionResamplingPipeline, RunLog,
                                               rescale_noise_cfg)
from rgie_tpu_torch.diffusion.unet import UNetConfig, create_unet
from rgie_tpu_torch.diffusion.vae import VaeConfig, create_vae
from rgie_tpu_torch.models.midu import create_midu

torch.set_num_threads(2)

STEPS, SIZE = 3, 32


def _np_state(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


@pytest.fixture(scope="module")
def stacks():
    """The tiny edit stack in both packages with the same weights."""
    from rgie_tpu.diffusion import pipeline as P_j
    from rgie_tpu.diffusion import schedulers as S_j
    from rgie_tpu.diffusion import text_encoder as TE_j
    from rgie_tpu.diffusion import unet as U_j
    from rgie_tpu.diffusion import vae as V_j
    from rgie_tpu.models import midu as M_j

    g = torch.Generator().manual_seed(0)
    unet, vae = create_unet(g, UNetConfig.tiny()), create_vae(g, VaeConfig.tiny())
    midu = create_midu(g, in_channels=16)
    with torch.no_grad():   # biases away from zero, so that the score moves
        for p in midu.parameters():
            if p.ndim == 1:
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    enc = TE.create_sd_prompt_encoder(g, TE.TextTowerConfig.tiny())
    pipe = InversionResamplingPipeline(unet=unet, vae=vae, sched=S.make_schedule(STEPS),
                                       midu_model=midu)

    as_jax = lambda tree: jax.tree.map(jnp.asarray, tree)
    params_j = P_j.PipelineParams(
        unet=as_jax(TC.convert_unet_diffusers(_np_state(unet), U_j.UNetConfig.tiny())),
        vae=as_jax(TC.convert_vae_diffusers(_np_state(vae), V_j.VaeConfig.tiny())),
        midu=as_jax(TC.convert_midu(_np_state(midu), False)))
    pipe_j = P_j.InversionResamplingPipeline(
        unet=U_j.UNet2DCondition(U_j.UNetConfig.tiny()),
        vae=V_j.AutoencoderKL(V_j.VaeConfig.tiny()), sched=S_j.make_schedule(STEPS),
        midu_model=M_j.MiduSD(2))
    enc_j = TE_j.PromptEncoder(
        tower1=TE_j.TextEncoderHidden(**TE_j.TextTowerConfig.tiny()),
        variables1=as_jax(TC.convert_clip_text_hf(_np_state(enc.tower1), heads=2)))

    rng = np.random.default_rng(1)
    image = rng.uniform(0, 1, (1, SIZE, SIZE, 3)).astype(np.float32)
    out = dict(pipe=pipe, pipe_j=pipe_j, params_j=params_j, enc=enc, enc_j=enc_j, image=image)

    # The shared front of every test: encode and invert, in both packages.
    out["latents"] = pipe.encode_image(torch.from_numpy(image))
    out["latents_j"] = pipe_j.encode_image(params_j, jnp.asarray(image))
    out["empty"] = enc.encode_sd("", "", do_cfg=False)
    out["empty_j"] = enc_j.encode_sd("", "", do_cfg=False)
    out["noisy"], out["pivots"] = pipe.reverse_sample(out["latents"], out["empty"])
    out["noisy_j"], out["pivots_j"] = jax.jit(pipe_j.reverse_sample)(
        params_j, out["latents_j"], out["empty_j"])
    return out


def test_encode_and_reverse_sample_match_jax(stacks):
    s = stacks
    assert s["latents"].shape == (1, SIZE // 2, SIZE // 2, 4)
    np.testing.assert_allclose(s["latents"].numpy(), np.asarray(s["latents_j"]), atol=1e-5)
    np.testing.assert_allclose(s["empty"].numpy(), np.asarray(s["empty_j"]), atol=1e-5)
    assert s["pivots"].shape == (STEPS + 1,) + tuple(s["latents"].shape)
    np.testing.assert_array_equal(s["pivots"][0].numpy(), s["latents"].numpy())
    np.testing.assert_array_equal(s["pivots"][-1].numpy(), s["noisy"].numpy())
    np.testing.assert_allclose(s["pivots"].numpy(), np.asarray(s["pivots_j"]), atol=2e-5)
    # a truncated inversion
    noisy2, pivots2 = s["pipe"].reverse_sample(s["latents"], s["empty"], end_iteration=2)
    np.testing.assert_array_equal(pivots2.numpy(), s["pivots"][:3].numpy())
    np.testing.assert_array_equal(noisy2.numpy(), s["pivots"][2].numpy())


def test_tables_match_jax(stacks):
    pipe, pipe_j = stacks["pipe"], stacks["pipe_j"]
    for end in (None, 2):
        for got, expect in zip(pipe.invert_tables(end), pipe_j.invert_tables(end)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(expect))
    for start in (0, 1):
        for got, expect in zip(pipe.sample_tables(start), pipe_j.sample_tables(start)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(expect))


@pytest.fixture(scope="module")
def nto(stacks):
    """Null-text embeddings with every inner step run (epsilon below any loss)."""
    s = stacks
    cond, cond_j = s["enc"].encode_sd("a photo", "", do_cfg=False), s["enc_j"].encode_sd(
        "a photo", "", do_cfg=False)
    log = RunLog()
    got = s["pipe"].null_optimization(s["pivots"], cond, s["empty"], 2.0, num_inner_steps=4,
                                      epsilon=-1.0, log=log)
    expect = jax.jit(s["pipe_j"].null_optimization, static_argnames=(
        "guidance_scale", "num_inner_steps", "epsilon"))(
        s["params_j"], s["pivots_j"], cond_j, s["empty_j"], guidance_scale=2.0,
        num_inner_steps=4, epsilon=-1.0)
    return dict(got=got, expect=expect, log=log, cond=cond, cond_j=cond_j)


def test_null_optimization_matches_jax(stacks, nto):
    assert nto["log"].nto_inner_steps == [4] * STEPS
    assert nto["got"].shape == (STEPS, 77, 32)
    moved = float((nto["got"][0] - stacks["empty"][0]).abs().max())
    assert moved > 1e-3          # Adam moved the embeddings: lr 1e-2 a step
    np.testing.assert_allclose(nto["got"].numpy(), np.asarray(nto["expect"]), atol=2e-4)


def test_null_optimization_early_stop_matches_jax(stacks, nto):
    """With the threshold above every loss the inner loop runs once per outer
    step (it starts from an infinite loss), in both packages."""
    s = stacks
    log = RunLog()
    got = s["pipe"].null_optimization(s["pivots"], nto["cond"], s["empty"], 2.0,
                                      num_inner_steps=4, epsilon=1e9, log=log)
    expect = jax.jit(s["pipe_j"].null_optimization, static_argnames=(
        "guidance_scale", "num_inner_steps", "epsilon"))(
        s["params_j"], s["pivots_j"], nto["cond_j"], s["empty_j"], guidance_scale=2.0,
        num_inner_steps=4, epsilon=1e9)
    assert log.nto_inner_steps == [1] * STEPS
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=2e-4)
    assert float((got - nto["got"]).abs().max()) > 1e-3


def test_null_inner_loss_and_gradient_match_jax(stacks, nto):
    s = stacks
    pipe, pipe_j, params_j = s["pipe"], s["pipe_j"], s["params_j"]
    t = int(pipe.sched.timesteps[0])
    lat, lat_prev = s["pivots"][-1], s["pivots"][-2]
    eps_cond, _ = pipe._unet(lat, t, nto["cond"], None)
    loss, grad = pipe.null_inner_loss_and_grad(s["empty"], lat, t, eps_cond, lat_prev, 2.0)

    from rgie_tpu.diffusion import schedulers as S_j

    def loss_j(u):
        lat_j, prev_j = s["pivots_j"][-1], s["pivots_j"][-2]
        eps_c, _ = pipe_j._unet(params_j.unet, lat_j, jnp.asarray(t), nto["cond_j"], None)
        eps_u, _ = pipe_j._unet(params_j.unet, lat_j, jnp.asarray(t), u, None)
        rec = S_j.ddim_step(pipe_j.sched, eps_u + 2.0 * (eps_c - eps_u), jnp.asarray(t), lat_j)
        return jnp.mean((rec - prev_j) ** 2)

    expect_loss, expect_grad = jax.jit(jax.value_and_grad(loss_j))(s["empty_j"])
    np.testing.assert_allclose(float(loss), float(expect_loss), rtol=1e-4)
    scale = np.abs(np.asarray(expect_grad)).max()
    np.testing.assert_allclose(grad.numpy() / scale, np.asarray(expect_grad) / scale, atol=1e-4)


@pytest.mark.parametrize("case", ["cfg_nto_clf_reference", "cfg_clf_maximize", "no_cfg_clf",
                                  "cfg_only_rescale_late_start"])
def test_sample_matches_jax(stacks, nto, case):
    s = stacks
    kw = dict(
        cfg_nto_clf_reference=dict(guidance_scale=2.0, guidance_clf_scale=0.2, use_nto=True,
                                   reference=[[0.4, 0.7]]),
        cfg_clf_maximize=dict(guidance_scale=3.0, guidance_clf_scale=0.5,
                              midu_is_minimized=False),
        no_cfg_clf=dict(guidance_scale=1.0, guidance_clf_scale=0.3),
        cfg_only_rescale_late_start=dict(guidance_scale=4.0, guidance_rescale=0.7,
                                         start_iteration=1),
    )[case]
    use_nto, reference = kw.pop("use_nto", False), kw.pop("reference", None)
    do_cfg = kw["guidance_scale"] > 1.0
    embeds = s["enc"].encode_sd("a photo of a dog", "blurry", do_cfg=do_cfg)
    embeds_j = s["enc_j"].encode_sd("a photo of a dog", "blurry", do_cfg=do_cfg)
    log = RunLog()
    got = s["pipe"].sample(
        s["noisy"], embeds, uncond_embeds_per_step=nto["got"] if use_nto else None,
        midu_reference_value=None if reference is None else torch.tensor(reference),
        log=log, **kw)
    expect = jax.jit(s["pipe_j"].sample, static_argnames=(
        "guidance_scale", "guidance_clf_scale", "guidance_rescale", "start_iteration",
        "midu_is_minimized"))(
        s["params_j"], s["noisy_j"], embeds_j,
        uncond_embeds_per_step=nto["expect"] if use_nto else None,
        midu_reference_value=None if reference is None else jnp.asarray(reference), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=5e-4)
    n_steps = STEPS - kw.get("start_iteration", 0)
    if kw.get("guidance_clf_scale", 0.0) > 0:
        assert len(log.clf_grad_norms) == n_steps and all(float(g) > 0 for g in log.clf_grad_norms)
    else:
        assert not log.clf_grad_norms

    img = s["pipe"].decode_latents(got)
    img_j = s["pipe_j"].decode_latents(s["params_j"], expect)
    assert img.shape == (1, SIZE, SIZE, 3) and float(img.min()) >= 0 and float(img.max()) <= 1
    np.testing.assert_allclose(img.numpy(), np.asarray(img_j), atol=1e-3)


def test_sdxl_conditioning_matches_jax(stacks, rng):
    """The pipeline's added-conditioning plumbing (pooled text embeddings and
    time ids through inversion, null-text optimization and guided sampling)
    with the ``tiny_xl`` UNet; the SDXL edit end to end is a later slice."""
    import dataclasses

    from rgie_tpu.diffusion import pipeline as P_j
    from rgie_tpu.diffusion import unet as U_j
    from rgie_tpu_torch.diffusion.pipeline import SdxlCond

    s = stacks
    unet = create_unet(torch.Generator().manual_seed(7), UNetConfig.tiny_xl())
    pipe = dataclasses.replace(s["pipe"], unet=unet, is_xl=True)
    pipe_j = dataclasses.replace(s["pipe_j"], unet=U_j.UNet2DCondition(U_j.UNetConfig.tiny_xl()),
                                 is_xl=True)
    params_j = s["params_j"]._replace(unet=jax.tree.map(jnp.asarray, TC.convert_unet_diffusers(
        _np_state(unet), U_j.UNetConfig.tiny_xl())))
    text = rng.standard_normal((2, 16)).astype(np.float32)
    ids = np.asarray([[SIZE, SIZE, 0, 0, SIZE, SIZE]] * 2, np.float32)
    both = SdxlCond(torch.from_numpy(text), torch.from_numpy(ids))
    both_j = P_j.SdxlCond(jnp.asarray(text), jnp.asarray(ids))
    row = lambda c, i: type(c)(c.text_embeds[i:i + 1], c.time_ids[i:i + 1])
    embeds = s["enc"].encode_sd("a photo of a dog", "", do_cfg=True)
    embeds_j = s["enc_j"].encode_sd("a photo of a dog", "", do_cfg=True)

    noisy, pivots = pipe.reverse_sample(s["latents"], s["empty"], added=row(both, 1))
    noisy_j, pivots_j = jax.jit(pipe_j.reverse_sample)(params_j, s["latents_j"], s["empty_j"],
                                                       added=row(both_j, 1))
    np.testing.assert_allclose(pivots.numpy(), np.asarray(pivots_j), atol=2e-5)

    nto = pipe.null_optimization(pivots, embeds[1:], embeds[:1], 2.0, added_cond=row(both, 1),
                                 added_uncond=row(both, 0), num_inner_steps=2, epsilon=-1.0)
    nto_j = jax.jit(pipe_j.null_optimization, static_argnames=(
        "guidance_scale", "num_inner_steps", "epsilon"))(
        params_j, pivots_j, embeds_j[1:], embeds_j[:1], guidance_scale=2.0,
        added_cond=row(both_j, 1), added_uncond=row(both_j, 0), num_inner_steps=2, epsilon=-1.0)
    # lr is 1e-1 for SDXL: ten times the SD step, ten times its rounding
    np.testing.assert_allclose(nto.numpy(), np.asarray(nto_j), atol=2e-3)

    got = pipe.sample(noisy, embeds, added=both, guidance_scale=2.0, guidance_clf_scale=0.2,
                      uncond_embeds_per_step=torch.from_numpy(np.asarray(nto_j)))
    expect = jax.jit(pipe_j.sample, static_argnames=("guidance_scale", "guidance_clf_scale"))(
        params_j, noisy_j, embeds_j, added=both_j, guidance_scale=2.0, guidance_clf_scale=0.2,
        uncond_embeds_per_step=nto_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=5e-4)


def test_rescale_noise_cfg_matches_jax(rng):
    from rgie_tpu.diffusion.pipeline import rescale_noise_cfg as rescale_j

    a = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
    b = rng.standard_normal((2, 4, 4, 4)).astype(np.float32) * 3
    got = rescale_noise_cfg(torch.from_numpy(a), torch.from_numpy(b), 0.7).numpy()
    np.testing.assert_allclose(got, np.asarray(rescale_j(jnp.asarray(a), jnp.asarray(b), 0.7)),
                               atol=1e-6, rtol=1e-5)


def test_revert_and_sample_matches_jax(stacks):
    """The adapter's revert_and_sample end to end: two guidance settings that share one
    null-text optimization, and one without it."""
    from rgie_tpu.adapt.adapter import ImageAdapter as Adapter_j
    from rgie_tpu.adapt.adapter import ImageScorer as Scorer_j
    from rgie_tpu.config import GuidanceConfig as Guidance_j

    s = stacks
    enc, enc_j = s["enc"], s["enc_j"]
    embeds_fn = lambda p, n: enc.encode_sd(p, n, do_cfg=False)
    cfg_fn = lambda p, n: enc.encode_sd(p, n, do_cfg=True)
    scorer = ImageScorer(pipe=s["pipe"], embeds_fn=embeds_fn)
    adapter = ImageAdapter(pipe=s["pipe"], scorer=scorer, embeds_fn=embeds_fn,
                           cfg_embeds_fn=cfg_fn, input_size=SIZE)
    embeds_fn_j = lambda p, n: enc_j.encode_sd(p, n, do_cfg=False)
    cfg_fn_j = lambda p, n: enc_j.encode_sd(p, n, do_cfg=True)
    scorer_j = Scorer_j(pipe=s["pipe_j"], params=s["params_j"], embeds_fn=embeds_fn_j)
    adapter_j = Adapter_j(pipe=s["pipe_j"], params=s["params_j"], scorer=scorer_j,
                          embeds_fn=embeds_fn_j, cfg_embeds_fn=cfg_fn_j, input_size=SIZE)

    image = torch.from_numpy(s["image"])
    score, score_j = scorer.score(image), scorer_j.score(jnp.asarray(s["image"]))
    assert score.shape == (1, 2)
    np.testing.assert_allclose(score, score_j, atol=2e-5)

    settings = {"a": dict(clf_scale=0.2, cfg_scale=2.0, is_nto=True),
                "b": dict(clf_scale=0.4, cfg_scale=2.0, is_nto=True, prompt="happy"),
                "c": dict(clf_scale=0.0, cfg_scale=3.0, is_nto=False, use_caption=False)}
    reference = np.clip(score + 0.1, 0.0, 1.0)
    seen = []
    outputs = adapter.revert_and_sample(
        image, "a test image", None, {k: GuidanceConfig(**v) for k, v in settings.items()},
        reference_value=torch.from_numpy(reference),
        callback_outputs=lambda img, key: seen.append(key))
    outputs_j = adapter_j.revert_and_sample(
        jnp.asarray(s["image"]), "a test image", None,
        {k: Guidance_j(**v) for k, v in settings.items()}, reference_value=jnp.asarray(reference))
    assert seen == list(settings) and list(outputs) == list(settings)
    for key in settings:
        np.testing.assert_allclose(outputs[key].numpy(), np.asarray(outputs_j[key]), atol=1e-3,
                                   err_msg=key)
    log = adapter.last_log
    assert len(log.nto_inner_steps) == STEPS          # one optimization for "a" and "b"
    assert len(log.clf_grad_norms) == 2 * STEPS
    assert {"encode", "invert", "nto", "sample", "decode"} <= set(log.seconds)
    assert float(scorer.rec_error(image, outputs["a"])) == pytest.approx(
        float(np.mean(np.abs(outputs["a"].numpy() - s["image"]))), rel=1e-5)


def test_transform_image_matches_jax(rng):
    from rgie_tpu.adapt.adapter import transform_image as transform_j

    raw = rng.uniform(0, 1, (40, 52, 3)).astype(np.float32)
    got = transform_image(raw, 32)
    assert got.shape == (1, 32, 32, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(transform_j(raw, 32)))


def test_pipeline_raises_for_later_slices(stacks):
    import dataclasses

    with pytest.raises(NotImplementedError, match="slice C2"):
        dataclasses.replace(stacks["pipe"], scheduler_type="dpm")


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def _feed(root, rng, n=2):
    from PIL import Image

    os.makedirs(root / "annotations")
    os.makedirs(root / "images")
    captions = {}
    for i in range(n):
        arr = (rng.uniform(0, 1, (40, 48, 3)) * 255).astype(np.uint8)
        Image.fromarray(arr).save(root / "images" / f"{i + 1:012d}.jpg")
        captions[str(i + 1)] = f"image {i}/a second caption"
    with open(root / "annotations" / "captions.json", "w") as f:
        json.dump(captions, f)
    return root


@pytest.mark.parametrize("extra", [["--reference-value", "0.1"],
                                   ["--no-nto", "--remat", "--end-iteration", "2"],
                                   ["--remat", "--remat-mode", "call", "--limit", "1"]])
def test_cli_edits_images_on_cpu(tmp_path, rng, capsys, extra):
    from rgie_tpu_torch.cli.adapt_images import main

    data, out = _feed(tmp_path / "data", rng), tmp_path / "out"
    main(["--data-dir", str(data), "--out-dir", str(out), "--scale", "tiny", "--num-steps", "3",
          "--input-size", "32", "--device", "cpu"] + extra)
    n = 1 if "--limit" in extra else 2
    written = sorted(os.listdir(out / "CG_CFG_2_0.2"))
    assert written == [f"{i + 1:012d}.jpg" for i in range(n)]
    from PIL import Image

    assert Image.open(out / "CG_CFG_2_0.2" / written[0]).size == (32, 32)
    printed = capsys.readouterr().out
    assert printed.count("Score original:") == n and printed.count("Score adapted:") == n
    assert printed.count("Reconstruction error:") == n


def test_cli_device_cuda_raises_without_cuda(tmp_path, monkeypatch):
    from rgie_tpu_torch.cli.adapt_images import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--data-dir", str(tmp_path), "--out-dir", str(tmp_path / "out"), "--scale", "tiny"])
    assert not os.path.exists(tmp_path / "out")


@pytest.mark.parametrize("flags,slice_name", [
    (["--scale", "sdxl"], "slice C2"), (["--scheduler", "dpm"], "slice C2"),
    (["--batch", "4"], "slice C2"), (["--segment", "5"], "slice C2"),
    (["--vae-tile", "64"], "slice C2"), (["--diffusers-dir", "/nowhere"], "slice C2")])
def test_cli_flags_of_later_slices_raise(tmp_path, flags, slice_name):
    from rgie_tpu_torch.cli.adapt_images import main

    with pytest.raises(NotImplementedError, match=slice_name):
        main(["--data-dir", str(tmp_path), "--device", "cpu"] + flags)
