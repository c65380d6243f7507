"""The diffusion stack's modules against the JAX package on the CPU, tiny
configs: the UNet (``tiny`` and ``tiny_xl``: eps, mid features and the
gradient of a scalar of the mid features with respect to the latents), the
VAE (moments, latents, decode), the text tower (both activations, with and
without the projection) and the midu classifiers. Weights go port ->
``torch_convert`` -> JAX, and ``from_jax`` carries them back exactly.

Tolerances: float32 on both sides, sums in different orders; 2e-5 absolute on
outputs of order 1, 1e-4 relative on gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgie_tpu.utils import torch_convert as TC
from rgie_tpu_torch.diffusion import text_encoder as TE
from rgie_tpu_torch.diffusion import unet as U
from rgie_tpu_torch.diffusion import vae as V
from rgie_tpu_torch.models import midu as M
from rgie_tpu_torch.models.init import random_init_
from rgie_tpu_torch.utils import from_jax as FJ

torch.set_num_threads(2)


def _np_state(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def _randomize(module, seed):
    """Random weights, biases and norm scales included (the default stand-in
    init leaves biases at zero, which would hide a swapped bias)."""
    g = torch.Generator().manual_seed(seed)
    random_init_(module, g)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.ndim == 1:
                p.copy_(torch.randn(p.shape, generator=g) * 0.1 + (1.0 if "norm" in name and
                                                                  name.endswith("weight") else 0.0))
    return module.eval().requires_grad_(False)


def _assert_round_trip(module, back):
    sd = module.state_dict()
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)
    module.load_state_dict(back, strict=True)


def _jcfg(cfg, cls):
    import dataclasses

    return cls(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("name", ["tiny", "tiny_xl"])
def test_unet_matches_jax(rng, name):
    from rgie_tpu.diffusion import unet as U_j

    cfg = getattr(U.UNetConfig, name)()
    cfg_j = getattr(U_j.UNetConfig, name)()
    assert _jcfg(cfg, U_j.UNetConfig) == cfg_j
    model = _randomize(U.UNet2DCondition(cfg), 1)
    variables = jax.tree.map(jnp.asarray, TC.convert_unet_diffusers(_np_state(model), cfg_j))
    _assert_round_trip(model, FJ.unet_state_dict(variables, cfg))

    sample = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 7, cfg.cross_attention_dim)).astype(np.float32)
    t = np.asarray([3, 501], np.int32)
    kw_j, kw = {}, {}
    if name == "tiny_xl":
        text = rng.standard_normal((2, cfg.addition_pooled_dim)).astype(np.float32)
        ids = np.asarray([[64, 64, 0, 0, 64, 64]] * 2, np.float32)
        kw_j = dict(added_text_embeds=jnp.asarray(text), added_time_ids=jnp.asarray(ids))
        kw = dict(added_text_embeds=torch.from_numpy(text), added_time_ids=torch.from_numpy(ids))
    model_j = U_j.UNet2DCondition(cfg_j)

    def mid_scalar_j(x):
        eps, mid = model_j.apply(variables, x, jnp.asarray(t), jnp.asarray(ctx), **kw_j)
        return jnp.sum(jnp.sin(mid)), (eps, mid)

    (_, (eps_j, mid_j)), grad_j = jax.value_and_grad(mid_scalar_j, has_aux=True)(
        jnp.asarray(sample))

    x = torch.from_numpy(sample).requires_grad_(True)
    eps, mid = model(x, torch.from_numpy(t), torch.from_numpy(ctx), **kw)
    (grad,) = torch.autograd.grad(torch.sum(torch.sin(mid)), x)
    np.testing.assert_allclose(eps.detach().numpy(), np.asarray(eps_j), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(mid.detach().numpy(), np.asarray(mid_j), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(grad_j), atol=2e-5, rtol=1e-4)

    # Per-block recomputation and a scalar timestep change nothing.
    remat = U.UNet2DCondition(cfg, block_remat=True)
    remat.load_state_dict(model.state_dict())
    x2 = torch.from_numpy(sample).requires_grad_(True)
    eps2, mid2 = remat(x2, torch.from_numpy(t), torch.from_numpy(ctx), **kw)
    (grad2,) = torch.autograd.grad(torch.sum(torch.sin(mid2)), x2)
    np.testing.assert_allclose(eps2.detach().numpy(), eps.detach().numpy(), atol=1e-6)
    np.testing.assert_allclose(grad2.numpy(), grad.numpy(), atol=1e-6)


def test_unet_control_residuals_match_jax(rng):
    from rgie_tpu.diffusion import unet as U_j

    cfg, cfg_j = U.UNetConfig.tiny(), U_j.UNetConfig.tiny()
    model = _randomize(U.UNet2DCondition(cfg), 2)
    variables = jax.tree.map(jnp.asarray, TC.convert_unet_diffusers(_np_state(model), cfg_j))
    sample = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, 5, 32)).astype(np.float32)
    # skip stack of the tiny config: conv_in, down_0 res, down_0 downsample, down_1 res
    shapes = [(1, 8, 8, 8), (1, 8, 8, 8), (1, 4, 4, 8), (1, 4, 4, 16)]
    downs = [rng.standard_normal(s).astype(np.float32) * 0.1 for s in shapes]
    mid_r = rng.standard_normal((1, 4, 4, 16)).astype(np.float32) * 0.1
    eps_j, mid_j = U_j.UNet2DCondition(cfg_j).apply(
        variables, jnp.asarray(sample), jnp.asarray(7), jnp.asarray(ctx),
        down_residuals=[jnp.asarray(d) for d in downs], mid_residual=jnp.asarray(mid_r))
    eps, mid = model(torch.from_numpy(sample), torch.tensor(7), torch.from_numpy(ctx),
                     down_residuals=[torch.from_numpy(d) for d in downs],
                     mid_residual=torch.from_numpy(mid_r))
    np.testing.assert_allclose(eps.numpy(), np.asarray(eps_j), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(mid.numpy(), np.asarray(mid_j), atol=2e-5, rtol=1e-5)


def test_timestep_embedding_matches_jax():
    from rgie_tpu.diffusion.unet import timestep_embedding as te_j

    t = np.asarray([0, 1, 37, 999], np.int32)
    for kw in ({}, dict(flip_sin_to_cos=False, downscale_freq_shift=1.0)):
        got = U.timestep_embedding(torch.from_numpy(t), 16, **kw).numpy()
        np.testing.assert_allclose(got, np.asarray(te_j(jnp.asarray(t), 16, **kw)),
                                   atol=1e-6, rtol=1e-6)


def test_vae_matches_jax(rng):
    from rgie_tpu.diffusion import vae as V_j

    cfg, cfg_j = V.VaeConfig.tiny(), V_j.VaeConfig.tiny()
    assert _jcfg(cfg, V_j.VaeConfig) == cfg_j
    assert _jcfg(V.VaeConfig.sd(), V_j.VaeConfig) == V_j.VaeConfig.sd()
    assert _jcfg(V.VaeConfig.sdxl(), V_j.VaeConfig) == V_j.VaeConfig.sdxl()
    model = _randomize(V.AutoencoderKL(cfg), 3)
    variables = jax.tree.map(jnp.asarray, TC.convert_vae_diffusers(_np_state(model), cfg_j))
    _assert_round_trip(model, FJ.vae_state_dict(variables, cfg))
    model_j = V_j.AutoencoderKL(cfg_j)

    images = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    mean_j, logvar_j = model_j.apply(variables, jnp.asarray(images),
                                     method=V_j.AutoencoderKL.encode_moments)
    mean, logvar = model.encode_moments(torch.from_numpy(images))
    np.testing.assert_allclose(mean.numpy(), np.asarray(mean_j), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(logvar.numpy(), np.asarray(logvar_j), atol=2e-5, rtol=1e-5)
    lat_j = model_j.apply(variables, jnp.asarray(images), method=V_j.AutoencoderKL.encode)
    lat = model.encode(torch.from_numpy(images))
    assert lat.shape == (2, 16, 16, 4) and model.upscale_factor == 2
    np.testing.assert_allclose(lat.numpy(), np.asarray(lat_j), atol=2e-5, rtol=1e-5)
    dec_j = model_j.apply(variables, lat_j, method=V_j.AutoencoderKL.decode)
    dec = model.decode(torch.from_numpy(np.asarray(lat_j)))
    np.testing.assert_allclose(dec.numpy(), np.asarray(dec_j), atol=5e-5, rtol=1e-5)

    # Sampling the posterior: mean + exp(logvar / 2) * noise from the generator.
    g = torch.Generator().manual_seed(5)
    sampled = model.encode(torch.from_numpy(images), g)
    noise = torch.randn(mean.shape, generator=torch.Generator().manual_seed(5))
    expect = cfg.scaling_factor * (mean + torch.exp(0.5 * logvar) * noise)
    np.testing.assert_allclose(sampled.numpy(), expect.numpy(), atol=1e-6)


@pytest.mark.parametrize("act,skip_last,proj_dim", [("quick_gelu", 1, None), ("gelu", 0, None),
                                                     ("gelu", 1, 24)])
def test_text_tower_matches_jax(rng, act, skip_last, proj_dim):
    from rgie_tpu.diffusion import text_encoder as TE_j

    kw = dict(width=32, layers=3, heads=2, vocab_size=120, skip_last=skip_last, act=act,
              proj_dim=proj_dim)
    tower = _randomize(TE.TextEncoderHidden(**kw), 4)
    variables = jax.tree.map(jnp.asarray, TC.convert_clip_text_hf(_np_state(tower), heads=2))
    _assert_round_trip(tower, FJ.clip_text_state_dict(variables))
    tokens = rng.integers(1, 118, (2, 9)).astype(np.int32)
    tokens[0, 5], tokens[1, 8] = 119, 119    # the EOS id is the largest, once per row
    hidden_j, pooled_j = TE_j.TextEncoderHidden(**kw).apply(variables, jnp.asarray(tokens))
    hidden, pooled = tower(torch.from_numpy(tokens.astype(np.int64)))
    np.testing.assert_allclose(hidden.numpy(), np.asarray(hidden_j), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(pooled_j), atol=2e-5, rtol=1e-5)


def test_text_tower_matches_transformers(rng):
    """The tower takes an HF CLIPTextModel's state dict as it is."""
    import sys

    sys.path.insert(0, __file__.rsplit("/", 1)[0])
    from torch_twin_diffusion import make_hf_text_twin

    twin = make_hf_text_twin(width=32, layers=2, heads=2, vocab=100, hidden_act="gelu")
    tower = TE.TextEncoderHidden(width=32, layers=2, heads=2, vocab_size=100, skip_last=0,
                                 act="gelu")
    state = {k: v for k, v in twin.state_dict().items() if not k.endswith("position_ids")}
    tower.load_state_dict(state, strict=True)
    tokens = rng.integers(1, 97, (2, 11)).astype(np.int64)
    tokens[:, 0], tokens[0, 6], tokens[1, 10] = 98, 99, 99
    with torch.no_grad():
        out = twin(input_ids=torch.from_numpy(tokens))
        hidden, pooled = tower(torch.from_numpy(tokens))
    np.testing.assert_allclose(hidden.numpy(), out.last_hidden_state.numpy(), atol=2e-5)
    np.testing.assert_allclose(pooled.numpy(), out.pooler_output.numpy(), atol=2e-5)


def test_tokenize_and_prompt_encoder_match_jax():
    from rgie_tpu.diffusion import text_encoder as TE_j

    texts = ["", "a photo of a dog", "A  Photo\tof a DOG " + "word " * 90]
    np.testing.assert_array_equal(TE.tokenize(texts).numpy(), np.asarray(TE_j.tokenize(texts)))
    assert TE.TextTowerConfig.open_clip_vit_h() == TE_j.TextTowerConfig.open_clip_vit_h()
    assert TE.TextTowerConfig.clip_vit_l() == TE_j.TextTowerConfig.clip_vit_l()
    assert TE.TextTowerConfig.open_clip_big_g() == TE_j.TextTowerConfig.open_clip_big_g()

    enc = TE.create_sd_prompt_encoder(torch.Generator().manual_seed(0),
                                      TE.TextTowerConfig.tiny())
    variables = jax.tree.map(jnp.asarray, TC.convert_clip_text_hf(_np_state(enc.tower1), heads=2))
    enc_j = TE_j.PromptEncoder(tower1=TE_j.TextEncoderHidden(**TE_j.TextTowerConfig.tiny()),
                               variables1=variables)
    for do_cfg in (True, False):
        got = enc.encode_sd("a photo of a dog", "blurry", do_cfg=do_cfg)
        expect = enc_j.encode_sd("a photo of a dog", "blurry", do_cfg=do_cfg)
        assert got.shape == ((2 if do_cfg else 1), 77, 32)
        np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=2e-5, rtol=1e-5)
    with pytest.raises(NotImplementedError, match="slice C2"):
        enc.encode_sdxl("a")


@pytest.mark.parametrize("is_sdxl,hw", [(False, 8), (False, 16), (True, 32)])
def test_midu_matches_jax(rng, is_sdxl, hw):
    from rgie_tpu.models import midu as M_j

    model = _randomize((M.MiduSDXL if is_sdxl else M.MiduSD)(2, in_channels=24), 6)
    variables = jax.tree.map(jnp.asarray, TC.convert_midu(_np_state(model), is_sdxl))
    _assert_round_trip(model, FJ.midu_state_dict(variables, is_sdxl))
    model_j = (M_j.MiduSDXL if is_sdxl else M_j.MiduSD)(2)
    feats = rng.standard_normal((2, hw, hw, 24)).astype(np.float32)
    labels = rng.uniform(0, 1, (2, 2)).astype(np.float32)
    ref = np.asarray([[0.4, 0.6]], np.float32)
    for kw in (dict(), dict(is_minimized=False), dict(reference_value=ref)):
        clf_j = M_j.ValenceArousalMidu(model=model_j, variables=variables, **{
            k: (jnp.asarray(v) if k == "reference_value" else v) for k, v in kw.items()})
        clf = M.ValenceArousalMidu(model=model, **{
            k: (torch.from_numpy(v) if k == "reference_value" else v) for k, v in kw.items()})
        x = torch.from_numpy(feats)
        np.testing.assert_allclose(clf.predict(x).numpy(), np.asarray(clf_j.predict(feats)),
                                   atol=2e-5, rtol=1e-5)
        np.testing.assert_allclose(float(clf.score(x)), float(clf_j.score(feats)), rtol=1e-5)
    loss, _ = clf.loss_and_outputs(x, torch.from_numpy(labels))
    loss_j, _ = clf_j.loss_and_outputs(jnp.asarray(feats), jnp.asarray(labels))
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)


def test_guidance_scores_match_jax(rng):
    from rgie_tpu.losses import guidance_scores as GS_j
    from rgie_tpu_torch.losses import guidance_scores as GS

    pred = rng.uniform(0, 1, (3, 2)).astype(np.float32)
    for fn in ("valence_score", "arousal_score"):
        for kw in (dict(), dict(is_minimized=False), dict(reference_value=0.3)):
            got = getattr(GS, fn)(torch.from_numpy(pred), **kw).numpy()
            np.testing.assert_allclose(got, np.asarray(getattr(GS_j, fn)(jnp.asarray(pred), **kw)),
                                       rtol=1e-6)
