"""The DPM-Solver++ 2M schedules and steps of the port (the alphas-table step,
the karras/lu sigma tables and the sigma-space step) against
``rgie_tpu.diffusion.schedulers`` on the CPU; then table-DPM inversion and
sampling of the tiny SD stack through the pipeline and the adapter, at the
tolerances of test_torch_sdxl_edit.py.

Tolerances: the tables are built in numpy float64 on both sides, so the
timesteps and the lengths after the inverse dedup are equal and the float32
sigmas agree to 1e-6 relative; a step agrees to float32 rounding: atol 1e-6,
rtol 1e-6 on values of order 1 (at the scale of the step's x0 prediction,
which is the larger term of the update).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgie_tpu.diffusion import schedulers as S_j
from rgie_tpu_torch.diffusion import schedulers as S
from tests import test_torch_sdxl_edit as E

torch.set_num_threads(2)


def _state_j(state):
    return S_j.DpmState(prev_x0=jnp.asarray(state.prev_x0.numpy()),
                        prev_lambda=jnp.asarray(state.prev_lambda.numpy()),
                        has_prev=jnp.asarray(bool(state.has_prev)))


def _assert_same_step(out, out_j, msg):
    """One step's output and carry alike. The update is the difference of
    two terms of the size of the x0 prediction, which is up to 1/sqrt(alpha)
    ~ 14 times the sample near t = 1000: values are compared at the scale of
    the larger of 1 and that prediction's largest entry."""
    (x, state), (x_j, state_j) = out, out_j
    scale = max(1.0, float(np.abs(np.asarray(state_j.prev_x0)).max()))
    np.testing.assert_allclose(x.numpy() / scale, np.asarray(x_j) / scale, atol=1e-6, rtol=1e-6,
                               err_msg=msg)
    np.testing.assert_allclose(state.prev_x0.numpy() / scale, np.asarray(state_j.prev_x0) / scale,
                               atol=1e-6, rtol=1e-6, err_msg=msg)
    np.testing.assert_allclose(float(state.prev_lambda), float(state_j.prev_lambda), atol=1e-6,
                               rtol=1e-6, err_msg=msg)
    assert bool(state.has_prev) and state.has_prev.dtype == torch.bool


def _unit(x):
    """The carry rescaled to a largest entry of 1, so that every step is held
    at values of order 1 whatever the direction (a step from t near 1000
    divides by sqrt(alphas_cumprod[t]) ~ 0.07)."""
    return x / x.abs().max()


@pytest.mark.parametrize("steps", [4, 50])
@pytest.mark.parametrize("direction", ["forward", "ascending"])
def test_dpm_step_matches_jax(rng, steps, direction):
    """Every step of a forward (sampling) and an ascending (inversion, with the
    source step before the first negative) table. Each step gets the same
    inputs in both packages: the port's carry, first order at the first step
    and second order after it."""
    sched, sched_j = S.make_schedule(steps), S_j.make_schedule(steps)
    dt = 1000 // steps
    if direction == "forward":
        ts = sched.timesteps.tolist()
        pairs = list(zip(ts, ts[1:] + [ts[-1] - dt]))
    else:
        ts = S.inverse_timesteps(sched).tolist()
        pairs = list(zip([ts[0] - dt] + ts[:-1], ts))
    x = torch.from_numpy(rng.standard_normal((2, 8, 8, 4)).astype(np.float32))
    state = S.dpm_init_state(x.shape)
    assert not bool(state.has_prev)
    for t, t_next in pairs:
        eps = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
        out = S.dpm_step(sched, eps, t, t_next, x, state)
        out_j = S_j.dpm_step(sched_j, jnp.asarray(eps.numpy()), jnp.asarray(t),
                             jnp.asarray(t_next), jnp.asarray(x.numpy()), _state_j(state))
        _assert_same_step(out, out_j, f"{t} -> {t_next}")
        x, state = _unit(out[0]), out[1]._replace(prev_x0=_unit(out[1].prev_x0))


SIGMA_SETTINGS = {
    "karras": dict(use_karras_sigmas=True),
    "lu": dict(use_karras_sigmas=False, use_lu_lambdas=True),
    "karras_lu": dict(use_karras_sigmas=True, use_lu_lambdas=True),
    "uniform": dict(use_karras_sigmas=False),
    "karras_inverse": dict(use_karras_sigmas=True, inverse=True),
    "karras_lu_inverse": dict(use_karras_sigmas=True, use_lu_lambdas=True, inverse=True),
    "lu_inverse": dict(use_karras_sigmas=False, use_lu_lambdas=True, inverse=True),
    "karras_exact": dict(use_karras_sigmas=True, diffusers_exact=True),
    "lu_exact": dict(use_karras_sigmas=False, use_lu_lambdas=True, diffusers_exact=True),
    "karras_lu_inverse_exact": dict(use_karras_sigmas=True, use_lu_lambdas=True, inverse=True,
                                    diffusers_exact=True),
    "karras_exact_linspace": dict(use_karras_sigmas=True, diffusers_exact=True,
                                  timestep_spacing="linspace"),
}


@pytest.mark.parametrize("steps", [10, 200])
@pytest.mark.parametrize("setting", list(SIGMA_SETTINGS))
def test_make_dpm_sigma_schedule_matches_jax(steps, setting):
    kw = SIGMA_SETTINGS[setting]
    sched, sched_j = S.make_dpm_sigma_schedule(steps, **kw), S_j.make_dpm_sigma_schedule(steps,
                                                                                        **kw)
    assert sched.num_inference_steps == sched_j.num_inference_steps
    assert sched.timesteps.shape[0] == sched.num_inference_steps
    assert sched.sigmas.shape[0] == sched.num_inference_steps + 1
    np.testing.assert_array_equal(sched.timesteps.numpy(), np.asarray(sched_j.timesteps))
    np.testing.assert_allclose(sched.sigmas.numpy(), np.asarray(sched_j.sigmas), rtol=1e-6)
    assert sched.sigmas.dtype == torch.float32 and sched.timesteps.dtype == torch.int64
    if kw.get("inverse") and steps == 200:
        assert sched.num_inference_steps < steps         # the dedup shortened the inversion
    if not kw.get("inverse"):
        assert float(sched.sigmas[-1]) == 0.0


def test_make_dpm_sigma_schedule_rejects_unknown_spacing():
    with pytest.raises(ValueError, match="timestep_spacing"):
        S.make_dpm_sigma_schedule(10, diffusers_exact=True, timestep_spacing="trailing")


def test_sigma_helpers_match_jax():
    train, train_j = S._training_sigmas(), S_j._training_sigmas()
    np.testing.assert_array_equal(train, train_j)
    np.testing.assert_array_equal(S.karras_sigmas(0.03, 14.6, 9),
                                  S_j.karras_sigmas(0.03, 14.6, 9))
    np.testing.assert_array_equal(S.lu_lambdas(-3.5, 2.7, 9), S_j.lu_lambdas(-3.5, 2.7, 9))
    sig = np.asarray([train[0], train[137], np.exp(0.5 * np.log(train[400] * train[401])), 0.0])
    np.testing.assert_array_equal(S._sigma_to_t(sig, np.log(train)),
                                  S_j._sigma_to_t(sig, np.log(train)))
    for s in (0.0, 0.03, 1.0, 14.6):
        got = S._vp_from_sigma(torch.tensor(s, dtype=torch.float32))
        expect = S_j._vp_from_sigma(jnp.asarray(s, jnp.float32))
        for a, b in zip(got, expect):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-6)


@pytest.mark.parametrize("setting", ["karras_lu", "karras_lu_inverse", "lu",
                                     "karras_lu_inverse_exact"])
def test_dpm_sigma_step_matches_jax(rng, setting):
    """Every step of a sigma table, with the same inputs in both packages (as
    in test_dpm_step_matches_jax)."""
    sched = S.make_dpm_sigma_schedule(6, **SIGMA_SETTINGS[setting])
    sched_j = S_j.make_dpm_sigma_schedule(6, **SIGMA_SETTINGS[setting])
    x = torch.from_numpy(rng.standard_normal((1, 8, 8, 4)).astype(np.float32))
    state = S.dpm_init_state(x.shape)
    for i in range(sched.num_inference_steps):
        eps = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
        out = S.dpm_sigma_step(sched, eps, i, x, state)
        out_j = S_j.dpm_sigma_step(sched_j, jnp.asarray(eps.numpy()), jnp.asarray(i),
                                   jnp.asarray(x.numpy()), _state_j(state))
        _assert_same_step(out, out_j, str(i))
        x, state = _unit(out[0]), out[1]._replace(prev_x0=_unit(out[1].prev_x0))


def test_dpm_sigma_step_terminal_limit_matches_jax(rng):
    """Stepping to sigma 0 collapses to the x0 prediction, in both packages."""
    sched, sched_j = S.make_dpm_sigma_schedule(4), S_j.make_dpm_sigma_schedule(4)
    x = rng.standard_normal((1, 4, 4, 4)).astype(np.float32)
    eps = rng.standard_normal((1, 4, 4, 4)).astype(np.float32)
    i = 3   # last step: sigmas[3] -> sigmas[4] == 0
    out, state = S.dpm_sigma_step(sched, torch.from_numpy(eps), i, torch.from_numpy(x),
                                  S.dpm_init_state(x.shape))
    out_j, _ = S_j.dpm_sigma_step(sched_j, jnp.asarray(eps), jnp.asarray(i), jnp.asarray(x),
                                  S_j.dpm_init_state(x.shape))
    sig = float(sched.sigmas[i])
    alpha = 1.0 / np.sqrt(1 + sig * sig)
    x0 = (x - sig * alpha * eps) / alpha
    np.testing.assert_allclose(out.numpy(), x0, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(state.prev_x0.numpy(), x0, rtol=1e-4, atol=1e-5)


def test_dpm_sigma_round_trip_matches_jax(rng):
    """A constant-eps 'model': inversion (ascending) then sampling
    (descending) retraces itself to within the final collapse-to-x0 distance,
    and every latent agrees with the JAX package's."""
    steps = 6
    fwd, inv = S.make_dpm_sigma_schedule(steps), S.make_dpm_sigma_schedule(steps, inverse=True)
    fwd_j = S_j.make_dpm_sigma_schedule(steps)
    inv_j = S_j.make_dpm_sigma_schedule(steps, inverse=True)
    x0 = (rng.standard_normal((1, 4, 4, 4)) * 0.2).astype(np.float32)
    eps = (rng.standard_normal((1, 4, 4, 4)) * 0.1).astype(np.float32)
    eps_t, eps_j = torch.from_numpy(eps), jnp.asarray(eps)

    x, x_j = torch.from_numpy(x0), jnp.asarray(x0)
    for sched, sched_j in ((inv, inv_j), (fwd, fwd_j)):
        st, st_j = S.dpm_init_state(x.shape), S_j.dpm_init_state(x_j.shape)
        for i in range(sched.num_inference_steps):
            x, st = S.dpm_sigma_step(sched, eps_t, i, x, st)
            x_j, st_j = S_j.dpm_sigma_step(sched_j, eps_j, jnp.asarray(i), x_j, st_j)
            np.testing.assert_allclose(x.numpy(), np.asarray(x_j), atol=1e-6, rtol=1e-6)
        if sched is inv:
            assert float((x - torch.from_numpy(x0)).abs().mean()) > 0.5 * float(np.abs(x0).mean())
    bound = 2.0 * float(fwd.sigmas[-2]) * float(np.abs(eps).mean()) + 1e-3
    assert float((x - torch.from_numpy(x0)).abs().mean()) < bound


def test_scheduler_guidance_scaling_matches_jax():
    sched, sched_j = S.make_schedule(10), S_j.make_schedule(10)
    for t in (-5, 0, 501, 999):
        got = float(S.scheduler_guidance_scaling(sched, t, 0.7))
        expect = float(S_j.scheduler_guidance_scaling(sched_j, jnp.asarray(t), 0.7))
        assert got == pytest.approx(expect, rel=1e-6), t


# ---------------------------------------------------------------------------
# Table DPM (alphas table) on the SD stack
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sd_dpm_stack():
    g = torch.Generator().manual_seed(2)
    unet = E._randomize_biases(E.create_unet(g, E.UNetConfig.tiny()), g, 0.02)
    vae = E._randomize_biases(E.V.create_vae(g, E.V.VaeConfig.tiny()), g, 0.02)
    midu = E._randomize_biases(E.create_midu(g, in_channels=16), g)
    enc = E.TE.create_sd_prompt_encoder(g, E.TE.TextTowerConfig.tiny())
    pipe = E.InversionResamplingPipeline(unet=unet, vae=vae, sched=S.make_schedule(E.STEPS),
                                         midu_model=midu, scheduler_type="dpm")
    image = np.random.default_rng(6).uniform(0, 1, (1, 32, 32, 3)).astype(np.float32)
    return pipe, enc, image


def test_table_dpm_tables_and_inversion_match_jax(sd_dpm_stack):
    """The inversion's tables (each step's source timestep is the previous
    step's target, the first one dt before the first) and its pivots."""
    pipe, enc, image = sd_dpm_stack
    pipe_j, params_j = E.jax_pipeline(pipe)
    enc_j = E.jax_prompt_encoder(enc)
    for end in (None, 2):
        for got, expect in zip(pipe.invert_tables(end), pipe_j.invert_tables(end)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(expect))
    ts, src_ts, _ = pipe.invert_tables()
    assert src_ts[0] == ts[0] - 1000 // E.STEPS and (src_ts[1:] == ts[:-1]).all()
    latents = pipe.encode_image(torch.from_numpy(image))
    empty = enc.encode_sd("", "", do_cfg=False)
    noisy, pivots = pipe.reverse_sample(latents, empty)
    _, pivots_j = jax.jit(pipe_j.reverse_sample)(
        params_j, pipe_j.encode_image(params_j, jnp.asarray(image)),
        enc_j.encode_sd("", "", do_cfg=False))
    assert pivots.shape[0] == E.STEPS + 1
    np.testing.assert_allclose(pivots.numpy(), np.asarray(pivots_j), atol=2e-5)


def test_table_dpm_edit_matches_jax(sd_dpm_stack):
    """Table-DPM inversion and sampling of the SD stack end to end, with
    null-text optimization (the DDIM step) and classifier guidance."""
    pipe, enc, image = sd_dpm_stack
    run = E.run_edit_pair(pipe, enc, image)
    outputs, log = run["port"]
    pipe_j, params_j = run["pipe_j"], run["params_j"]
    # the guided latents on their own, from the same inputs
    embeds = enc.encode_sd("a photo of a dog happy", "", do_cfg=True)
    embeds_j = E.jax_prompt_encoder(enc).encode_sd("a photo of a dog happy", "", do_cfg=True)
    nto = log.tensors["nto_embeds"]
    got = pipe.sample(log.tensors["noisy"], embeds, guidance_scale=2.0, guidance_clf_scale=0.2,
                      uncond_embeds_per_step=nto)
    expect = jax.jit(pipe_j.sample, static_argnames=("guidance_scale", "guidance_clf_scale"))(
        params_j, jnp.asarray(log.tensors["noisy"].numpy()), embeds_j, guidance_scale=2.0,
        guidance_clf_scale=0.2, uncond_embeds_per_step=jnp.asarray(nto.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=5e-4)
    assert len(log.clf_grad_norms) == E.STEPS
    np.testing.assert_allclose(outputs["a"].numpy(), np.asarray(run["jax"]["a"]), atol=1e-3)
