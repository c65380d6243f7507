"""The DDIM schedule tables and steps of the port against
``rgie_tpu.diffusion.schedulers`` on the CPU. Tables are exact; steps agree to
float32 rounding (atol 1e-6 on values of order 1)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgie_tpu.diffusion import schedulers as S_j
from rgie_tpu_torch.diffusion import schedulers as S

torch.set_num_threads(2)


@pytest.mark.parametrize("steps", [1, 4, 7, 50])
@pytest.mark.parametrize("kw", [dict(), dict(set_alpha_to_one=True, steps_offset=0),
                                dict(beta_schedule="linear", num_train_timesteps=500)])
def test_tables_match_jax(steps, kw):
    sched, sched_j = S.make_schedule(steps, **kw), S_j.make_schedule(steps, **kw)
    np.testing.assert_array_equal(sched.alphas_cumprod.numpy(), np.asarray(sched_j.alphas_cumprod))
    np.testing.assert_array_equal(sched.timesteps.numpy(), np.asarray(sched_j.timesteps))
    assert float(sched.final_alpha_cumprod) == float(sched_j.final_alpha_cumprod)
    assert sched.num_train_timesteps == sched_j.num_train_timesteps
    assert sched.num_inference_steps == sched_j.num_inference_steps == steps
    np.testing.assert_array_equal(S.inverse_timesteps(sched).numpy(),
                                  np.asarray(S_j.inverse_timesteps(sched_j)))
    assert sched.alphas_cumprod.dtype == torch.float32


def test_make_alphas_cumprod_rejects_unknown_schedule():
    with pytest.raises(ValueError):
        S.make_alphas_cumprod(schedule="cosine")


@pytest.mark.parametrize("steps", [4, 50])
def test_ddim_steps_match_jax(rng, steps):
    sched, sched_j = S.make_schedule(steps), S_j.make_schedule(steps)
    sample = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    eps = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    dt = 1000 // steps
    # every sampling timestep, plus the inversion's first (0, whose source
    # step is negative and reads the fallback alpha) and a step past the end
    for t in sched.timesteps.tolist() + [0, dt, 1000 - dt]:
        got = S.ddim_step(sched, torch.from_numpy(eps), t, torch.from_numpy(sample)).numpy()
        expect = S_j.ddim_step(sched_j, jnp.asarray(eps), jnp.asarray(t), jnp.asarray(sample))
        np.testing.assert_allclose(got, np.asarray(expect), atol=1e-6, rtol=1e-6, err_msg=str(t))
        got = S.ddim_inverse_step(sched, torch.from_numpy(eps), t,
                                  torch.from_numpy(sample)).numpy()
        expect = S_j.ddim_inverse_step(sched_j, jnp.asarray(eps), jnp.asarray(t),
                                       jnp.asarray(sample))
        np.testing.assert_allclose(got, np.asarray(expect), atol=1e-6, rtol=1e-6, err_msg=str(t))


def test_alpha_at_falls_back_below_zero():
    sched, sched_j = S.make_schedule(10), S_j.make_schedule(10)
    for t in (-100, -1, 0, 1, 999, 1500):
        got = float(S._alpha_at(sched, t, sched.final_alpha_cumprod))
        expect = float(S_j._alpha_at(sched_j, jnp.asarray(t), sched_j.final_alpha_cumprod))
        assert got == expect, t
    ts = torch.tensor([-5, 3, 400])
    got = S._alpha_at(sched, ts, torch.tensor(0.25)).numpy()
    expect = S_j._alpha_at(sched_j, jnp.asarray(ts.numpy()), jnp.asarray(0.25))
    np.testing.assert_array_equal(got, np.asarray(expect))


def test_ddim_step_inverts_the_inverse_step(rng):
    """x_t from the inverse step, stepped back with the same eps, returns the
    sample (the identity the null-text optimization leans on)."""
    sched = S.make_schedule(10)
    sample = torch.from_numpy(rng.standard_normal((1, 4, 4, 4)).astype(np.float32))
    eps = torch.from_numpy(rng.standard_normal((1, 4, 4, 4)).astype(np.float32))
    t = 301
    noisy = S.ddim_inverse_step(sched, eps, t, sample)
    np.testing.assert_allclose(S.ddim_step(sched, eps, t, noisy).numpy(), sample.numpy(),
                               atol=1e-5)


def test_add_noise_and_pred_original_match_jax(rng):
    sched, sched_j = S.make_schedule(50), S_j.make_schedule(50)
    sample = rng.standard_normal((3, 4, 4, 4)).astype(np.float32)
    noise = rng.standard_normal((3, 4, 4, 4)).astype(np.float32)
    ts = np.asarray([0, 500, 999], np.int32)
    got = S.add_noise(sched, torch.from_numpy(sample), torch.from_numpy(noise),
                      torch.from_numpy(ts)).numpy()
    expect = S_j.add_noise(sched_j, jnp.asarray(sample), jnp.asarray(noise), jnp.asarray(ts))
    np.testing.assert_allclose(got, np.asarray(expect), atol=1e-6, rtol=1e-6)
    a = sched.alphas_cumprod[500]
    got = S.pred_original(torch.from_numpy(sample), torch.from_numpy(noise), a).numpy()
    expect = S_j.pred_original(jnp.asarray(sample), jnp.asarray(noise),
                               sched_j.alphas_cumprod[500])
    np.testing.assert_allclose(got, np.asarray(expect), atol=1e-6, rtol=1e-6)
