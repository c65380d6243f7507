"""Diffusion schedulers as pure functions: DDIM (+inverse) and DPM-Solver++
2M multistep (+inverse), over the alphas table or over explicit karras/lu
sigma tables. Port of ``rgie_tpu/diffusion/schedulers.py``.

A schedule is an immutable tuple of precomputed float32 tables kept on the
CPU; a step is a pure function of (schedule, model_output, timestep, sample).
The table entries a step reads are 0-dim CPU tensors, which PyTorch treats as
scalars against tensors on any device, so stepping never waits for the card.
The DPM carry (``DpmState``) lives on the sample's device.

Conventions (diffusers-compatible, SD/SDXL configs): scaled_linear betas
(beta_start 0.00085, beta_end 0.012, 1000 train steps), epsilon prediction,
"leading" timestep spacing with steps_offset 1, set_alpha_to_one=False.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


class DiffusionSchedule(NamedTuple):
    alphas_cumprod: torch.Tensor       # (T,) float32
    final_alpha_cumprod: torch.Tensor  # () float32
    timesteps: torch.Tensor            # (S,) int64, descending (sampling order)
    num_train_timesteps: int
    num_inference_steps: int


def make_alphas_cumprod(num_train_timesteps: int = 1000, beta_start: float = 0.00085,
                        beta_end: float = 0.012, schedule: str = "scaled_linear") -> np.ndarray:
    if schedule == "scaled_linear":
        betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                            num_train_timesteps, dtype=np.float64) ** 2
    elif schedule == "linear":
        betas = np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
    else:
        raise ValueError(schedule)
    return np.cumprod(1.0 - betas).astype(np.float32)


def make_schedule(num_inference_steps: int, num_train_timesteps: int = 1000,
                  beta_start: float = 0.00085, beta_end: float = 0.012,
                  beta_schedule: str = "scaled_linear", steps_offset: int = 1,
                  set_alpha_to_one: bool = False) -> DiffusionSchedule:
    """'leading' spacing (the diffusers default for SD's DDIM config):
    timesteps = round(arange(S) * T/S)[::-1] + offset."""
    acp = make_alphas_cumprod(num_train_timesteps, beta_start, beta_end, beta_schedule)
    step_ratio = num_train_timesteps // num_inference_steps
    ts = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1].astype(np.int64)
    ts = ts + steps_offset
    final = np.float32(1.0) if set_alpha_to_one else acp[0]
    return DiffusionSchedule(
        alphas_cumprod=torch.from_numpy(acp),
        final_alpha_cumprod=torch.tensor(final, dtype=torch.float32),
        timesteps=torch.from_numpy(ts.copy()),
        num_train_timesteps=num_train_timesteps,
        num_inference_steps=num_inference_steps,
    )


def inverse_timesteps(sched: DiffusionSchedule) -> torch.Tensor:
    """DDIMInverseScheduler spacing: ascending leading timesteps WITHOUT the
    offset (diffusers rounds arange(S)*T/S)."""
    step_ratio = sched.num_train_timesteps // sched.num_inference_steps
    ts = (np.arange(0, sched.num_inference_steps) * step_ratio).round().astype(np.int64)
    return torch.from_numpy(ts)


def _alpha_at(sched: DiffusionSchedule, t, fallback: torch.Tensor) -> torch.Tensor:
    """alphas_cumprod[t] with t possibly out of range -> fallback (a negative
    t, the step before the first, reads the fallback)."""
    t = torch.as_tensor(t, dtype=torch.int64)
    safe_t = torch.clamp(t, 0, sched.num_train_timesteps - 1)
    return torch.where(t >= 0, sched.alphas_cumprod[safe_t], fallback)


def pred_original(sample: torch.Tensor, eps: torch.Tensor, alpha_prod: torch.Tensor
                  ) -> torch.Tensor:
    """x0 = (x_t - sqrt(1-a) eps) / sqrt(a) (epsilon prediction)."""
    return (sample - torch.sqrt(1.0 - alpha_prod) * eps) / torch.sqrt(alpha_prod)


def ddim_step(sched: DiffusionSchedule, eps: torch.Tensor, timestep, sample: torch.Tensor
              ) -> torch.Tensor:
    """Deterministic DDIM x_t -> x_{t-dt} (eta=0), matching the reference's
    explicit prev_step (InversionResamplingDiffusionPipeline.py:269-278)."""
    dt = sched.num_train_timesteps // sched.num_inference_steps
    timestep = torch.as_tensor(timestep, dtype=torch.int64)
    a_t = _alpha_at(sched, timestep, sched.final_alpha_cumprod)
    a_prev = _alpha_at(sched, timestep - dt, sched.final_alpha_cumprod)
    x0 = pred_original(sample, eps, a_t)
    direction = torch.sqrt(1.0 - a_prev) * eps
    return torch.sqrt(a_prev) * x0 + direction


def ddim_inverse_step(sched: DiffusionSchedule, eps: torch.Tensor, timestep,
                      sample: torch.Tensor) -> torch.Tensor:
    """DDIM inversion x_{t-dt} -> x_t (diffusers DDIMInverseScheduler.step:
    at position `timestep` in the ascending pass, the transition is from
    t_inner = timestep - dt to timestep)."""
    dt = sched.num_train_timesteps // sched.num_inference_steps
    timestep = torch.as_tensor(timestep, dtype=torch.int64)
    a_s = _alpha_at(sched, timestep - dt, sched.alphas_cumprod[0])
    a_t = _alpha_at(sched, timestep, sched.final_alpha_cumprod)
    x0 = pred_original(sample, eps, a_s)
    return torch.sqrt(a_t) * x0 + torch.sqrt(1.0 - a_t) * eps


def add_noise(sched: DiffusionSchedule, sample: torch.Tensor, noise: torch.Tensor,
              timesteps: torch.Tensor) -> torch.Tensor:
    """scheduler.add_noise (used by midu training, train_guidance_clf.py:336-362)."""
    a = sched.alphas_cumprod[torch.as_tensor(timesteps, dtype=torch.int64).cpu()]
    a = a.reshape(a.shape + (1,) * (sample.ndim - a.ndim)).to(sample.device)
    return torch.sqrt(a) * sample + torch.sqrt(1.0 - a) * noise


# ---------------------------------------------------------------------------
# DPM-Solver++ (2M, multistep, deterministic)
# ---------------------------------------------------------------------------


class DpmState(NamedTuple):
    """Carry for the multistep solver: the previous x0 prediction, its lambda,
    and a flag saying whether there is one (the first step is first order)."""

    prev_x0: torch.Tensor
    prev_lambda: torch.Tensor
    has_prev: torch.Tensor  # bool, on the sample's device


def dpm_init_state(shape, dtype: torch.dtype = torch.float32,
                   device: Optional[torch.device] = None) -> DpmState:
    return DpmState(prev_x0=torch.zeros(shape, dtype=dtype, device=device),
                    prev_lambda=torch.zeros((), dtype=dtype),
                    has_prev=torch.zeros((), dtype=torch.bool, device=device))


def _lambda_sigma_alpha(sched: DiffusionSchedule, t, fallback: torch.Tensor):
    a_prod = _alpha_at(sched, t, fallback)
    alpha = torch.sqrt(a_prod)
    sigma = torch.sqrt(1.0 - a_prod)
    lam = torch.log(alpha) - torch.log(torch.clamp(sigma, min=1e-10))
    return lam, sigma, alpha


def _dpm_update(x0: torch.Tensor, sample: torch.Tensor, lam_s, lam_t, sig_s, sig_t, alp_t,
                state: DpmState) -> Tuple[torch.Tensor, DpmState]:
    """The DPM++ 2M update shared by the table and the sigma-space steps."""
    h = lam_t - lam_s
    # Second-order correction using the previous x0 (2M multistep).
    r = (lam_s - state.prev_lambda) / torch.where(h == 0, torch.ones_like(h), h)
    r = torch.where(torch.abs(r) < 1e-8, torch.ones_like(r), r)
    d_second = (1.0 + 1.0 / (2.0 * r)) * x0 - (1.0 / (2.0 * r)) * state.prev_x0
    d = torch.where(state.has_prev, d_second, x0)

    x_next = (sig_t / torch.clamp(sig_s, min=1e-10)) * sample - alp_t * torch.expm1(-h) * d
    new_state = DpmState(prev_x0=x0, prev_lambda=lam_s,
                         has_prev=torch.ones((), dtype=torch.bool, device=x0.device))
    return x_next, new_state


def dpm_step(sched: DiffusionSchedule, eps: torch.Tensor, timestep, next_timestep,
             sample: torch.Tensor, state: DpmState) -> Tuple[torch.Tensor, DpmState]:
    """One DPM++ 2M transition from ``timestep`` to ``next_timestep`` (either
    direction: descending = sampling, ascending = inversion)."""
    lam_s, sig_s, _ = _lambda_sigma_alpha(sched, timestep, sched.final_alpha_cumprod)
    lam_t, sig_t, alp_t = _lambda_sigma_alpha(sched, next_timestep, sched.final_alpha_cumprod)
    a_s = _alpha_at(sched, timestep, sched.final_alpha_cumprod)
    x0 = pred_original(sample, eps, a_s)
    return _dpm_update(x0, sample, lam_s, lam_t, sig_s, sig_t, alp_t, state)


# ---------------------------------------------------------------------------
# DPM-Solver++ 2M over EXPLICIT sigma tables: karras sigmas / lu lambdas.
#
# The reference configures the SDXL DPM path with use_karras_sigmas=True and
# use_lu_lambdas=True (``src/pipelines/InversionResamplingStableDiffusionXLPipeline.py:29-32``);
# in diffusers' DPMSolverMultistepScheduler karras takes precedence when both
# are set, and the INVERSE scheduler's rounded karras timesteps can collide at
# the dense low-sigma end: duplicates are removed, shortening the inversion.
# The tables are built on the host in numpy float64 and only then stored as
# float32 sigmas and int64 timesteps; stepping works in sigma space (the
# rounded integer timesteps only feed the UNet).
#
# DEFAULT-mode convention divergences from diffusers' DPMSolverMultistep
# scheduler pair:
#  1. The karras table interpolates the FULL training sigma range
#     (train_sig[0]..train_sig[-1], so timesteps[0]=999); diffusers versions
#     that pre-interpolate to the spacing-selected inference sigmas build
#     karras between those endpoints (e.g. sigma(980) at 50 steps).
#  2. The inverse table ends at the dedup'd karras maximum; diffusers'
#     inverse scheduler appends the training sigma_max as the final entry.
#  3. The prepended identity step (h=0) SEEDS the 2M history, so the first
#     real inverse step is second-order; diffusers' first step is
#     first-order. (Starting the table at sigma=0 instead is numerically
#     catastrophic; see make_dpm_sigma_schedule.)
#
# ``diffusers_exact=True`` switches all three to the diffusers conventions, so
# that a real checkpoint's run is step-for-step comparable to a diffusers run:
# karras/lu endpoints are taken from the timestep-spacing-selected inference
# sigma range ("leading" + steps_offset 1 is the SD/SDXL scheduler-config
# default), the inverse table appends the training sigma_max as its final
# target, and the inverse first step is first-order (no identity prepend).
# ---------------------------------------------------------------------------


class DpmSigmaSchedule(NamedTuple):
    """Sigma-space DPM schedule. ``sigmas`` has S+1 entries: sigmas[i] ->
    sigmas[i+1] is step i; the last forward sigma is 0 (final_sigmas_type
    'zero'). ``timesteps`` are the rounded UNet conditioning steps."""

    sigmas: torch.Tensor          # (S+1,) float32
    timesteps: torch.Tensor       # (S,) int64
    num_inference_steps: int


def _training_sigmas(num_train_timesteps: int = 1000, beta_start: float = 0.00085,
                     beta_end: float = 0.012, beta_schedule: str = "scaled_linear") -> np.ndarray:
    acp = make_alphas_cumprod(num_train_timesteps, beta_start, beta_end,
                              beta_schedule).astype(np.float64)
    return np.sqrt((1.0 - acp) / acp)


def karras_sigmas(sigma_min: float, sigma_max: float, steps: int, rho: float = 7.0
                  ) -> np.ndarray:
    """Karras et al. (arXiv:2206.00364) eq. 5 interpolation, descending."""
    ramp = np.linspace(0, 1, steps)
    min_inv_rho = sigma_min ** (1 / rho)
    max_inv_rho = sigma_max ** (1 / rho)
    return (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** rho


def lu_lambdas(lambda_min: float, lambda_max: float, steps: int) -> np.ndarray:
    """Lu et al. uniform-log-sigma spacing (diffusers use_lu_lambdas): linear
    interpolation of log-sigma, descending."""
    ramp = np.linspace(0, 1, steps)
    return lambda_max + ramp * (lambda_min - lambda_max)


def _sigma_to_t(sigma: np.ndarray, log_sigmas: np.ndarray) -> np.ndarray:
    """Fractional training timestep for a sigma by piecewise-linear
    interpolation of log-sigma (the diffusers _sigma_to_t)."""
    log_sigma = np.log(np.maximum(sigma, 1e-10))
    dists = log_sigma[..., None] - log_sigmas[None, :]
    low_idx = np.clip((dists >= 0).cumsum(axis=-1).argmax(axis=-1), 0,
                      log_sigmas.shape[0] - 2)
    high_idx = low_idx + 1
    low, high = log_sigmas[low_idx], log_sigmas[high_idx]
    w = np.clip((low - log_sigma) / (low - high), 0, 1)
    return (1 - w) * low_idx + w * high_idx


def make_dpm_sigma_schedule(num_inference_steps: int, num_train_timesteps: int = 1000,
                            beta_start: float = 0.00085, beta_end: float = 0.012,
                            beta_schedule: str = "scaled_linear",
                            use_karras_sigmas: bool = True, use_lu_lambdas: bool = False,
                            inverse: bool = False, diffusers_exact: bool = False,
                            timestep_spacing: str = "leading", steps_offset: int = 1
                            ) -> DpmSigmaSchedule:
    """Build the sigma/timestep tables. Forward: descending sigmas ending at
    0. Inverse: ascending sigmas, with rounded-timestep duplicates removed
    (a shorter inversion, like the diffusers inverse scheduler).
    ``diffusers_exact`` switches the three documented convention divergences
    to the diffusers ones (block comment above); ``timestep_spacing`` and
    ``steps_offset`` only matter in exact mode and default to the SD/SDXL
    scheduler-config values."""
    train_sig = _training_sigmas(num_train_timesteps, beta_start, beta_end, beta_schedule)
    log_sigmas = np.log(train_sig)
    if diffusers_exact:
        # diffusers pre-interpolates to the spacing-selected inference sigmas
        # and builds karras/lu between THOSE endpoints.
        if timestep_spacing == "leading":
            ratio = num_train_timesteps // (num_inference_steps + 1)
            ts_sel = ((np.arange(0, num_inference_steps + 1) * ratio)
                      .round()[::-1][:-1].astype(np.int64) + steps_offset)
        elif timestep_spacing == "linspace":
            ts_sel = (np.linspace(0, num_train_timesteps - 1, num_inference_steps + 1)
                      .round()[::-1][:-1].astype(np.int64))
        else:
            raise ValueError(f"unknown timestep_spacing {timestep_spacing!r}")
        in_sig = np.interp(ts_sel, np.arange(num_train_timesteps), train_sig)
        sigma_lo, sigma_hi = float(in_sig[-1]), float(in_sig[0])
    else:
        sigma_lo, sigma_hi = float(train_sig[0]), float(train_sig[-1])
    if use_karras_sigmas:
        sig = karras_sigmas(sigma_lo, sigma_hi, num_inference_steps)
    elif use_lu_lambdas:
        sig = np.exp(lu_lambdas(np.log(sigma_lo), np.log(sigma_hi), num_inference_steps))
    else:
        # uniform leading spacing in t, like make_schedule
        ratio = num_train_timesteps // num_inference_steps
        ts = (np.arange(num_inference_steps) * ratio).round()[::-1].astype(int)
        sig = train_sig[ts]
    ts = _sigma_to_t(sig, log_sigmas).round().astype(np.int64)

    if inverse:
        sig = sig[::-1]
        ts = ts[::-1]
        # Duplicate-timestep removal (keep the first occurrence).
        _, keep = np.unique(ts, return_index=True)
        keep = np.sort(keep)
        sig, ts = sig[keep], ts[keep]
        if diffusers_exact:
            # The training sigma_max is the final target; the clean latent
            # enters at sig[0] and the first step is first-order (empty 2M
            # history: diffusers' lower_order_nums warmup).
            sigmas = np.concatenate([sig, [float(train_sig[-1])]])
        else:
            # The clean latent enters at the FIRST table sigma, making step 0
            # an identity transition (h=0), like the diffusers
            # DDIMInverseScheduler's first step. Starting from sigma=0 instead
            # is numerically catastrophic: the (sigma_t/sigma_s) and
            # expm1(-h) terms both blow up to ~1e10 and their float32
            # difference loses the signal.
            sigmas = np.concatenate([sig[:1], sig])
    else:
        sigmas = np.concatenate([sig, [0.0]])
    return DpmSigmaSchedule(
        sigmas=torch.from_numpy(sigmas.astype(np.float32)),
        timesteps=torch.from_numpy(np.ascontiguousarray(ts, dtype=np.int64)),
        num_inference_steps=int(ts.shape[0]),
    )


def _vp_from_sigma(sigma: torch.Tensor):
    """Karras sigma -> VP (alpha_t, sigma_t, lambda_t): alpha = 1/sqrt(1+s^2),
    sigma_t = s * alpha (the diffusers _sigma_to_alpha_sigma_t)."""
    alpha = 1.0 / torch.sqrt(1.0 + sigma * sigma)
    sigma_t = sigma * alpha
    lam = torch.log(alpha) - torch.log(torch.clamp(sigma_t, min=1e-10))
    return alpha, sigma_t, lam


def dpm_sigma_step(sched: DpmSigmaSchedule, eps: torch.Tensor, i: int, sample: torch.Tensor,
                   state: DpmState) -> Tuple[torch.Tensor, DpmState]:
    """One DPM++ 2M transition sigmas[i] -> sigmas[i+1] (either direction).
    At the terminal sigma 0, lambda -> +inf and the update collapses to the
    x0 prediction (expm1(-h) -> -1, sigma ratio -> 0): the floats do this on
    their own with the 1e-10 log floor."""
    alp_s, sigt_s, lam_s = _vp_from_sigma(sched.sigmas[i])
    alp_t, sigt_t, lam_t = _vp_from_sigma(sched.sigmas[i + 1])
    x0 = (sample - sigt_s * eps) / alp_s
    return _dpm_update(x0, sample, lam_s, lam_t, sigt_s, sigt_t, alp_t, state)


# ---------------------------------------------------------------------------
# Guidance-scaling helper (Dhariwal-style; reference diff_utils.py:133-181,
# unused in the main path but part of the API surface)
# ---------------------------------------------------------------------------


def scheduler_guidance_scaling(sched: DiffusionSchedule, timestep, base_scale: float
                               ) -> torch.Tensor:
    """Scale classifier guidance by sqrt(1 - alphas_cumprod[t]) (the variance
    of the noise at t), as in Dhariwal & Nichol's classifier guidance."""
    a = _alpha_at(sched, timestep, sched.final_alpha_cumprod)
    return base_scale * torch.sqrt(1.0 - a)
