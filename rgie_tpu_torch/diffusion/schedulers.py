"""Diffusion schedulers as pure functions: DDIM and its inverse. Port of the
DDIM part of ``rgie_tpu/diffusion/schedulers.py`` (the DPM-Solver++ tables
and steps come with slice C2).

A schedule is an immutable tuple of precomputed float32 tables kept on the
CPU; a step is a pure function of (schedule, model_output, timestep, sample).
The table entries a step reads are 0-dim CPU tensors, which PyTorch treats as
scalars against tensors on any device, so stepping never waits for the card.

Conventions (diffusers-compatible, SD/SDXL configs): scaled_linear betas
(beta_start 0.00085, beta_end 0.012, 1000 train steps), epsilon prediction,
"leading" timestep spacing with steps_offset 1, set_alpha_to_one=False.
"""

from __future__ import annotations

from typing import NamedTuple

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
