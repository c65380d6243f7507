"""Plain diffusion schedules: DDIM over diffusers' "leading" timesteps
(scaled-linear betas 0.00085-0.012, 1000 training steps, offset 1,
``set_alpha_to_one`` false) and DPM-Solver++ 2M over karras sigmas, forward
and inverse (rounded inverse timesteps deduplicated, the clean latent
entering at the first sigma). Tables are float32 on the host; every step is
float32 arithmetic on the sample's device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

T_TRAIN = 1000


def alphas_cumprod() -> np.ndarray:
    betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, T_TRAIN, dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas).astype(np.float32)


class Ddim:
    """DDIM with eta 0, the reference pipeline's own step
    (InversionResamplingDiffusionPipeline.py:269-278), and its inverse."""

    def __init__(self, steps: int):
        self.steps = steps
        self.acp = torch.from_numpy(alphas_cumprod())
        self.final = self.acp[0]
        self.dt = T_TRAIN // steps
        base = (np.arange(steps) * self.dt).round().astype(np.int64)
        self.timesteps = [int(t) for t in base[::-1] + 1]   # sampling, descending
        self.inverse_timesteps = [int(t) for t in base]    # inversion, ascending

    def alpha(self, t: int, fallback: torch.Tensor) -> torch.Tensor:
        return self.acp[t] if t >= 0 else fallback

    def step(self, eps: torch.Tensor, t: int, x: torch.Tensor) -> torch.Tensor:
        a_t, a_prev = self.alpha(t, self.final), self.alpha(t - self.dt, self.final)
        x0 = (x - torch.sqrt(1 - a_t) * eps) / torch.sqrt(a_t)
        return torch.sqrt(a_prev) * x0 + torch.sqrt(1 - a_prev) * eps

    def inverse_step(self, eps: torch.Tensor, t: int, x: torch.Tensor) -> torch.Tensor:
        a_s, a_t = self.alpha(t - self.dt, self.acp[0]), self.alpha(t, self.final)
        x0 = (x - torch.sqrt(1 - a_s) * eps) / torch.sqrt(a_s)
        return torch.sqrt(a_t) * x0 + torch.sqrt(1 - a_t) * eps


class DpmState(NamedTuple):
    prev_x0: Optional[torch.Tensor]
    prev_lambda: torch.Tensor


def _sigma_to_t(sigma: np.ndarray, log_sigmas: np.ndarray) -> np.ndarray:
    log_sigma = np.log(np.maximum(sigma, 1e-10))
    dists = log_sigma[..., None] - log_sigmas[None, :]
    low = np.clip((dists >= 0).cumsum(axis=-1).argmax(axis=-1), 0, log_sigmas.shape[0] - 2)
    lo, hi = log_sigmas[low], log_sigmas[low + 1]
    w = np.clip((lo - log_sigma) / (lo - hi), 0, 1)
    return (1 - w) * low + w * (low + 1)


class KarrasDpm:
    """DPM-Solver++ 2M over karras sigmas spanning the training range (rho 7).
    Step i moves sigmas[i] -> sigmas[i + 1]; ``timesteps`` are the rounded
    timesteps the UNet is conditioned on."""

    def __init__(self, steps: int, inverse: bool = False):
        acp = alphas_cumprod().astype(np.float64)
        train = np.sqrt((1.0 - acp) / acp)
        ramp = np.linspace(0, 1, steps)
        lo, hi = train[0] ** (1 / 7.0), train[-1] ** (1 / 7.0)
        sig = (hi + ramp * (lo - hi)) ** 7.0
        ts = _sigma_to_t(sig, np.log(train)).round().astype(np.int64)
        if inverse:
            sig, ts = sig[::-1], ts[::-1]
            _, keep = np.unique(ts, return_index=True)
            keep = np.sort(keep)
            sig, ts = sig[keep], ts[keep]
            sigmas = np.concatenate([sig[:1], sig])
        else:
            sigmas = np.concatenate([sig, [0.0]])
        self.sigmas = torch.from_numpy(sigmas.astype(np.float32))
        self.timesteps = [int(t) for t in ts]

    def init_state(self) -> DpmState:
        return DpmState(None, torch.zeros(()))

    @staticmethod
    def _vp(sigma: torch.Tensor):
        alpha = 1.0 / torch.sqrt(1.0 + sigma * sigma)
        sig_t = sigma * alpha
        return alpha, sig_t, torch.log(alpha) - torch.log(torch.clamp(sig_t, min=1e-10))

    def step(self, eps: torch.Tensor, i: int, x: torch.Tensor, state: DpmState):
        alp_s, sig_s, lam_s = self._vp(self.sigmas[i])
        alp_t, sig_t, lam_t = self._vp(self.sigmas[i + 1])
        x0 = (x - sig_s * eps) / alp_s
        h = lam_t - lam_s
        d = x0
        if state.prev_x0 is not None:
            r = (lam_s - state.prev_lambda) / (h if float(h) != 0 else torch.ones_like(h))
            r = r if abs(float(r)) >= 1e-8 else torch.ones_like(r)
            d = (1.0 + 1.0 / (2.0 * r)) * x0 - (1.0 / (2.0 * r)) * state.prev_x0
        x_next = (sig_t / torch.clamp(sig_s, min=1e-10)) * x - alp_t * torch.expm1(-h) * d
        return x_next, DpmState(x0, lam_s)
