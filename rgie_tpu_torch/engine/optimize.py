"""The per-image Adam edit loop. Port of ``rgie_tpu/engine/optimize.py``
(reference: optimize_image.py:56-97).

The JAX package scans the loop into one XLA program; here it is a Python
loop over ``torch.optim.Adam`` that never reads a value back to the host,
so the device runs ahead of it. A batch of B images is one ``(B, 41)``
parameter tensor whose per-image losses are summed for the backward pass:
exact, because the frozen models run in eval mode (no batch coupling) and
Adam works element by element.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from rgie_tpu.config import OptimizeConfig


def lr_ramp_schedule(learning_rate: float, num_steps: int,
                     rampdown_length: float = 0.25,
                     rampup_length: float = 0.05) -> Callable[[int], float]:
    """The reference's cosine ramp (optimize_image.py:68-73): t = step/N;
    lr * cos-eased min(1, (1-t)/down) * min(1, t/up)."""

    def schedule(step: int) -> float:
        t = step / num_steps
        ramp = min(1.0, (1.0 - t) / rampdown_length)
        ramp = 0.5 - 0.5 * math.cos(ramp * math.pi)
        return learning_rate * ramp * min(1.0, t / rampup_length)

    return schedule


class OptResult(NamedTuple):
    """Per image: best_x (B, 41), best_loss (B,), best_step (B,),
    first_loss (B,), last_x (B, 41), losses (B, num_steps)."""

    best_x: torch.Tensor
    best_loss: torch.Tensor
    best_step: torch.Tensor
    first_loss: torch.Tensor
    last_x: torch.Tensor
    losses: torch.Tensor


def optimize(objective: Callable[[torch.Tensor], torch.Tensor],
             x0: torch.Tensor, cfg: OptimizeConfig) -> OptResult:
    """Run the Adam edit loop. ``objective`` maps x (B, 41) -> per-image
    losses (B,).

    Semantics of optimize_image.py:56-97: the loss at step k is evaluated at
    x_k before the update; best-x is the argmin of those evaluations, with a
    strict ``<``; update k uses lr(k), k counted from 0, so lr(0) = 0 and the
    first update moves nothing (Adam's moments still take its gradient)."""
    sched = lr_ramp_schedule(cfg.learning_rate, cfg.num_steps,
                             cfg.lr_rampdown_length, cfg.lr_rampup_length)
    x = x0.detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([x], lr=0.0, betas=(cfg.adam_b1, cfg.adam_b2), eps=cfg.adam_eps)
    best_x = x0.detach().clone()
    best_loss = torch.full(x0.shape[:1], math.inf, dtype=x0.dtype, device=x0.device)
    best_step = torch.zeros(x0.shape[:1], dtype=torch.int64, device=x0.device)
    losses = []
    for step in range(cfg.num_steps):
        loss = objective(x)
        opt.zero_grad(set_to_none=True)
        loss.sum().backward()
        with torch.no_grad():
            loss = loss.detach()
            better = loss < best_loss
            best_x = torch.where(better[:, None], x, best_x)
            best_loss = torch.where(better, loss, best_loss)
            best_step = torch.where(better, step, best_step)
        opt.param_groups[0]["lr"] = sched(step)
        opt.step()
        losses.append(loss)
    losses = torch.stack(losses, dim=-1)
    return OptResult(best_x=best_x, best_loss=best_loss, best_step=best_step,
                     first_loss=losses[:, 0], last_x=x.detach(), losses=losses)


def optimize_gradient_free(objective: Callable[[np.ndarray], float],
                           x0: np.ndarray, verbose: bool = False,
                           maxiter: int = None):
    """Nelder-Mead on the host (reference: optimize_image.py:126-148); each
    evaluation of ``objective`` is one call into the device."""
    from scipy.optimize import minimize

    neval = [0]

    def wrapped(x):
        loss = float(objective(np.asarray(x, dtype=np.float32)))
        neval[0] += 1
        if verbose:
            print(f"[{neval[0]}] [loss:{loss: 3.6f}]")
        return loss

    options = {"disp": verbose}
    if maxiter is not None:
        options["maxiter"] = maxiter
    result = minimize(wrapped, np.asarray(x0, dtype=np.float64).ravel(),
                      method="Nelder-Mead", options=options)
    return np.asarray(result.x, dtype=np.float32), result
