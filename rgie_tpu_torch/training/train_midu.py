"""Guidance-regressor (midu) training, the framework's training workload. Port
of ``rgie_tpu/training/train_midu.py``.

Reference: ``src/clf/train_guidance_clf.py:179-333``: Adam with lr 1e-5 and
L2 weight decay 5e-5, MSE on teacher VA labels, noisy latents at random
timesteps, best-validation checkpointing. The features (the frozen UNet's
mid block at the noisy latents) come from ``cli/train_guidance_clf.py``; the
step here trains the midu on them. The JAX package jits the step over a
(data, model) mesh (``shard_train_step``); the port runs it on one device
until slice F brings data parallelism.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from rgie_tpu_torch.config import TrainGuidanceConfig
from rgie_tpu_torch.parallel.mesh import all_mean


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_optimizer(params: Iterable[torch.Tensor], cfg: TrainGuidanceConfig
                   ) -> torch.optim.Adam:
    # torch's Adam(weight_decay=...) is L2-regularized Adam, NOT AdamW: the
    # decay is added to the gradient before the moments, as in the reference
    # (train_guidance_clf.py:159) and the JAX package's optax chain
    # (rgie_tpu/training/train_midu.py:37-44).
    return torch.optim.Adam(params, lr=cfg.learning_rate, weight_decay=cfg.weight_decay)


def create_train_state(model: nn.Module, cfg: TrainGuidanceConfig) -> TrainState:
    """The midu made trainable (float32, gradients on) with its optimizer."""
    model.float().train().requires_grad_(True)
    return TrainState(model=model, optimizer=make_optimizer(model.parameters(), cfg))


def _mse(out: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean((out - labels) ** 2)


def make_train_step(average_gradients: bool = False):
    """``train_step(state, features, labels) -> (state, loss, predictions)``:
    one Adam step on the MSE to the labels. With ``average_gradients`` the
    gradients and the loss are averaged over the processes before the step
    (``shard_train_step``)."""

    def train_step(state: TrainState, features: torch.Tensor, labels: torch.Tensor):
        state.optimizer.zero_grad(set_to_none=True)
        with torch.enable_grad():
            out = state.model(features)
            loss = _mse(out, labels)
            loss.backward()
        loss = loss.detach()
        if average_gradients:
            loss = _all_mean_gradients(state.model, loss)
        state.optimizer.step()
        state.step += 1
        return state, loss, out.detach()

    return train_step


def _all_mean_gradients(model: nn.Module, loss: torch.Tensor) -> torch.Tensor:
    """Every gradient of ``model`` and ``loss`` replaced by their mean over the
    processes, in one all-reduce of them all flattened; returns the mean
    loss."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    flat = all_mean(torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1).to(grads[0])]))
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    return flat[-1].to(loss.dtype)


def shard_train_step(state: TrainState):
    """The DDP counterpart of JAX's ``shard_train_step``: every rank starts
    from rank 0's midu (a broadcast of its parameters), and the step averages
    the gradients over the processes before Adam, so its update equals a
    one-process step on the union of the ranks' rows and every rank keeps
    the same midu. Returns ``(train_step, state)``; one process gets the
    plain step."""
    if not dist.is_initialized():
        return make_train_step(), state
    with torch.no_grad():
        for p in state.model.parameters():
            dist.broadcast(p, src=0)
    return make_train_step(average_gradients=True), state


def make_eval_step():
    """``eval_step(model, features, labels) -> (loss, predictions)``."""

    @torch.no_grad()
    def eval_step(model: nn.Module, features: torch.Tensor, labels: torch.Tensor):
        out = model(features)
        return _mse(out, labels), out

    return eval_step


def noisy_latents(latents: torch.Tensor, t: torch.Tensor, noise: torch.Tensor,
                  alphas_cumprod: torch.Tensor) -> torch.Tensor:
    """x_t = sqrt(a_t) x_0 + sqrt(1 - a_t) eps, ``t`` (B,) integer timesteps."""
    a = alphas_cumprod.to(latents.device)[t.to(latents.device)]
    a = a.reshape(a.shape + (1,) * (latents.ndim - 1))
    return torch.sqrt(a) * latents + torch.sqrt(1.0 - a) * noise


def get_noisy_latents(generator: torch.Generator, latents: torch.Tensor,
                      alphas_cumprod: torch.Tensor, num_train_timesteps: int = 1000
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random timesteps and scheduler noise drawn from ``generator`` on its
    device, then ``noisy_latents`` (reference: get_noisy_latents,
    train_guidance_clf.py:336-362). Returns (noisy, t)."""
    b = latents.shape[0]
    t = torch.randint(0, num_train_timesteps, (b,), generator=generator,
                      device=generator.device)
    noise = torch.randn(latents.shape, generator=generator, dtype=latents.dtype,
                        device=generator.device)
    t, noise = t.to(latents.device), noise.to(latents.device)
    return noisy_latents(latents, t, noise, alphas_cumprod), t
