"""Guidance-regressor (midu) training, the framework's training workload. Port
of ``rgie_tpu/training/train_midu.py``.

Reference: ``src/clf/train_guidance_clf.py:179-333``: Adam with lr 1e-5 and
L2 weight decay 5e-5, MSE on teacher VA labels, noisy latents at random
timesteps, best-validation checkpointing. The features (the frozen UNet's
mid block at the noisy latents) come from ``cli/train_guidance_clf.py``; the
step here trains the midu on them. The JAX package jits the step over a
(data, model) mesh (``shard_train_step``); the port runs it over processes
on the same two axes (``parallel.create_mesh``, ``parallel.shard_model``).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from rgie_tpu_torch.config import TrainGuidanceConfig
from rgie_tpu_torch.parallel.mesh import Mesh, all_mean, create_mesh
from rgie_tpu_torch.parallel.model_axis import model_shards
from rgie_tpu_torch.utils.spans import span


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


def make_train_step(average_gradients: bool = False, mesh: Optional[Mesh] = None):
    """``train_step(state, features, labels) -> (state, loss, predictions)``:
    one Adam step on the MSE to the labels. With ``average_gradients`` the
    gradients and the loss are averaged over the processes before the step
    (``shard_train_step``; over ``mesh``, by default every process on the
    data axis)."""

    def train_step(state: TrainState, features: torch.Tensor, labels: torch.Tensor):
        with span("train.step"):
            state.optimizer.zero_grad(set_to_none=True)
            with torch.enable_grad():
                out = state.model(features)
                loss = _mse(out, labels)
                loss.backward()
            loss = loss.detach()
            if average_gradients:
                loss = _all_mean_gradients(state.model, loss, mesh or create_mesh())
            state.optimizer.step()
            state.step += 1
            return state, loss, out.detach()

    return train_step


def _flat_mean_(tensors, group=None) -> None:
    """Each of ``tensors`` replaced, in place, by its mean over ``group``, in
    one all-reduce of them all flattened."""
    if tensors:
        flat = all_mean(torch.cat([t.reshape(-1) for t in tensors]), group)
        offset = 0
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def _all_mean_gradients(model: nn.Module, loss: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every gradient of ``model`` replaced by its mean over the ranks that
    hold the same parameter: a sharded one's over its data group, a
    replicated one's (with the loss) over every process. Returns the mean
    loss."""
    sharded = model_shards(model)
    named = [(n, p.grad) for n, p in model.named_parameters() if p.grad is not None]
    mean_loss = loss.reshape(1).to(named[0][1])
    _flat_mean_([g for n, g in named if n in sharded], mesh.data_group())
    _flat_mean_([g for n, g in named if n not in sharded] + [mean_loss])
    return mean_loss[0].to(loss.dtype)


def shard_train_step(state: TrainState, mesh: Optional[Mesh] = None):
    """The counterpart of JAX's ``shard_train_step`` over ``mesh`` (default:
    every process on the data axis): the batch is split over the data axis,
    each rank passing its own rows, and a midu put through
    ``parallel.shard_model`` over the model axis keeps its weight slices.
    Every rank starts from the same midu (a replicated parameter broadcast
    from rank 0, a sharded slice from the first rank of its data group), and
    the step averages each gradient over the ranks that hold its parameter
    before Adam, so the update equals a one-process step on the union of the
    data groups' rows and the ranks of a data group keep the same weights.
    Returns ``(train_step, state)``; one process gets the plain step."""
    if not dist.is_initialized():
        return make_train_step(), state
    mesh = mesh or create_mesh()
    sharded = model_shards(state.model)
    data_group = mesh.data_group()
    first = int(dist.get_global_rank(data_group, 0)) if data_group is not None else 0
    with torch.no_grad():
        for name, p in state.model.named_parameters():
            if name in sharded:
                dist.broadcast(p, src=first, group=data_group)
            else:
                dist.broadcast(p, src=0)
    return make_train_step(average_gradients=True, mesh=mesh), state


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
