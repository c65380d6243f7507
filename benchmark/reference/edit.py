"""The plain diffusion edit of the reference paper (src/adapt_images.py,
InversionResamplingStableDiffusion[XL]Pipeline.py), one image after another
in spirit, a few images at once in fact: every row is computed from its own
inputs only.

Per image: the midu's VA of the input; VAE encode (posterior mode); inversion
under the empty prompt (DDIM, or DPM-Solver++ 2M over karras sigmas for
SDXL); null-text optimization (per outer step i, Adam on the uncond
embeddings, lr base * (1 - i/100), at most ``num_inner`` steps, stopping once
the previous loss is under eps + i * 2e-5; then the CFG step with the result);
guided sampling (the CFG pair, the scheduler step, then the normalized
gradient of the midu's guidance loss with respect to the post-step latents);
VAE decode; the midu's VA of the edit.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from benchmark.reference import nets
from benchmark.reference.sched import Ddim, KarrasDpm

#: What is kept of the first null-text inner step at each timestep, as
#: ``nto_<key>`` (S, B, ...), besides its timestep ``nto_t``: the embeddings,
#: latents and pivot it starts from, and its gradient to the embeddings.
NTO_STEP_KEYS = ("uncond", "lat", "target", "grad")


class Models:
    def __init__(self, unet: nets.UNet, vae: nets.Vae, midu: nets.Midu, cfg: dict):
        self.unet, self.vae, self.midu, self.cfg = unet, vae, midu, cfg
        steps = cfg["num_inference_steps"]
        self.ddim = Ddim(steps)
        self.xl = cfg["scheduler"] == "dpm_karras"
        if self.xl:
            self.fwd, self.inv = KarrasDpm(steps), KarrasDpm(steps, inverse=True)


def _rows(added, i: int) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    return None if added is None else (added[0][:, i], added[1][:, i])


def _cat(a, b):
    return None if a is None else (torch.cat([a[0], b[0]]), torch.cat([a[1], b[1]]))


@torch.no_grad()
def score(m: Models, images: torch.Tensor, empty: torch.Tensor, added_empty) -> torch.Tensor:
    b = images.shape[0]
    lat = m.vae.encode(images * 2 - 1)
    _, mid = nets.unet_forward(m.unet, lat, m.ddim.timesteps[-1], empty.expand(b, -1, -1),
                               added_empty)
    return m.midu(mid)


@torch.no_grad()
def invert(m: Models, latents: torch.Tensor, empty: torch.Tensor, added_empty):
    """Returns the pivots, the clean latents first."""
    b = latents.shape[0]
    ctx = empty.expand(b, -1, -1)
    lat, pivots = latents, [latents]
    if m.xl:
        state = m.inv.init_state()
        for i, t in enumerate(m.inv.timesteps):
            eps, _ = nets.unet_forward(m.unet, lat, t, ctx, added_empty)
            lat, state = m.inv.step(eps, i, lat, state)
            pivots.append(lat)
    else:
        for t in m.ddim.inverse_timesteps:
            eps, _ = nets.unet_forward(m.unet, lat, t, ctx, added_empty)
            lat = m.ddim.inverse_step(eps, t, lat)
            pivots.append(lat)
    return pivots


def null_text_loss_and_grad(m: Models, lat: torch.Tensor, t: int, uncond: torch.Tensor,
                            eps_c: torch.Tensor, target: torch.Tensor, added_uncond,
                            scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The null-text objective of each row (B,), the mean squared distance
    of the CFG DDIM step from ``lat`` to the pivot ``target``, and its
    gradient to the uncond embeddings."""
    with torch.enable_grad():
        ug = uncond.detach().requires_grad_(True)
        eps_u, _ = nets.unet_forward(m.unet, lat, t, ug, added_uncond)
        rec = m.ddim.step(eps_u + scale * (eps_c - eps_u), t, lat)
        loss = ((rec - target) ** 2).mean(dim=(1, 2, 3))
        (g,) = torch.autograd.grad(loss.sum(), ug)
    return loss.detach(), g


@torch.no_grad()
def null_text_first_steps(m: Models, state: Dict[str, torch.Tensor], cond: torch.Tensor,
                          added_cond, added_uncond, scale: float) -> Dict[str, torch.Tensor]:
    """The gradient of the first null-text inner step at each of
    ``state``'s timesteps (``nto_t``), from its embeddings, latents and
    pivots there."""
    grads = []
    for i, t in enumerate(state["nto_t"].tolist()):
        lat = state["nto_lat"][i]
        eps_c, _ = nets.unet_forward(m.unet, lat, t, cond, added_cond)
        _, g = null_text_loss_and_grad(m, lat, t, state["nto_uncond"][i], eps_c,
                                       state["nto_target"][i], added_uncond, scale)
        grads.append(g)
    return {"nto_grad": torch.stack(grads)}


@torch.no_grad()
def null_text(m: Models, pivots, empty: torch.Tensor, cond: torch.Tensor, added_cond,
              added_uncond, scale: float, num_inner: int, epsilon: float = 1e-5):
    """Returns the optimized uncond embeddings, one (B, L, D) per outer step,
    and the first inner step at each outer step (``NTO_STEP_KEYS``)."""
    s, b = m.ddim.steps, cond.shape[0]
    base_lr = 1e-1 if m.xl else 1e-2
    lat = pivots[-1]
    uncond = empty.expand(b, -1, -1).clone()
    out, first = [], {key: [] for key in NTO_STEP_KEYS}
    for i, t in enumerate(m.ddim.timesteps):
        target = pivots[min(max(s - 1 - i, 0), len(pivots) - 1)]
        eps_c, _ = nets.unet_forward(m.unet, lat, t, cond, added_cond)
        lr, thresh = base_lr * (1.0 - i / 100.0), epsilon + i * 2e-5
        u, mo, v = uncond, torch.zeros_like(uncond), torch.zeros_like(uncond)
        running = torch.ones(b, dtype=torch.bool, device=u.device)
        for j in range(num_inner):
            if not bool(running.any()):
                break
            loss, g = null_text_loss_and_grad(m, lat, t, u, eps_c, target, added_uncond, scale)
            if j == 0:
                for key, value in zip(NTO_STEP_KEYS, (u, lat, target, g)):
                    first[key].append(value)
            mo_n = 0.9 * mo + 0.1 * g
            v_n = 0.999 * v + 0.001 * g * g
            mh = mo_n / -math.expm1((j + 1) * math.log(0.9))
            vh = v_n / -math.expm1((j + 1) * math.log(0.999))
            u_n = u - lr * mh / (torch.sqrt(vh) + 1e-8)
            keep = running.view(-1, 1, 1)
            u, mo, v = (torch.where(keep, n, o) for n, o in ((u_n, u), (mo_n, mo), (v_n, v)))
            running = running & (loss >= thresh)
        uncond = u
        pair = _cat(added_uncond, added_cond)
        eps_pair, _ = nets.unet_forward(m.unet, torch.cat([lat, lat]), t,
                                        torch.cat([uncond, cond]), pair)
        eps_u, eps_c = eps_pair.chunk(2)
        lat = m.ddim.step(eps_u + scale * (eps_c - eps_u), t, lat)
        out.append(uncond)
    steps = {f"nto_{key}": torch.stack(v) for key, v in first.items()}
    steps["nto_t"] = torch.tensor([int(t) for t in m.ddim.timesteps][:len(out)])
    return torch.stack(out), steps


@torch.no_grad()
def sample(m: Models, noisy: torch.Tensor, cfg_embeds: torch.Tensor, added_cfg,
           nto: Optional[torch.Tensor], scale: float, clf_scale: float) -> torch.Tensor:
    b = noisy.shape[0]
    pair = _cat(_rows(added_cfg, 0), _rows(added_cfg, 1))
    added_uncond = _rows(added_cfg, 0)
    lat = noisy
    sched = m.fwd if m.xl else m.ddim
    state = m.fwd.init_state() if m.xl else None
    for i, t in enumerate(sched.timesteps):
        uncond = cfg_embeds[:, 0] if nto is None else nto[i]
        eps_pair, _ = nets.unet_forward(m.unet, torch.cat([lat, lat]), t,
                                        torch.cat([uncond, cfg_embeds[:, 1]]), pair)
        eps_u, eps_c = eps_pair.chunk(2)
        eps = eps_u + scale * (eps_c - eps_u)
        if m.xl:
            lat, state = m.fwd.step(eps, i, lat, state)
        else:
            lat = m.ddim.step(eps, t, lat)
        with torch.enable_grad():
            x = lat.detach().requires_grad_(True)
            _, mid = nets.unet_forward(m.unet, x, t, uncond, added_uncond)
            (g,) = torch.autograd.grad(nets.va_score(m.midu(mid)), x)
        norm = torch.linalg.vector_norm(g, dim=(1, 2, 3), keepdim=True)
        lat = lat - clf_scale * g / (norm + 1e-10)
    return lat


def edit(m: Models, images: torch.Tensor, empty: torch.Tensor, cfg_embeds: torch.Tensor,
         cond_embeds: torch.Tensor, added=None) -> Dict[str, torch.Tensor]:
    """Every stage's result for the rows of ``images`` (B, H, W, 3) in [0, 1]:
    ``latents``, ``noisy``, ``nto_embeds`` (S, B, L, D; only with NTO),
    ``out_latents``, ``edited`` (B, H, W, 3) in [0, 1], ``orig_score`` and
    ``adapted_score`` (B, 2). ``added`` (SDXL): a dict of the pooled
    embeddings and time ids, ``empty`` one row and ``cfg``/``cond``/``uncond``
    (B, n, ...)."""
    c = m.cfg
    added = added or {}
    a_empty = added.get("empty")
    out = {"orig_score": score(m, images, empty, a_empty)}
    with torch.no_grad():
        latents = m.vae.encode(images * 2 - 1)
    pivots = invert(m, latents, empty, a_empty)
    out.update(latents=latents, noisy=pivots[-1])
    nto = None
    if c["nto"]:
        nto, steps = null_text(m, pivots, empty, cond_embeds[:, 0], _rows(added.get("cond"), 0),
                               _rows(added.get("uncond"), 0), c["guidance_scale"],
                               c["num_inner_steps"])
        out.update(steps, nto_embeds=nto)
    lat = sample(m, pivots[-1], cfg_embeds, added.get("cfg"), nto, c["guidance_scale"],
                 c["clf_scale"])
    with torch.no_grad():
        edited = torch.clamp(m.vae.decode(lat) * 0.5 + 0.5, 0.0, 1.0)
    out.update(out_latents=lat, edited=edited,
               adapted_score=score(m, edited, empty, a_empty))
    return out


def follow(m: Models, images: torch.Tensor, empty: torch.Tensor, cfg_embeds: torch.Tensor,
           state: Dict[str, torch.Tensor], added=None) -> Dict[str, torch.Tensor]:
    """The stages that can be followed from another run's state, for the
    rows of ``images``: the encode and the inversion from the inputs; where
    ``state`` holds them, the first null-text inner steps from its state
    there (``nto_grad``); then sampling from its ``noisy``
    latents with its ``nto_embeds`` (``sample``) and the decode of its
    ``out_latents`` (``decode``)."""
    c = m.cfg
    added = added or {}
    with torch.no_grad():
        latents = m.vae.encode(images * 2 - 1)
    pivots = invert(m, latents, empty, added.get("empty"))
    first = {}
    if "nto_t" in state:
        first = null_text_first_steps(m, state, cfg_embeds[:, 1], _rows(added.get("cond"), 0),
                                      _rows(added.get("uncond"), 0), c["guidance_scale"])
    lat = sample(m, state["noisy"], cfg_embeds, added.get("cfg"), state.get("nto_embeds"),
                 c["guidance_scale"], c["clf_scale"])
    with torch.no_grad():
        decoded = torch.clamp(m.vae.decode(state["out_latents"]) * 0.5 + 0.5, 0.0, 1.0)
    return dict(first, latents=latents, noisy=pivots[-1], sample=lat, decode=decoded)
