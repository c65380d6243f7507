"""Plain midu training (src/clf/train_guidance_clf.py:209-294): teacher VA
labels, VAE encode, noise at a random timestep, the UNet's mid block under
an empty prompt (zero embeddings), then one Adam step (lr 1e-5, L2 weight
decay 5e-5) on the mean squared error of the midu to the labels.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from benchmark.reference import nets
from benchmark.reference.sched import T_TRAIN, alphas_cumprod

CONTEXT_LEN = 8


@torch.no_grad()
def features_and_labels(teacher: nets.Teacher, vae: nets.Vae, unet: nets.UNet,
                        images: torch.Tensor, t: torch.Tensor, noise: torch.Tensor):
    labels = teacher(images)
    latents = vae.encode(images * 2 - 1)
    a = torch.from_numpy(alphas_cumprod()).to(latents.device)[t].view(-1, 1, 1, 1)
    noisy = torch.sqrt(a) * latents + torch.sqrt(1.0 - a) * noise
    b = images.shape[0]
    cfg = unet.cfg
    context = torch.zeros((b, CONTEXT_LEN, cfg["cross_attention_dim"]), device=images.device)
    added = None
    if cfg.get("addition_embed_type") == "text_time":
        s = images.shape[1]
        added = (torch.zeros((1, cfg["addition_pooled_dim"]), device=images.device),
                 torch.tensor([[s, s, 0, 0, s, s]], dtype=torch.float32, device=images.device))
    _, mid = nets.unet_forward(unet, noisy, t, context, added)
    return mid, labels


def draw_t_and_noise(generator: torch.Generator, latent_shape) -> tuple:
    """A training step's timesteps and noise, in the draw order of the
    program's feed (timesteps, then noise), from ``generator``."""
    t = torch.randint(0, T_TRAIN, (latent_shape[0],), generator=generator,
                      device=generator.device)
    noise = torch.randn(latent_shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
    return t, noise


def train_steps(midu: nets.Midu, batches: List[tuple], lr: float = 1e-5,
                weight_decay: float = 5e-5) -> Dict[str, object]:
    """Adam steps of ``midu`` over ``batches`` of (features, labels). Returns
    each step's loss, the first step's gradient as Adam takes it (with the
    decay term) and every parameter's change over all the steps."""
    midu.train().requires_grad_(True)
    start = {n: p.detach().clone() for n, p in midu.named_parameters()}
    opt = torch.optim.Adam(midu.parameters(), lr=lr, weight_decay=weight_decay)
    losses, first_grad = [], None
    for feats, labels in batches:
        opt.zero_grad(set_to_none=True)
        loss = torch.mean((midu(feats) - labels) ** 2)
        loss.backward()
        if first_grad is None:
            first_grad = {n: p.grad.detach() + weight_decay * p.detach()
                          for n, p in midu.named_parameters()}
        opt.step()
        losses.append(float(loss.detach()))
    change = {n: p.detach() - start[n] for n, p in midu.named_parameters()}
    return {"losses": losses, "first_grad": first_grad, "change": change}
