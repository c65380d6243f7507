"""GAN losses (hinge, least-square, non-saturated, wasserstein). Port of
``rgie_tpu/losses/gan.py`` (reference: imaginaire losses/gan.py:31-173).

A list of multi-scale discriminator outputs is averaged per scale first, so
the high-resolution patches do not dominate (gan.py:70-76). Top-k generator
training (gan.py:102-118) is the ``k`` fraction argument. Each call reduces
over every entry it is given: the batched edit calls it once per image.
Maximum, minimum and abs take JAX's subgradients (``ops.numerics``).
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import torch

from rgie_tpu_torch.ops.numerics import absolute, maximum, minimum

Output = Union[torch.Tensor, Sequence[torch.Tensor]]


def _single_loss(dis_output: torch.Tensor, gan_mode: str, t_real: bool, dis_update: bool,
                 real_label: float, fake_label: float, k: float) -> torch.Tensor:
    if not dis_update and not t_real:
        raise ValueError("The target should be real when updating the generator.")

    if not dis_update and k < 1:
        flat = dis_output.reshape(-1)
        dis_output = torch.topk(flat, max(1, math.ceil(k * flat.shape[-1]))).values

    label = real_label if t_real else fake_label

    if gan_mode in ("non_saturated", "softplus"):
        target = torch.full_like(dis_output, label)
        # binary_cross_entropy_with_logits, written out as the JAX package does
        return torch.mean(maximum(dis_output, 0.0) - dis_output * target
                          + torch.log1p(torch.exp(-absolute(dis_output))))
    if gan_mode == "least_square":
        target = torch.full_like(dis_output, label)
        return 0.5 * torch.mean((dis_output - target) ** 2)
    if gan_mode == "hinge":
        if not dis_update:
            return -torch.mean(dis_output)
        if t_real:
            return -torch.mean(minimum(dis_output - 1.0, 0.0))
        return -torch.mean(minimum(-dis_output - 1.0, 0.0))
    if gan_mode == "wasserstein":
        return -torch.mean(dis_output) if t_real else torch.mean(dis_output)
    raise ValueError(f"Unexpected gan_mode {gan_mode}")


def gan_loss(dis_output: Output, t_real: bool, gan_mode: str = "hinge",
             dis_update: bool = True, reduce: bool = True, real_label: float = 1.0,
             fake_label: float = 0.0, k: float = 1.0):
    """GANLoss.forward (gan.py:58-85): a scalar, or with ``reduce=False`` and
    a list of outputs, one loss per scale."""
    if isinstance(dis_output, (list, tuple)):
        losses = [_single_loss(o, gan_mode, t_real, dis_update, real_label, fake_label, k)
                  for o in dis_output]
        return torch.mean(torch.stack(losses)) if reduce else losses
    return _single_loss(dis_output, gan_mode, t_real, dis_update, real_label, fake_label, k)
