"""Random stand-in weights drawn from an explicit ``torch.Generator``.

No checkpoint ships with the repository, so the CLI and the chip smoke run
build their models with random weights made from ``--seed``. The draws
follow Flax's defaults, as the JAX package's stand-ins do: LeCun-normal
kernels (std 1/sqrt(fan_in)), zero biases, unit norm scales, and the
running statistics of a fresh BatchNorm.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn as nn


@torch.no_grad()
def random_init_(module: nn.Module, generator: torch.Generator,
                 stds: Optional[Dict[str, float]] = None) -> nn.Module:
    """Re-draw every parameter of ``module`` in place. Parameters with two or
    more dims get N(0, 1/fan_in), fan_in being the product of all dims but
    the first (the output dim of torch's Linear/Conv layout); biases become
    zero; other vectors (norm scales) keep their constructor ones. ``stds``
    overrides the std by parameter name (e.g. CLIP's embeddings)."""
    stds = stds or {}
    for name, p in module.named_parameters():
        if name in stds:
            p.copy_(torch.randn(p.shape, generator=generator) * stds[name])
        elif p.ndim >= 2:
            fan_in = math.prod(p.shape[1:])
            p.copy_(torch.randn(p.shape, generator=generator) / math.sqrt(fan_in))
        elif name.endswith("bias"):
            p.zero_()
    return module


def freeze_(module: nn.Module) -> nn.Module:
    """Eval mode and no parameter gradients: the edit's models are frozen."""
    module.eval()
    module.requires_grad_(False)
    return module
