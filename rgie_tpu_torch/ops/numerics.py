"""Clamps and ``abs`` with JAX's subgradients at ties and kinks.

``jnp.clip(x, lo, hi)`` is ``minimum(maximum(x, lo), hi)``, and JAX's
``maximum``/``minimum`` split the gradient 0.5/0.5 when both sides are equal.
``torch.clamp`` passes the full gradient at a bound, ``torch.relu`` none.
``torch.maximum``/``torch.minimum`` against a tensor split it like JAX.
``jnp.abs`` has gradient +1 at 0 where ``torch.abs`` has 0. So every
``jnp.clip``/``maximum``/``minimum``/``abs`` of the differentiated path is
written with these helpers. The filter chain starts from the identity
vector, where many values sit exactly on a bound or a kink (sharpness 0, the
scale op's interpolation taps), so the first gradient depends on it.
"""

from __future__ import annotations

import torch


def _const(x: torch.Tensor, value: float) -> torch.Tensor:
    return torch.full((), value, dtype=x.dtype, device=x.device)


def maximum(x: torch.Tensor, value: float) -> torch.Tensor:
    """``jnp.maximum(x, value)`` for a constant ``value``."""
    return torch.maximum(x, _const(x, value))


def minimum(x: torch.Tensor, value: float) -> torch.Tensor:
    """``jnp.minimum(x, value)`` for a constant ``value``."""
    return torch.minimum(x, _const(x, value))


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)``, gradient 0.5 at ``x == lo`` or ``x == hi``."""
    return minimum(maximum(x, lo), hi)


def absolute(x: torch.Tensor) -> torch.Tensor:
    """``jnp.abs(x)``: gradient +1 at x == 0, like JAX's ``select(x >= 0)``."""
    return torch.where(x >= 0, x, -x)


def per_image(p: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """View a per-image parameter (scalar, or ``(B,)``) so that it broadcasts
    against ``like`` (``(B, ...)``): ``(B,)`` becomes ``(B, 1, ..., 1)``."""
    p = torch.as_tensor(p, dtype=like.dtype, device=like.device)
    return p.reshape(p.shape + (1,) * (like.ndim - p.ndim))
