"""Differentiable color-space conversions (NHWC, channels-last).

Port of ``rgie_tpu/ops/color.py``: every branch is a ``torch.where`` select
over values computed with safe denominators. Hue is in [0, 1). Functions
take and return float tensors shaped (..., H, W, 3).
"""

from __future__ import annotations

import torch

from rgie_tpu_torch.ops.numerics import absolute

# Luminance weights of the reference (color_transformations.py:76).
LUM_WEIGHTS = (0.27, 0.67, 0.06)
# ITU-R BT.601 weights (kornia.color.rgb_to_grayscale).
GRAY_WEIGHTS = (0.299, 0.587, 0.114)


def rgb_to_lum(image: torch.Tensor) -> torch.Tensor:
    """Luminance, (..., H, W, 1)."""
    r, g, b = image.unbind(-1)
    return (LUM_WEIGHTS[0] * r + LUM_WEIGHTS[1] * g + LUM_WEIGHTS[2] * b)[..., None]


def rgb_to_gray(image: torch.Tensor) -> torch.Tensor:
    """ITU-R 601 grayscale, (..., H, W, 1)."""
    r, g, b = image.unbind(-1)
    return (GRAY_WEIGHTS[0] * r + GRAY_WEIGHTS[1] * g + GRAY_WEIGHTS[2] * b)[..., None]


def lerp(a: torch.Tensor, b: torch.Tensor, length) -> torch.Tensor:
    return (1 - length) * a + length * b


def _hue_from_rgb(rgb: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Hue in [0, 1); the first channel reaching the max wins, as in
    ``torch.max``/``jnp.argmax``."""
    r, g, b = rgb.unbind(-1)
    safe = torch.where(delta == 0, 1.0, delta)
    h_r = torch.remainder((g - b) / safe, 6.0)       # floor-mod, like jnp's %
    h_g = (b - r) / safe + 2.0
    h_b = (r - g) / safe + 4.0
    idx = torch.argmax(rgb, dim=-1)
    h = torch.where(idx == 0, h_r, torch.where(idx == 1, h_g, h_b))
    h = torch.where(delta == 0, 0.0, h)
    return h / 6.0


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    # amax/amin share the gradient between tied channels, as jnp.max does.
    cmax = rgb.amax(-1)
    delta = cmax - rgb.amin(-1)
    h = _hue_from_rgb(rgb, delta)
    s = torch.where(cmax == 0, 0.0, delta / torch.where(cmax == 0, 1.0, cmax))
    return torch.stack([h, s, cmax], dim=-1)


def rgb_to_hsl(rgb: torch.Tensor) -> torch.Tensor:
    cmax = rgb.amax(-1)
    cmin = rgb.amin(-1)
    delta = cmax - cmin
    h = _hue_from_rgb(rgb, delta)
    l = (cmax + cmin) / 2.0
    denom_lo = torch.where(l == 0, 1.0, 2.0 * l)
    denom_hi = torch.where(l == 1, 1.0, 2.0 - 2.0 * l)
    s = torch.where(l <= 0.5, delta / denom_lo, delta / denom_hi)
    s = torch.where((l == 0) | (l == 1), 0.0, s)
    return torch.stack([h, s, l], dim=-1)


def _sector_to_rgb(h, c, x, m) -> torch.Tensor:
    idx = torch.floor(h * 6.0).long() % 6
    o = torch.zeros_like(c)

    def select(vals, default):
        out = default
        for k in reversed(range(5)):
            out = torch.where(idx == k, vals[k], out)
        return out

    r = select([c, x, o, o, x], c)
    g = select([x, c, c, x, o], o)
    b = select([o, o, x, c, c], x)
    return torch.stack([r + m, g + m, b + m], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv.unbind(-1)
    c = v * s
    x = c * (1.0 - absolute(torch.remainder(h * 6.0, 2.0) - 1.0))
    return _sector_to_rgb(h, c, x, v - c)


def hsl_to_rgb(hsl: torch.Tensor) -> torch.Tensor:
    h, s, l = hsl.unbind(-1)
    c = (1.0 - absolute(2.0 * l - 1.0)) * s
    x = c * (1.0 - absolute(torch.remainder(h * 6.0, 2.0) - 1.0))
    return _sector_to_rgb(h, c, x, l - c / 2.0)
