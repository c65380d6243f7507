"""Differentiable photo filters (NHWC), port of ``rgie_tpu/ops/filters.py``:
every op the filter chain dispatches. Parameters are per image: a scalar
(one setting for the batch) or a ``(B,)`` tensor (``(B, K, C)`` for curves).
Parameter-range clamps follow the reference exactly.

The neighborhood ops (blur, sharpness) are banded matrix products in the JAX
package, a layout chosen for the TPU's matrix unit. Here they are separable
reflect-padded depthwise ``F.conv2d`` with the same kornia semantics.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from rgie_tpu_torch.ops import color as C
from rgie_tpu_torch.ops import curves as curves_mod
from rgie_tpu_torch.ops import geometry as G
from rgie_tpu_torch.ops.numerics import clip, maximum, per_image

_SIGMA_FLOOR = 1e-8  # guards exp(-(x/0)^2) NaNs; the reference clamps sigma to >= 0 only


# ---------------------------------------------------------------------------
# Point ops
# ---------------------------------------------------------------------------


def apply_exposure(image: torch.Tensor, p) -> torch.Tensor:
    """im * 2**p, clamped (img_trans_torch_diff.py:60-64)."""
    return clip(image * torch.exp2(per_image(p, image)), 0.0, 1.0)


def apply_brightness(image: torch.Tensor, p) -> torch.Tensor:
    """kornia adjust_brightness with p clamped to [0, 1]."""
    return clip(image + clip(per_image(p, image), 0.0, 1.0), 0.0, 1.0)


def apply_gamma(image: torch.Tensor, p) -> torch.Tensor:
    """kornia adjust_gamma(gain=1), p >= 0, with the 1e-7 floor of the JAX
    package that keeps the gradient finite at zero pixels."""
    return torch.pow(maximum(image, 0.0) + 1e-7, maximum(per_image(p, image), 0.0))


def apply_contrast(image: torch.Tensor, p) -> torch.Tensor:
    """kornia adjust_contrast_with_mean_subtraction: scale around the mean of
    the ITU-601 grayscale image, clamped."""
    mean = C.rgb_to_gray(image).mean(dim=(-3, -2, -1), keepdim=True)
    return clip((image - mean) * per_image(p, image) + mean, 0.0, 1.0)


def apply_saturation(image: torch.Tensor, p) -> torch.Tensor:
    """kornia adjust_saturation, factor clamped to >= 0: scale S in HSV."""
    h, s, v = C.rgb_to_hsv(image).unbind(-1)
    factor = maximum(per_image(p, s), 0.0)
    return C.hsv_to_rgb(torch.stack([h, s * factor, v], dim=-1))


def apply_hue(image: torch.Tensor, p) -> torch.Tensor:
    """kornia adjust_hue, p (radians) clamped to [-pi, pi]: shift H in HSV."""
    h, s, v = C.rgb_to_hsv(image).unbind(-1)
    shift = clip(per_image(p, h), -math.pi, math.pi) / (2.0 * math.pi)
    return C.hsv_to_rgb(torch.stack([torch.remainder(h + shift, 1.0), s, v], dim=-1))


def apply_black_white(image: torch.Tensor, p) -> torch.Tensor:
    """lerp(im, luminance, p) (img_trans_torch_diff.py:67-70)."""
    return C.lerp(image, C.rgb_to_lum(image).expand_as(image), per_image(p, image))


def apply_white_balance(image: torch.Tensor, p) -> torch.Tensor:
    """lerp toward the per-channel 0.5-mean balance, clamped."""
    means = image.mean(dim=(-3, -2), keepdim=True) + 1e-9
    return clip(C.lerp(image, image * (0.5 / means), per_image(p, image)), 0.0, 1.0)


# ---------------------------------------------------------------------------
# Curves
# ---------------------------------------------------------------------------


def apply_tone_curve(image: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Tone curve, p shaped (..., K, 1)."""
    return curves_mod.apply_curve_adjustment(image, p)


def apply_color_curve(image: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Per-channel color curve, p shaped (..., K, 3)."""
    return curves_mod.apply_curve_adjustment(image, p)


# ---------------------------------------------------------------------------
# Neighborhood ops
# ---------------------------------------------------------------------------


def gaussian_kernel1d(sigma: torch.Tensor, size: int) -> torch.Tensor:
    """Normalized 1D Gaussian taps (kornia-style sampling of the pdf), shaped
    sigma.shape + (size,)."""
    x = torch.arange(size, dtype=sigma.dtype, device=sigma.device) - (size - 1) / 2.0
    s = maximum(sigma, _SIGMA_FLOOR)[..., None]
    g = torch.exp(-0.5 * torch.square(x / s))
    return g / torch.sum(g, dim=-1, keepdim=True)


def _reflect_index(size: int, pad: int, device) -> torch.Tensor:
    """Source index of every position of an axis of ``size`` padded by ``pad``
    on both sides, reflecting about the edge samples as often as the pad needs
    (``jnp.pad(mode="reflect")``: period ``2 * (size - 1)``)."""
    if size == 1:
        return torch.zeros(1 + 2 * pad, dtype=torch.long, device=device)
    period = 2 * (size - 1)
    idx = torch.remainder(torch.arange(-pad, size + pad, device=device), period)
    return torch.where(idx >= size, period - idx, idx)


def _pad_reflect(x: torch.Tensor, pad_h: int, pad_w: int) -> torch.Tensor:
    """Reflect padding of the last two axes. ``F.pad`` refuses a pad that
    reaches the extent; there the reflected index is gathered instead."""
    if pad_h < x.shape[-2] and pad_w < x.shape[-1]:
        return F.pad(x, (pad_w, pad_w, pad_h, pad_h), mode="reflect")
    x = x.index_select(-2, _reflect_index(x.shape[-2], pad_h, x.device))
    return x.index_select(-1, _reflect_index(x.shape[-1], pad_w, x.device))


def _depthwise_sep(image: torch.Tensor, gv: torch.Tensor, gh: torch.Tensor) -> torch.Tensor:
    """Reflect-padded 2D correlation of an NHWC batch with the rank-1 kernel
    gv[:, None] * gh[None, :]. ``gv``/``gh`` are (K,) or per image (B, K);
    the batch is folded into the channels so each image gets its own taps."""
    b, h, w, c = image.shape
    kv, kh = gv.shape[-1], gh.shape[-1]
    x = image.permute(0, 3, 1, 2).reshape(1, b * c, h, w)
    x = _pad_reflect(x, kv // 2, kh // 2)

    def taps(g):  # -> (B*C,) rows of taps, image-major like the folded channels
        return g.expand(b, -1).repeat_interleave(c, dim=0) if g.ndim == 2 else g.expand(b * c, -1)

    x = F.conv2d(x, taps(gv)[:, None, :, None], groups=b * c)   # vertical
    x = F.conv2d(x, taps(gh)[:, None, None, :], groups=b * c)   # horizontal
    return x.reshape(b, c, h, w).permute(0, 2, 3, 1)


def apply_gaussian_blur(image: torch.Tensor, p, kernel_size: int = 25) -> torch.Tensor:
    """kornia gaussian_blur2d((25, 25), sigma=max(p, 0), reflect border),
    clamped (image_transformations.py:112-123). Separable: a vertical then a
    horizontal pass. Any H and W (the reflection repeats on tiny images)."""
    sigma = maximum(torch.as_tensor(p, dtype=image.dtype, device=image.device), 0.0)
    g = gaussian_kernel1d(sigma, kernel_size)
    return clip(_depthwise_sep(image, g, g), 0.0, 1.0)


def apply_sharpness(image: torch.Tensor, p) -> torch.Tensor:
    """kornia enhance.sharpness, factor clamped to >= 0 (factor 0 is the
    identity): out = im + factor * (degenerate - im), where degenerate is the
    PIL SMOOTH kernel on the interior and the original on the 1-px border.

    SMOOTH is rank 2, (ones(3) x ones(3) + 4 delta) / 13: a separable box
    correlation plus 4 * image."""
    factor = maximum(per_image(p, image), 0.0)
    h, w = image.shape[-3], image.shape[-2]
    if min(h, w) <= 2:      # no interior: every pixel keeps its original value
        return image + factor * (image - image)
    ones3 = torch.ones(3, dtype=image.dtype, device=image.device)
    degenerate = clip((_depthwise_sep(image, ones3, ones3) + 4.0 * image) / 13.0, 0.0, 1.0)
    yy = torch.arange(h, device=image.device)
    xx = torch.arange(w, device=image.device)
    interior = ((yy > 0) & (yy < h - 1))[:, None] & ((xx > 0) & (xx < w - 1))[None, :]
    degenerate = torch.where(interior[..., None], degenerate, image)
    return image + factor * (degenerate - image)


# ---------------------------------------------------------------------------
# Geometric ops
# ---------------------------------------------------------------------------


def apply_scale(image: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """kornia scale; p is (B, 2) = (sx, sy) or (B, 4) = (sx, sy, cx, cy)."""
    if p.shape[-1] == 4:
        return G.scale_about_center(image, p[:, 0:2], p[:, 2:4])
    return G.scale_about_center(image, p[:, 0:2])
