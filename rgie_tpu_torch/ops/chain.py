"""The ordered differentiable filter chain and its flat 41-parameter vector.

Port of ``rgie_tpu/ops/chain.py``. The vector layout and its feasibility
clamps are the reference's (optimize_image_param.py:121-292); the chain
clamps to [0, 1] after every op (apply_params, image_transformations.py:60).

Every clamp of the differentiated chain is ``ops.numerics.clip`` and not
``torch.clamp``: ``jnp.clip`` gives a gradient of 0.5 when a value sits
exactly on a bound, ``torch.clamp`` gives 1. At the identity init many
values sit on a bound, so ``torch.clamp`` would change the first steps of
every edit against the JAX package.

A ``(B, 41)`` vector unpacks to per-image parameters (leading dim B on every
field); the ops broadcast them over their image. A ``(41,)`` vector unpacks
to one parameter set for the whole batch.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from rgie_tpu_torch.ops import filters as F
from rgie_tpu_torch.ops.numerics import clip, maximum

DEFAULT_TRANSFORMS: Tuple[str, ...] = (
    "exposure", "saturation", "tone", "color", "contrast", "sharp", "blur", "scale",
)

CURVE_KNOTS = 8


@dataclasses.dataclass
class FilterParams:
    """Parameters of the active chain, channels-last: tone (..., K, 1), color
    (..., K, 3), scale (..., 4) = (sx, sy, cx, cy); the others (...)."""

    exposure: torch.Tensor
    saturation: torch.Tensor
    tone: torch.Tensor
    color: torch.Tensor
    contrast: torch.Tensor
    sharp: torch.Tensor
    blur: torch.Tensor
    scale: torch.Tensor


def init_params(dtype=torch.float32, device=None) -> FilterParams:
    """Identity initialization (optimize_image_param.py:121-209)."""
    def full(shape, v):
        return torch.full(shape, v, dtype=dtype, device=device)

    return FilterParams(
        exposure=full((), 0.0), saturation=full((), 1.0),
        tone=full((CURVE_KNOTS, 1), 1.0), color=full((CURVE_KNOTS, 3), 1.0),
        contrast=full((), 1.0), sharp=full((), 0.0), blur=full((), 1e-4),
        scale=torch.tensor([1.0, 1.0, 0.0, 0.0], dtype=dtype, device=device),
    )


NUM_PARAMS = 1 + 1 + CURVE_KNOTS + 3 * CURVE_KNOTS + 1 + 1 + 1 + 4  # = 41


def pack_params(p: FilterParams) -> torch.Tensor:
    """Flatten to the reference's vector layout (exposure, saturation,
    tone[8], color[3*8 row-major by channel], contrast, sharp, blur,
    scale[4]); leading batch dims are kept."""
    lead = p.exposure.shape
    return torch.cat([
        p.exposure[..., None], p.saturation[..., None], p.tone[..., 0],
        p.color.transpose(-1, -2).reshape(lead + (-1,)),
        p.contrast[..., None], p.sharp[..., None], p.blur[..., None], p.scale,
    ], dim=-1)


def unpack_params(x: torch.Tensor, input_size: int = 480) -> FilterParams:
    """(..., 41) vector -> params with the reference's feasibility clamps:
    scale >= 1, center in [0, input_size], contrast gated at 0. Per-op range
    clamps live inside the ops, as in the reference."""
    k = CURVE_KNOTS
    lead = x.shape[:-1]
    scale_raw = x[..., 37:41]
    scale = torch.cat([maximum(scale_raw[..., 0:2], 1.0),
                       clip(scale_raw[..., 2:4], 0.0, float(input_size))], dim=-1)
    contrast = x[..., 34]
    return FilterParams(
        exposure=x[..., 0], saturation=x[..., 1],
        tone=x[..., 2:2 + k].reshape(lead + (k, 1)),
        color=x[..., 2 + k:2 + 4 * k].reshape(lead + (3, k)).transpose(-1, -2),
        contrast=torch.where(contrast < 0, 0.0, contrast),
        sharp=x[..., 35], blur=x[..., 36], scale=scale)


def apply_filter_chain(image: torch.Tensor, params: FilterParams,
                       order: Tuple[str, ...] = DEFAULT_TRANSFORMS) -> torch.Tensor:
    """Apply the ordered chain to an NHWC batch, clamping to [0, 1] after every
    op (apply_params, image_transformations.py:7-66)."""
    b = image.shape[0]
    ops = {
        "exposure": lambda im: F.apply_exposure(im, params.exposure),
        "saturation": lambda im: F.apply_saturation(im, params.saturation),
        "tone": lambda im: F.apply_tone_curve(im, params.tone),
        "color": lambda im: F.apply_color_curve(im, params.color),
        "contrast": lambda im: F.apply_contrast(im, params.contrast),
        "sharp": lambda im: F.apply_sharpness(im, params.sharp),
        "blur": lambda im: F.apply_gaussian_blur(im, params.blur),
        "scale": lambda im: F.apply_scale(im, params.scale.expand(b, 4)),
        "gamma": lambda im: F.apply_gamma(im, getattr(params, "gamma")),
        "bright": lambda im: F.apply_brightness(im, getattr(params, "bright")),
        "bw": lambda im: F.apply_black_white(im, getattr(params, "bw")),
        "hue": lambda im: F.apply_hue(im, getattr(params, "hue")),
        "wb": lambda im: F.apply_white_balance(im, getattr(params, "wb")),
    }
    for name in order:
        image = clip(ops[name](image), 0.0, 1.0)
    return image


def edit_image(image: torch.Tensor, x: torch.Tensor, input_size: int = 480,
               order: Tuple[str, ...] = DEFAULT_TRANSFORMS) -> torch.Tensor:
    """Full parametric edit: flat vector(s) -> clamped params -> filter chain."""
    return apply_filter_chain(image, unpack_params(x, input_size), order)


# The pointwise prefix that kernel K1 fuses (ops/kernels/pointwise_chain.py).
FUSED_PREFIX: Tuple[str, ...] = ("exposure", "saturation", "tone", "color", "contrast")


def apply_filter_chain_fused(image: torch.Tensor, params: FilterParams,
                             order: Tuple[str, ...] = DEFAULT_TRANSFORMS) -> torch.Tensor:
    """``apply_filter_chain`` with the exposure -> saturation -> tone -> color
    -> contrast prefix fused into kernel K1 (two passes over memory instead
    of six). On a CUDA tensor the kernel always runs (it takes any H and W);
    on a CPU tensor its plain version does. Inference only: the
    differentiated edit keeps the separate ops."""
    if tuple(order[:len(FUSED_PREFIX)]) != FUSED_PREFIX:
        return apply_filter_chain(image, params, order)
    from rgie_tpu_torch.ops.kernels.pointwise_chain import pointwise_chain

    out = pointwise_chain(image, params)
    return apply_filter_chain(out, params, tuple(order[len(FUSED_PREFIX):]))


def edit_image_fused(image: torch.Tensor, x: torch.Tensor, input_size: int = 480,
                     order: Tuple[str, ...] = DEFAULT_TRANSFORMS) -> torch.Tensor:
    """Inference-path edit with one (41,) vector for the batch: vector ->
    params -> fused chain (see apply_filter_chain_fused)."""
    return apply_filter_chain_fused(image, unpack_params(x, input_size), order)
