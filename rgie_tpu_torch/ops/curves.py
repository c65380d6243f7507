"""Piecewise-linear tone/color curve adjustment (port of
``rgie_tpu/ops/curves.py``): the knot axis is a broadcast dimension."""

from __future__ import annotations

import torch

from rgie_tpu_torch.ops.numerics import clip, minimum


def apply_curve_adjustment(image: torch.Tensor, param: torch.Tensor,
                           normalize: bool = False) -> torch.Tensor:
    """Apply a K-knot curve to an NHWC image. ``param`` is (..., K, C) with C
    broadcasting against the channels (1 for the tone curve, 3 for the color
    curve); a leading batch dim matches the image's.

    out = sum_i clip(p - i/K, 0, 1/K) * w_i, then min(., 1) unless
    ``normalize`` (img_trans_torch_diff.py:6-19)."""
    k = param.shape[-2]
    knots = torch.arange(k, dtype=image.dtype, device=image.device) / k
    segments = clip(image[..., None, :] - knots[:, None], 0.0, 1.0 / k)  # (..., K, C)
    gap = segments.ndim - param.ndim
    lead, tail = param.shape[:-2], param.shape[-2:]
    w = param.reshape(lead + (1,) * gap + tail) if gap > 0 else param
    total = torch.sum(segments * w, dim=-2)
    if normalize:
        curve_sum = torch.sum(w, dim=-2) + 1e-9
        return total * (k / curve_sum)
    return minimum(total, 1.0)
