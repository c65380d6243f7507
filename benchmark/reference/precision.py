"""The arithmetic precision of the plain reference.

The reference computes in float32 with TF32 off. The control that proves the
comparison can fail is the same reference one step lower than each part's
stated type: float8 (e4m3, one scale per tensor) for the parts the
configuration serves in bfloat16, TF32 (a 10-bit mantissa) for the parts it
runs in float32 with TF32 off. The lowering rounds the two operands of every
convolution, linear layer and attention product; the products and sums stay
float32, as a tensor core accumulates.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

FLOAT32, TF32, FP8 = "float32", "tf32", "fp8"
FP8_MAX = 448.0


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 mantissa bits, to nearest."""
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return torch.where(torch.isfinite(x), rounded.view(torch.float32), x)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale that maps its largest
    magnitude to the format's largest value."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def lower(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` rounded to ``precision``; a gradient passes the rounding
    unchanged (the products of the backward take the rounded operands their
    forward saved)."""
    if precision == FLOAT32:
        return x
    if precision == TF32:
        rounded = round_tf32(x.detach())
    elif precision == FP8:
        rounded = round_fp8(x.detach())
    else:
        raise ValueError(f"unknown precision {precision!r}")
    return x + (rounded - x.detach()) if x.requires_grad else rounded


class QLinear(nn.Linear):
    precision = FLOAT32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.precision
        return F.linear(lower(x, p), lower(self.weight, p), self.bias)


class QConv2d(nn.Conv2d):
    precision = FLOAT32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.precision
        return F.conv2d(lower(x, p), lower(self.weight, p), self.bias, self.stride,
                        self.padding, self.dilation, self.groups)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    return torch.matmul(lower(a, precision), lower(b, precision))


def set_precision(model: nn.Module, precision: str) -> nn.Module:
    """Every ``QLinear``, ``QConv2d`` and attention of ``model`` computes in
    ``precision`` from now on."""
    lower(torch.zeros(1), precision)  # rejects an unknown name
    for m in model.modules():
        if hasattr(m, "precision"):
            m.precision = precision
    return model
