"""Kernel K1 as it was first ported, in Triton: the fused pointwise filter
prefix. The package runs the CUDA C++ kernel ``csrc/pointwise_chain.cu``;
no module of the package imports this one. It is kept so that
``python -m rgie_tpu_torch.cli.kernel_variants k1`` can time the old design
(``k1_triton_old``) beside the new one on the same card, and it needs
``triton``, which only the card's machine has.

It computes, per pixel and in order: exposure ``clip(x * 2^p)``; RGB -> HSV,
S * max(p, 0), HSV -> RGB, clip; the shared 8-knot tone curve, clip; the
per-channel 8-knot color curves, clip. Then contrast around the mean of the
ITU-601 gray image, ``clip((x - mean) * max(c, 0) + mean)``.

- ``_pointwise_prefix``: grid (pixel blocks, B). Reads the interleaved NHWC
  buffer as three masked stride-3 loads, applies the prefix with the
  parameters loaded as scalars, writes the result the same way, and writes
  one gray partial sum per program. Masked pixels add 0. No atomics.
- ``_contrast``: grid (float blocks, B). Each program sums its image's
  partials in a fixed order into the mean and applies the contrast IN PLACE
  on the prefix pass's output.

Division is Triton's float32 ``/`` (``div.full.f32``, within 2 ulp of the
rounded quotient), not ``tl.div_rn``. The floor-mod of the hue (``jnp``'s
``%``) is written out, since Triton's float ``%`` follows C fmod.
"""

from __future__ import annotations

import torch
import triton
import triton.language as tl

#: Pixels per program of the prefix pass (the contrast pass takes 4x as many
#: floats per program). The gray partial sums have one slot per prefix program.
PIXELS_PER_PROGRAM = 1024


def pack_kernel_params(params) -> torch.Tensor:
    """(35,) f32: [exposure, saturation, tone 8, color 3x8 by channel,
    contrast] — the TPU kernel's (1, 34) SMEM layout plus the contrast."""
    return torch.cat([
        params.exposure[None], params.saturation[None], params.tone[:, 0],
        params.color.T.reshape(-1), params.contrast[None],
    ]).to(torch.float32).contiguous()


def old_pointwise_chain(image: torch.Tensor, params) -> torch.Tensor:
    """The wrapper as it was: pack the parameters, allocate the output and
    the partials, launch both passes (a checked contiguous float32 CUDA
    tensor)."""
    b, h, w, _ = image.shape
    n_prog = -(-(h * w) // PIXELS_PER_PROGRAM)
    packed = pack_kernel_params(params).to(image.device)
    out = torch.empty_like(image)
    partials = torch.empty((b, n_prog), dtype=torch.float32, device=image.device)
    launch(image, out, packed, partials, PIXELS_PER_PROGRAM)
    return out

# The parameter layout of pack_kernel_params.
_TONE = tl.constexpr(2)
_COLOR = tl.constexpr(10)
_CONTRAST = tl.constexpr(34)


@triton.jit
def _clip01(x):
    return tl.minimum(tl.maximum(x, 0.0), 1.0)


@triton.jit
def _curve(v, p_ptr, base: tl.constexpr):
    # 8 knots at i/8, accumulated in the TPU kernel's order.
    total = tl.zeros_like(v)
    for i in tl.static_range(8):
        w = tl.load(p_ptr + base + i)
        total += tl.minimum(tl.maximum(v - i * 0.125, 0.0), 0.125) * w
    return _clip01(tl.minimum(total, 1.0))


@triton.jit
def _pointwise_prefix(img_ptr, out_ptr, p_ptr, gsum_ptr, hw, n_prog,
                      BLOCK: tl.constexpr):
    pid = tl.program_id(0)
    b = tl.program_id(1)
    offs = pid * BLOCK + tl.arange(0, BLOCK)
    mask = offs < hw
    base = b * hw * 3 + offs * 3
    r = tl.load(img_ptr + base, mask=mask, other=0.0)
    g = tl.load(img_ptr + base + 1, mask=mask, other=0.0)
    bl = tl.load(img_ptr + base + 2, mask=mask, other=0.0)

    # exposure
    scale = tl.exp2(tl.load(p_ptr))
    r = _clip01(r * scale)
    g = _clip01(g * scale)
    bl = _clip01(bl * scale)

    # saturation via HSV, hue kept in sixths (h6 in [0, 6])
    saturation = tl.maximum(tl.load(p_ptr + 1), 0.0)
    cmax = tl.maximum(tl.maximum(r, g), bl)
    cmin = tl.minimum(tl.minimum(r, g), bl)
    delta = cmax - cmin
    safe = tl.where(delta == 0.0, 1.0, delta)
    q = (g - bl) / safe
    h_r = q - 6.0 * tl.floor(q / 6.0)            # floor-mod: q may be negative
    h_g = (bl - r) / safe + 2.0
    h_b = (r - g) / safe + 4.0
    is_r = (r >= g) & (r >= bl)                   # first channel at the max wins
    is_g = ((r < g) | (r < bl)) & (g >= bl)
    h6 = tl.where(is_r, h_r, tl.where(is_g, h_g, h_b))
    h6 = tl.where(delta == 0.0, 0.0, h6)
    s = tl.where(cmax == 0.0, 0.0, delta / tl.where(cmax == 0.0, 1.0, cmax))
    c = cmax * (s * saturation)
    x = c * (1.0 - tl.abs(h6 - 2.0 * tl.floor(h6 * 0.5) - 1.0))
    m = cmax - c
    sector = tl.floor(h6).to(tl.int32) % 6        # non-negative: % is floor-mod
    o = tl.zeros_like(c)
    nr = tl.where(sector == 0, c, tl.where(sector == 1, x, tl.where(
        sector == 2, o, tl.where(sector == 3, o, tl.where(sector == 4, x, c)))))
    ng = tl.where(sector == 0, x, tl.where(sector == 1, c, tl.where(
        sector == 2, c, tl.where(sector == 3, x, o))))
    nb = tl.where(sector == 0, o, tl.where(sector == 1, o, tl.where(
        sector == 2, x, tl.where(sector == 3, c, tl.where(sector == 4, c, x)))))
    r = _clip01(nr + m)
    g = _clip01(ng + m)
    bl = _clip01(nb + m)

    # shared tone curve, then the per-channel color curves
    r = _curve(r, p_ptr, _TONE)
    g = _curve(g, p_ptr, _TONE)
    bl = _curve(bl, p_ptr, _TONE)
    r = _curve(r, p_ptr, _COLOR)
    g = _curve(g, p_ptr, _COLOR + 8)
    bl = _curve(bl, p_ptr, _COLOR + 16)

    tl.store(out_ptr + base, r, mask=mask)
    tl.store(out_ptr + base + 1, g, mask=mask)
    tl.store(out_ptr + base + 2, bl, mask=mask)
    gray = 0.299 * r + 0.587 * g + 0.114 * bl
    tl.store(gsum_ptr + b * n_prog + pid, tl.sum(tl.where(mask, gray, 0.0), axis=0))


@triton.jit
def _contrast(out_ptr, p_ptr, gsum_ptr, hw, n_prog,
              BLOCK: tl.constexpr, PBLOCK: tl.constexpr):
    pid = tl.program_id(0)
    b = tl.program_id(1)
    acc = tl.zeros((PBLOCK,), dtype=tl.float32)
    for start in range(0, n_prog, PBLOCK):       # fixed order: deterministic
        idx = start + tl.arange(0, PBLOCK)
        acc += tl.load(gsum_ptr + b * n_prog + idx, mask=idx < n_prog, other=0.0)
    mean = tl.sum(acc, axis=0) / hw
    contrast = tl.maximum(tl.load(p_ptr + _CONTRAST), 0.0)
    offs = pid * BLOCK + tl.arange(0, BLOCK)
    mask = offs < hw * 3
    ptr = out_ptr + b * hw * 3 + offs
    v = tl.load(ptr, mask=mask, other=0.0)
    tl.store(ptr, _clip01((v - mean) * contrast + mean), mask=mask)   # in place


def launch(image: torch.Tensor, out: torch.Tensor, packed: torch.Tensor,
           partials: torch.Tensor, pixels_per_program: int) -> None:
    """Launch both passes on the current stream. The wrapper has checked the
    tensors and allocated ``out`` (like ``image``) and ``partials`` (B,
    n_prog)."""
    b, h, w, _ = image.shape
    hw = h * w
    n_prog = partials.shape[1]
    with torch.cuda.device(image.device):
        _pointwise_prefix[(n_prog, b)](image, out, packed, partials, hw, n_prog,
                                       BLOCK=pixels_per_program, num_warps=4)
        block = 4 * pixels_per_program
        _contrast[(triton.cdiv(3 * hw, block), b)](out, packed, partials, hw, n_prog,
                                                   BLOCK=block, PBLOCK=1024, num_warps=4)
