"""The yardstick's arithmetic: FLOPs of each kind of call as
``FlopCounterMode`` counts them on the plain reference networks (on the
``meta`` device: shapes only, no memory, no time on the chip), the least time
of a flash-attention launch, and the union of device intervals."""

from __future__ import annotations

import functools
from typing import Dict, Iterable, List, Sequence, Tuple

from benchmark.common import PEAK_BF16_FLOPS, PEAK_FP32_FLOPS, PEAK_HBM_BYTES, plain_unet_config


def _count(fn) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False, depth=0) as counter:
        fn()
    return float(counter.get_total_flops())


@functools.lru_cache(maxsize=None)
def _edit_kinds(config_json: str) -> Dict[str, float]:
    import json

    import torch

    from benchmark.reference import nets

    cfg = json.loads(config_json)
    ucfg, vcfg = plain_unet_config(cfg), cfg["vae"]
    px = cfg["resolution"]
    hw = px // 2 ** (len(vcfg["block_out_channels"]) - 1)
    xl = ucfg.get("addition_embed_type") == "text_time"
    meta = torch.device("meta")
    with meta:
        unet = nets.frozen(nets.UNet(ucfg))
        vae = nets.frozen(nets.Vae(vcfg))
        midu = nets.frozen(nets.Midu(xl, ucfg["block_out_channels"][-1]))
    lat = torch.empty(1, hw, hw, ucfg["in_channels"], device=meta)
    ctx = torch.empty(1, cfg["text_len"], ucfg["cross_attention_dim"], device=meta)
    added = None
    if xl:
        added = (torch.empty(1, ucfg["addition_pooled_dim"], device=meta),
                 torch.empty(1, 6, device=meta))

    def fwd(latents=lat, context=ctx):
        return nets.unet_forward(unet, latents, 500, context, added)

    def nto_inner():
        c = ctx.clone().requires_grad_(True)
        eps, _ = fwd(context=c)
        eps.sum().backward()

    def guide():
        x = lat.clone().requires_grad_(True)
        _, mid = fwd(latents=x)
        nets.va_score(midu(mid)).backward()

    image = torch.empty(1, px, px, 3, device=meta)
    return {
        "unet": _count(fwd),
        "unet_grad_embeds": _count(nto_inner),
        "unet_grad_latents": _count(guide),
        "vae_encode": _count(lambda: vae.encode(image)),
        "vae_decode": _count(lambda: vae.decode(lat)),
        "midu": _count(lambda: midu(torch.empty(1, hw // 2 ** (len(ucfg["block_out_channels"]) - 1),
                                                hw // 2 ** (len(ucfg["block_out_channels"]) - 1),
                                                ucfg["block_out_channels"][-1], device=meta))),
    }


def edit_kinds(config: dict) -> Dict[str, float]:
    """FLOPs of one image through each kind of call the edit makes."""
    import json

    return dict(_edit_kinds(json.dumps(config, sort_keys=True)))


def edit_flops(kinds: Dict[str, float], images: int, invert_steps: int, sample_steps: int,
               inner_iterations: Sequence[int], nto: bool) -> float:
    """FLOPs of the batched edit of ``images`` images, from the calls it
    made: two scorings (encode, UNet, midu) and one encode; one UNet forward
    per inversion step; per null-text outer step a conditional forward, its
    inner iterations (the whole batch each) and the CFG pair; per sampling
    step the CFG pair and the guidance gradient; one decode."""
    k = kinds
    per_image = 2 * (k["vae_encode"] + k["unet"] + k["midu"]) + k["vae_encode"]
    per_image += invert_steps * k["unet"]
    if nto:
        per_image += len(inner_iterations) * 3 * k["unet"]
        per_image += sum(inner_iterations) * k["unet_grad_embeds"]
    per_image += sample_steps * (2 * k["unet"] + k["unet_grad_latents"])
    per_image += k["vae_decode"]
    return images * per_image


def unet_forward_equivalents(invert_steps: int, sample_steps: int,
                             inner_iterations: Sequence[int], nto: bool) -> int:
    """Single-image UNet forwards per image, a backward counting two: two
    scorings, the inversion, per null-text outer step 1 + 3 per inner
    iteration + 2, per sampling step the CFG pair + 3."""
    n = 2 + invert_steps + sample_steps * 5
    if nto:
        n += 3 * len(inner_iterations) + 3 * sum(inner_iterations)
    return n


@functools.lru_cache(maxsize=None)
def _train_kinds(config_json: str, batch: int) -> float:
    import json

    import torch

    from benchmark.reference import nets

    cfg = json.loads(config_json)
    ucfg, vcfg, px = plain_unet_config(cfg), cfg["vae"], cfg["resolution"]
    hw = px // 2 ** (len(vcfg["block_out_channels"]) - 1)
    mid_hw = hw // 2 ** (len(ucfg["block_out_channels"]) - 1)
    xl = ucfg.get("addition_embed_type") == "text_time"
    meta = torch.device("meta")
    with meta:
        teacher = nets.frozen(nets.Teacher(cfg["teacher"]["input_size"],
                                           cfg["teacher"]["crop_size"]))
        unet = nets.frozen(nets.UNet(ucfg))
        vae = nets.frozen(nets.Vae(vcfg))
        midu = nets.Midu(xl, ucfg["block_out_channels"][-1])
    image = torch.empty(batch, px, px, 3, device=meta)
    lat = torch.empty(batch, hw, hw, ucfg["in_channels"], device=meta)
    ctx = torch.empty(batch, 8, ucfg["cross_attention_dim"], device=meta)
    added = None
    if xl:
        added = (torch.empty(1, ucfg["addition_pooled_dim"], device=meta),
                 torch.empty(1, 6, device=meta))

    def midu_step():
        out = midu(torch.empty(batch, mid_hw, mid_hw, ucfg["block_out_channels"][-1],
                               device=meta))
        out.sum().backward()

    return (_count(lambda: teacher(image)) + _count(lambda: vae.encode(image))
            + _count(lambda: nets.unet_forward(unet, lat, 500, ctx, added))
            + _count(midu_step))


def train_step_flops(config: dict, batch: int) -> float:
    """FLOPs of one midu training step of ``batch`` images: the teacher's ten
    crops, the VAE encode, the UNet forward and the midu's forward and
    backward."""
    import json

    return _train_kinds(json.dumps(config, sort_keys=True), batch)


#: Each flash-attention kernel's products per (batch, head), in units of
#: n^2 d multiply-adds times two: the forward's QK^T and PV; dK/dV's QK^T,
#: dO V^T, P^T dO and dS^T Q; dQ's QK^T, dO V^T and dS K.
FLASH_PRODUCTS = {"fwd": 2, "bwd_dkv": 4, "bwd_dq": 3}
#: The (batch, head, n, d) tensors each kernel reads and writes, and its
#: float32 (batch, head, n) vectors (the log-sum-exp; and the row sums).
FLASH_TENSORS = {"fwd": 4, "bwd_dkv": 6, "bwd_dq": 5}
FLASH_VECTORS = {"fwd": 1, "bwd_dkv": 2, "bwd_dq": 2}


def flash_least_seconds(kind: str, batch: int, heads: int, n: int, d: int,
                        bytes_per_value: int = 2) -> float:
    """The least time of one flash-attention launch of ``kind`` (``fwd``,
    ``bwd_dkv`` or ``bwd_dq``) over (batch, heads, n, d): the larger of its
    operations (``FLASH_PRODUCTS`` products of 2 n^2 d each per head) over
    the peak of its type (the bf16 tensor cores, or float32 on the CUDA
    cores) and its bytes (every (n, d) tensor read or written once, the
    float32 vectors once) over the HBM peak."""
    flops = 2.0 * FLASH_PRODUCTS[kind] * batch * heads * n * n * d
    peak = PEAK_BF16_FLOPS if bytes_per_value == 2 else PEAK_FP32_FLOPS
    data = batch * heads * (FLASH_TENSORS[kind] * n * d * bytes_per_value
                            + 4 * FLASH_VECTORS[kind] * n)
    return max(flops / peak, data / PEAK_HBM_BYTES)


def launches_least_seconds(launches: Iterable[Tuple[str, Tuple[int, ...], int]]) -> float:
    """The least time of recorded launches, each (kind, (batch, heads, n,
    d), bytes per value)."""
    return sum(flash_least_seconds(kind, *shape, bytes_per_value=width)
               for kind, shape, width in launches)


def union_seconds(intervals: Iterable[Tuple[float, float]]) -> float:
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, None
    start = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    if end is not None:
        total += end - start
    return total


def gaps(intervals: List[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, cursor = [], lo
    for s, e in sorted(intervals):
        if s > cursor:
            out.append((cursor, min(s, hi)))
        cursor = max(cursor, e)
        if cursor >= hi:
            break
    if cursor < hi:
        out.append((cursor, hi))
    return [(a, b) for a, b in out if b > a]
