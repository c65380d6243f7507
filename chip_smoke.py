#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA GPU and check them.

    python3 chip_smoke.py

Phases (every check raises; nothing is caught):

1. Device: require CUDA; print the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them, with the torch and CUDA versions.
2. Kernels: build every kernel from this checkout's sources (the four CUDA
   C++ sources with ``nvcc`` for ``sm_90a``, one process per source, started
   together), run each on the card at the main paths' shapes and hold it
   against its plain PyTorch version. K1 (pointwise chain): the re-render's
   (1, 1024, 1024, 3), the batch (4, 1024, 1024, 3) and a ragged
   (1, 1000, 760, 3), max abs error <= 2e-5 (the tolerance of
   tests/test_pallas.py); timed per call (CUDA events around the wrapper,
   host work included) at both 1024 px shapes, and on the device alone (the
   call replayed from a CUDA graph). K2 (flash attention forward,
   backward dK/dV, backward dQ): the UNet's (2, 5, 16384, 64), the VAE's
   (1, 1, 16384, 512), the ragged (1, 5, 9000, 64) and (1, 1, 2100, 512),
   and widths 32, 128, 36 and 256, in float32 and bfloat16; tolerances in
   ``K2_TOLERANCE`` below; the route of each of the three kernels
   (``kernel_route``: tensor, wide, float32 or cuda_cores) is printed per
   shape. Kernel and plain version are timed with CUDA events in
   alternation; one PyTorch call that computes the same function
   (``scaled_dot_product_attention`` and its autograd backward) is timed
   beside them as a yardstick only; float32 dQ is also timed at
   (1, 5, 16384, 64), the null-text step's shape. Kernel and matmul routes
   are also timed at (2, 10, 4096, 64), below the modules' gate, in both
   types.
3. Slice A's path: the parametric-edit CLI's per-batch function
   (``edit_batch``) on 4 random 480x480 images: ResNet-50 ten-crop 480/448
   regressor and CLIP ViT-B/32 at 224 with random weights from the seed, 100
   Adam steps, one adaptation (alpha 0.1), then evaluate, then the 1024 px
   re-render through kernel K1 (after a 2-step warm-up edit without the
   re-render). Checks: K1 launched, finite losses, best <= first loss per
   image, outputs in [0, 1]; the objective at image 0's last vector (rtol
   1e-3) and its re-render (atol 1e-4) agree with the same computation on
   the CPU.
4. The diffusion edit in float32: the diffusion-edit CLI's ``build_models``
   and per-image function (``adapt_image``) on one random 1024 px image at
   SD-2.1 width (UNet ``sd21``, VAE ``sd``, OpenCLIP ViT-H text tower,
   ``MiduSD``), random weights from the seed, ``--dtype float32`` with TF32
   off, null-text optimization on, ``--cfg-scale 2.0 --clf-scale 0.2
   --reference-value 0.1`` and ``FLOAT32_STEPS`` DDIM steps (the only cut:
   the CLI's default is 50). Checks: each K2 launch count equals the count
   the code implies (derived and printed); latents, null-text embeddings and
   the image finite; the image (1, 1024, 1024, 3) in [0, 1]; every
   classifier-guidance gradient non-zero; the null-text embeddings and their
   Adam moments float32.
5. Card against CPU with the same full-width modules at 256 px (below the
   gate, so this holds everything but the kernels): one CFG +
   classifier-guidance sampling step, the loss and gradient of one
   null-text inner step, and the first two table-DPM inversion steps:
   rtol 1e-3.
6. Kernel route against plain route through the modules: ``CrossAttention``
   (self) and ``VaeAttention`` outputs and input gradients at the path's
   shapes against the same projections fed to the plain flash attention, in
   float32 and (after phase 7's models are built) in bfloat16.
7. The diffusion edit in bfloat16, the type the CLI takes at ``--scale sd``
   when no ``--dtype`` is given: the same image, options and checks as phase
   4 at ``DIFFUSION_STEPS`` DDIM steps. Before it, the same bfloat16 models
   edit the image at ``FLOAT32_STEPS`` steps, and the distance of the output
   latents from phase 4's is printed (recorded, not checked: null-text
   optimization on random weights amplifies rounding). The text tower, the
   null-text embeddings and their Adam moments stay float32 here too.
8. The SDXL edit in bfloat16, the type the CLI takes at ``--scale sdxl``:
   ``build_models`` (SDXL base width: UNet ``sdxl``, VAE ``sdxl``, CLIP
   ViT-L and OpenCLIP bigG text towers, ``MiduSDXL``; random weights from the
   seed, made on the host and moved once, the time printed) and
   ``adapt_image`` on the 1024 px image with ``--scheduler dpm`` (karras
   sigmas + lu lambdas, forward and dedup'd inverse tables; the inverse
   table's length printed), null-text optimization on, ``--cfg-scale 2.0
   --clf-scale 0.2 --reference-value 0.1`` and ``SDXL_STEPS`` DPM steps (the
   only cut: the CLI's default is 50). Checks: the K2 launch counts equal
   the derivation (the VAE's mid block, 16384 positions, once per VAE pass,
   on the forward's ``wide`` route; no backward launch; the UNet attends
   over 4096 positions or fewer, below the gate); latents, null-text
   embeddings and the image finite; the image (1, 1024, 1024, 3) in [0, 1];
   every classifier-guidance gradient non-zero; the pooled embeddings, the
   time ids, the null-text embeddings and their Adam moments float32;
   seconds per phase and peak memory printed.
9. Card against CPU for SDXL: float32 copies of that stack's UNet at 256 px
   (1024 and 256 positions, below the gate) on the card and on the CPU: one
   CFG + classifier-guidance sigma-space DPM step with the SDXL conditioning
   (through a ``MiduSD`` head: ``MiduSDXL`` reads the 32 x 32 mid features
   of 1024 px only), and the loss and gradient of one null-text inner step:
   rtol 1e-3.
10. The tiled VAE on the card against the same tiled calls on the CPU: the
   SDXL VAE in float32 at 512 px, latent tiles of 32 (stride 24: 9 tiles),
   decode and encode, atol 1e-4.
11. ``cli/bench.py``'s workload (the root bench.py's): its ``build`` and
   ``run`` at 256 px, batch ``BENCH_BATCH``, ``NUM_STEPS`` steps, the frozen
   ResNet-50 and CLIP in bfloat16, after a 2-step warm-up edit; img/s, ms
   per step, MFU, seconds and peak memory printed. Checks: no K1/K2
   launch, finite losses, best <= first loss per image, outputs in [0, 1].
   Then the bfloat16 objective of image 0 against the same objective with
   the float32 models (the weights before rounding), both on the card, term
   by term (the VA and the CLIP term, each with weight 1, and the objective
   at the bench's weights): at a vector within ``AWAY`` of the identity, the
   values and gradients (limits ``BF16_*``; each term at least four times
   its limit, so that one left out fails), and at the edit's last vector the
   objective, relative to its size.
12. The MUNIT style-code edit at full width in bfloat16:
   ``cli/bench_gan.py``'s ``build`` and ``run`` (``MunitGenConfig()``,
   1024 px, batch ``GAN_BATCH``, ``NUM_STEPS`` Adam steps, random weights
   from the seed, images in [-1, 1]). Checks: no K1/K2 launch; losses and
   edited images finite; images in [-1, 1]; best <= first loss per image;
   the style codes float32. ms per step, MFU, seconds and peak memory
   printed.
13. The GAN edit on the card against the CPU in float32: the full-width
   generator, the regressor on [-1, 1] images and the shipped-width patch
   discriminator (``weight_dis`` 0.1) at ``GAN_CPU_SIZE`` px: the content
   and style codes, a decode and one objective value, relative to their
   largest entry: ``GAN_CPU_RTOL``; the objective's style gradient, a sum of
   terms that cancel (its distance from the float64 gradient is printed),
   to ``GAN_GRAD32_RTOL``; then all of it again with the same modules in
   float64, to ``GAN_CPU_RTOL``. No K1/K2 launch.
14. Each path is driven with the launch counts set to 0 just before it and
   read just after. One JSON line ``{"kernels": [...]}`` (the K2 entries'
   times are bfloat16's, the type the full-width path runs by default, with
   float32's beside them under ``float32_*``; their launches the sum of
   phase 4's, phase 7's and phase 8's edit; the GAN path and the bench
   launch none), then the card, then the last line ``{"ok": true,
   "device": {...}}``.

Exits non-zero, printing no result, without CUDA or outside a checkout of
the repository.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
NUM_IMAGES, EDIT_SIZE, OUTPUT_SIZE, NUM_STEPS, ALPHA = 4, 480, 1024, 100, 0.1
TOLERANCE = 2e-5

# The diffusion edits: phase 7's (bfloat16) and phase 4's (float32) DDIM steps.
DIFFUSION_SIZE, DIFFUSION_STEPS, FLOAT32_STEPS = 1024, 20, 6
CFG_SCALE, CLF_SCALE, REFERENCE_VALUE = 2.0, 0.2, 0.1
ATTENTION_SITES_UNET = 5   # down_0_attn_0/1, up_3_attn_0/1/2: 16384 positions, 5 heads of 64
ATTENTION_SITES_UNET_DOWN = 2  # the sites a gradient through the mid features reaches
# The SDXL edit's DPM steps (phase 8), and the sizes of its checks against
# the CPU (phases 9 and 10).
SDXL_STEPS, SDXL_CPU_SIZE, TILED_VAE_SIZE, VAE_TILE = 6, 256, 512, 32
# The bench's workload (phase 11), the GAN edit (phase 12) and its check
# against the CPU (phase 13). The GAN card-against-CPU tolerance is relative
# to the largest entry.
BENCH_BATCH, GAN_BATCH, GAN_SIZE, GAN_CPU_SIZE = 12, 4, 1024, 128
GAN_CPU_RTOL, GAN_GRAD32_RTOL = 1e-3, 5e-2
# Phase 11 holds the bfloat16 parametric objective of image 0 to the float32
# one term by term, at a vector within AWAY of the identity: the VA term
# relative to its size, the CLIP term 1 - cos (a value on bfloat16's grid of
# 2^-8) within two steps of that grid, the objective within the weighted sum
# of the two, and each term's gradient within BF16_GRAD_DIST of the float32
# gradient's norm. At the edit's last vector the objective is held relative
# to its size. Limits from readings on an H100 at 700 W (PERF.md): VA
# 1.8 %, CLIP 1.25e-3, gradients 2.4e-2 (VA) and 4.8e-3, the last vector's
# objective 9.7 %.
AWAY, BF16_VA_RTOL, BF16_CLIP_ATOL = 0.1, 2.0 ** -4, 2.0 ** -7
BF16_GRAD_DIST, BF16_LAST_RTOL = 2.0 ** -3, 0.25

# K2 against its plain version. float32: both sum in float32 in different
# orders; outputs and log-sum-exp are of order 1 or smaller, gradients are
# compared relative to their largest entry. bfloat16: kernel and plain
# version round P and dS to bfloat16 at the same points and sum in float32,
# so they differ by the order of the sums, by a P or dS that sits next to a
# rounding boundary, and then by the one rounding of the result to 8
# significant bits: at most one step of that grid, 2^-7 of the largest
# entry. The gradients get 1e-2 (2e-2 before the plain version rounded where
# the kernels do): one step of the grid plus what di = rowsum(o * do)
# inherits from the rounded output.
K2_TOLERANCE = {
    torch.float32: dict(out=2e-5, lse=2e-5, grad=1e-4),
    torch.bfloat16: dict(out=2.0 ** -7, lse=2e-5, grad=1e-2),
}

# Published peaks of one H100 SXM: dense float32 outside the tensor cores,
# dense bfloat16 in them, and the HBM3 rate.
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12


def time_group(fns, warmup=3, reps=20):
    """Median milliseconds of each ``fn()`` of ``fns``, timed with CUDA events
    in alternation on the current stream."""
    for _ in range(warmup):
        for fn in fns:
            fn()
    times = [[] for _ in fns]
    for _ in range(reps):
        for fn, ts in zip(fns, times):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
    return [float(np.median(ts)) for ts in times]


def bound(flops, n_bytes, dtype):
    """The least milliseconds the card could take: operations over the peak
    rate of their type, or bytes over the memory rate, whichever is larger."""
    by_ops, by_bytes = flops / PEAK_FLOPS[dtype] * 1e3, n_bytes / PEAK_BYTES * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def draw_params(rng, device):
    """K1's parameters drawn as tests/test_pallas.py:12-20 draws them."""
    from rgie_tpu_torch.ops import chain as CH

    p = CH.init_params(device=device)
    p.exposure = torch.tensor(rng.uniform(-0.4, 0.4), dtype=torch.float32, device=device)
    p.saturation = torch.tensor(rng.uniform(0.4, 1.8), dtype=torch.float32, device=device)
    p.contrast = torch.tensor(rng.uniform(0.5, 1.6), dtype=torch.float32, device=device)
    p.tone = torch.tensor(rng.uniform(0.6, 1.4, (8, 1)), dtype=torch.float32, device=device)
    p.color = torch.tensor(rng.uniform(0.6, 1.4, (8, 3)), dtype=torch.float32, device=device)
    return p


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def rel_err(got, expect):
    """Max abs error relative to the largest entry of ``expect``."""
    return float((got.float() - expect.float()).abs().max() / expect.float().abs().max())


def flash_attention_phase(device, card):
    """Phase 2 for K2: checks at the paths' shapes in both types, then
    timings. Returns the three entries of the ``kernels`` line (launches are
    filled in by the path phase; the forward's entry also carries the times
    of its wide kernel at the VAE's shape)."""
    import torch.nn.functional as F

    from rgie_tpu_torch.ops.kernels import flash_attention as FA

    for dtype, tol in K2_TOLERANCE.items():
        print(f"flash attention tolerance {dtype}: out {tol['out']:g} (bf16: of the largest "
              f"entry), lse {tol['lse']:g}, gradients {tol['grad']:g} of their largest entry")

    def make(shape, dtype, seed):
        b, h, n, d = shape
        rng = np.random.default_rng(seed)
        # (b, n, h, d) storage seen as (b, h, n, d): the modules' own layout.
        return [torch.from_numpy(rng.standard_normal((b, n, h, d)).astype(np.float32))
                .to(device).to(dtype).transpose(1, 2) for _ in range(4)]

    errors = {dtype: {"fwd": 0.0, "dkv": 0.0, "dq": 0.0} for dtype in K2_TOLERANCE}
    timings = {}
    unet_shape, vae_shape = (2, 5, 16384, 64), (1, 1, 16384, 512)
    for shape in [unet_shape, vae_shape, (1, 5, 9000, 64), (2, 3, 1000, 32), (1, 2, 2100, 128),
                  (1, 2, 1000, 36), (1, 1, 2100, 512), (1, 2, 1000, 256)]:
        for dtype, tol in K2_TOLERANCE.items():
            q, k, v, do = make(shape, dtype, shape[2] + shape[3])
            scale = 1.0 / shape[3] ** 0.5
            o, lse = FA.flash_attention_with_lse(q, k, v, scale)
            ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
            dq, dk, dv = torch.autograd.grad(FA.flash_attention(ql, kl, vl, sm_scale=scale),
                                             (ql, kl, vl), do)
            torch.cuda.synchronize()
            o_ref, lse_ref = FA.reference_flash_attention(q, k, v, scale)
            dq_ref, dk_ref, dv_ref = FA.reference_flash_attention_bwd(q, k, v, o_ref, lse_ref,
                                                                      do, scale)
            e_out = float((o.float() - o_ref.float()).abs().max())
            if dtype == torch.bfloat16:
                e_out /= float(o_ref.float().abs().max())
            e_lse = float((lse - lse_ref).abs().max())
            e_dq, e_dk, e_dv = rel_err(dq, dq_ref), rel_err(dk, dk_ref), rel_err(dv, dv_ref)
            routes = ", ".join(f"{kn} {FA.kernel_route(kn, dtype, shape[3])}" for kn in FA.KERNELS)
            print(f"flash attention {shape} {dtype} (routes: {routes}): out {e_out:.3e}, "
                  f"lse {e_lse:.3e}, dq {e_dq:.3e}, dk {e_dk:.3e}, dv {e_dv:.3e}")
            check(e_out <= tol["out"] and e_lse <= tol["lse"],
                  f"flash attention forward disagrees with its plain version at {shape} {dtype}")
            check(max(e_dk, e_dv) <= tol["grad"],
                  f"flash attention dK/dV disagrees with its plain version at {shape} {dtype}")
            check(e_dq <= tol["grad"],
                  f"flash attention dQ disagrees with its plain version at {shape} {dtype}")
            worst = errors[dtype]
            worst.update(fwd=max(worst["fwd"], e_out, e_lse), dkv=max(worst["dkv"], e_dk, e_dv),
                         dq=max(worst["dq"], e_dq))
            if shape[2] != 16384:
                continue

            # Timings: wrapper call, plain version, the library's call.
            di = FA._row_delta(o, do)
            qs, ks, vs, dos = (FA._strided(t) for t in (q, k, v, do))
            qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
            lib_out = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)
            fwd = time_group([lambda: FA._launch_fwd(qs, ks, vs, scale),
                              lambda: FA.reference_flash_attention(q, k, v, scale),
                              lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)], 1, 5)
            dkv = time_group([lambda: FA._launch_bwd_dkv(qs, ks, vs, dos, lse, di, scale),
                              lambda: FA.reference_flash_attention_bwd_dkv(q, k, v, do, lse, di,
                                                                           scale)], 1, 5)
            dqt = time_group([lambda: FA._launch_bwd_dq(qs, ks, vs, dos, lse, di, scale),
                              lambda: FA.reference_flash_attention_bwd_dq(q, k, v, do, lse, di,
                                                                          scale),
                              lambda: torch.autograd.grad(lib_out, (qg, kg, vg), do,
                                                          retain_graph=True)], 1, 5)
            b, h, n, d = shape
            size = q.element_size()
            tensor_bytes, row_bytes = b * h * n * d * size, b * h * n * 4
            mm = 2.0 * b * h * n * n * d   # one N x N x d product
            bounds = {"fwd": bound(2 * mm, 4 * tensor_bytes + row_bytes, dtype),
                      "dkv": bound(4 * mm, 6 * tensor_bytes + 2 * row_bytes, dtype),
                      "dq": bound(3 * mm, 5 * tensor_bytes + 2 * row_bytes, dtype)}
            timings[(shape, dtype)] = dict(fwd=fwd, dkv=dkv + [dqt[2]], dq=dqt, bounds=bounds)
            print(f"flash attention {shape} {dtype} ms (median of 5, CUDA events) on {card}: "
                  f"fwd kernel {fwd[0]:.3f} plain {fwd[1]:.3f} library sdpa {fwd[2]:.3f} bound "
                  f"{bounds['fwd'][0]:.3f}; dkv kernel {dkv[0]:.3f} plain {dkv[1]:.3f} bound "
                  f"{bounds['dkv'][0]:.3f}; dq kernel {dqt[0]:.3f} plain {dqt[1]:.3f} bound "
                  f"{bounds['dq'][0]:.3f}; library sdpa backward (dq, dk, dv at once) "
                  f"{dqt[2]:.3f}")

    # float32 dQ at the null-text step's batch of 1 (800 of its launches in a
    # 20-step float32 edit), beside the library's backward and the bound.
    nto_shape = (1, 5, 16384, 64)
    q, k, v, do = make(nto_shape, torch.float32, 11)
    scale = 1.0 / nto_shape[3] ** 0.5
    o, lse = FA.flash_attention_with_lse(q, k, v, scale)
    di = FA._row_delta(o, do)
    qs, ks, vs, dos = (FA._strided(t) for t in (q, k, v, do))
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)
    nto_dq = time_group([lambda: FA._launch_bwd_dq(qs, ks, vs, dos, lse, di, scale),
                         lambda: torch.autograd.grad(lib_out, (qg, kg, vg), do,
                                                     retain_graph=True)], 1, 5)
    b, h, n, d = nto_shape
    nto_bound = bound(6.0 * b * h * n * n * d, 5 * b * h * n * d * 4 + 2 * b * h * n * 4,
                      torch.float32)
    print(f"flash attention {nto_shape} float32 ms (median of 5, CUDA events) on {card}: dq "
          f"kernel ({FA.kernel_route('bwd_dq', torch.float32, d)}) {nto_dq[0]:.3f} bound "
          f"{nto_bound[0]:.3f}; library sdpa backward (dq, dk, dv at once) {nto_dq[1]:.3f}")
    del q, k, v, do, o, lse, di, qs, ks, vs, dos, qg, kg, vg, lib_out

    # Below the gate: the kernel route against the modules' matmul route, in
    # both types (the gate's threshold is recorded against them, not moved).
    shape = (2, 10, 4096, 64)
    scale = 1.0 / 8.0

    def matmul_route(q, k, v):
        attn = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) / 8.0, dim=-1)
        return torch.matmul(attn, v)

    for dtype in K2_TOLERANCE:
        q, k, v, do = make(shape, dtype, 7)
        ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
        small = time_group([
            lambda: FA.flash_attention(q, k, v, sm_scale=scale), lambda: matmul_route(q, k, v),
            lambda: torch.autograd.grad(FA.flash_attention(ql, kl, vl, sm_scale=scale),
                                        (ql, kl, vl), do),
            lambda: torch.autograd.grad(matmul_route(ql, kl, vl), (ql, kl, vl), do)], 1, 5)
        print(f"attention routes at {shape} {dtype} ms on {card}: forward kernel {small[0]:.3f} "
              f"matmul {small[1]:.3f}; forward+backward kernel {small[2]:.3f} matmul "
              f"{small[3]:.3f}")
        del q, k, v, do, ql, kl, vl
    q, k, v, _ = make(unet_shape, torch.float32, 9)
    torch.cuda.reset_peak_memory_stats()
    big = time_group([lambda: FA.flash_attention(q, k, v, sm_scale=scale),
                      lambda: matmul_route(q, k, v)], 1, 3)
    print(f"attention routes at {unet_shape} float32 ms: forward kernel {big[0]:.3f} matmul "
          f"{big[1]:.3f} (the matmul route's scores: peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB; its backward is not run)")
    del q, k, v
    torch.cuda.empty_cache()

    # The times of the type the full-width path runs by default; float32's
    # (the CLI's --dtype float32) beside them under float32_*.
    t = timings[(unet_shape, torch.bfloat16)]
    wide = timings[(vae_shape, torch.bfloat16)]
    t32 = timings[(unet_shape, torch.float32)]
    wide32 = timings[(vae_shape, torch.float32)]
    common = dict(route="cuda", launches=0, timed_shape=list(unet_shape), timed_dtype="bfloat16")
    source = "rgie_tpu_torch/csrc/flash_attention_{}.cu"
    replaces = "jax/experimental/pallas/ops/tpu/flash_attention.py:{}"
    entries = []
    for key, name, line, fn in [("fwd", "flash_attention_fwd", 758, "_flash_attention_impl"),
                                ("dkv", "flash_attention_bwd_dkv", 1121,
                                 "_flash_attention_bwd_dkv"),
                                ("dq", "flash_attention_bwd_dq", 1456, "_flash_attention_bwd_dq")]:
        entries.append(dict(
            name=name, source=source.format(key if key == "fwd" else "bwd_" + key),
            replaces=replaces.format(line), replaces_function=fn,
            max_abs_err=errors[torch.bfloat16][key],
            max_abs_err_float32=errors[torch.float32][key],
            ms=t[key][0], kernel_ms=t[key][0], plain_ms=t[key][1],
            bound_ms=t["bounds"][key][0], bound_by=t["bounds"][key][1], library_ms=t[key][2],
            float32_route=FA.kernel_route(name.removeprefix("flash_attention_"), torch.float32,
                                          unet_shape[3]),
            float32_ms=t32[key][0], float32_plain_ms=t32[key][1],
            float32_bound_ms=t32["bounds"][key][0], float32_bound_by=t32["bounds"][key][1],
            float32_library_ms=t32[key][2], **common))
    entries[2].update(float32_batch1_shape=list(nto_shape), float32_batch1_ms=nto_dq[0],
                      float32_batch1_bound_ms=nto_bound[0],
                      float32_batch1_library_ms=nto_dq[1])
    # The forward's second tensor-core kernel, at the VAE's single wide head.
    entries[0].update(wide_shape=list(vae_shape), wide_kernel_ms=wide["fwd"][0],
                      wide_plain_ms=wide["fwd"][1], wide_bound_ms=wide["bounds"]["fwd"][0],
                      wide_bound_by=wide["bounds"]["fwd"][1], wide_library_ms=wide["fwd"][2],
                      float32_wide_ms=wide32["fwd"][0], float32_wide_plain_ms=wide32["fwd"][1],
                      float32_wide_bound_ms=wide32["bounds"]["fwd"][0],
                      float32_wide_bound_by=wide32["bounds"]["fwd"][1],
                      float32_wide_library_ms=wide32["fwd"][2])
    return entries


def expected_flash_launches(steps, nto_inner_steps):
    """The K2 launches one single-image edit implies, with its derivation.
    Every UNet forward at 128 x 128 latents launches the forward kernel at its
    5 top-level self-attention sites, every VAE pass once."""
    u, d = ATTENTION_SITES_UNET, ATTENTION_SITES_UNET_DOWN
    inner = sum(nto_inner_steps)
    lines = [
        ("score the original: VAE encode + UNet", 1 + u, 0),
        ("VAE encode", 1, 0),
        (f"invert: {steps} UNet forwards", steps * u, 0),
        # The first site precedes the first cross-attention, so its inputs do
        # not depend on the embeddings and it has no backward.
        (f"null-text: {steps} outer steps x (cond forward + CFG pair forward) + {inner} inner "
         f"steps x (forward, backward at {u - 1} sites)", steps * 2 * u + inner * u,
         inner * (u - 1)),
        (f"sample: {steps} steps x (CFG pair forward + guidance forward, backward through the "
         f"{d} sites below the mid block)", steps * 2 * u, steps * d),
        ("VAE decode", 1, 0),
        ("rescore the edit: VAE encode + UNet", 1 + u, 0),
    ]
    for what, fwd, bwd in lines:
        print(f"  launches expected, {what}: forward {fwd}, dK/dV {bwd}, dQ {bwd}")
    return sum(f for _, f, _ in lines), sum(b for _, _, b in lines)


def diffusion_models(device, image_path, dtype_name, steps):
    """The diffusion CLI's parsed arguments and model stack at SD-2.1 width for
    one 1024 px image; ``dtype_name`` None leaves the type to the CLI's
    default (bfloat16 at ``--scale sd``)."""
    from rgie_tpu_torch.cli import adapt_images as cli

    args = cli.build_parser().parse_args([
        "--scale", "sd", "--input-size", str(DIFFUSION_SIZE), "--num-steps", str(steps),
        "--cfg-scale", str(CFG_SCALE), "--clf-scale", str(CLF_SCALE),
        "--reference-value", str(REFERENCE_VALUE),
        "--out-dir", os.path.join(os.path.dirname(image_path), "out_" + (dtype_name or "default")),
        "--device", "cuda", "--seed", "0"] + (["--dtype", dtype_name] if dtype_name else []))
    t0 = time.perf_counter()
    stack = cli.build_models(args, torch.Generator().manual_seed(args.seed), device)
    torch.cuda.synchronize()
    dtype = next(stack.pipe.unet.parameters()).dtype
    print(f"diffusion edit: models built in {dtype} (random weights, seed 0) in "
          f"{time.perf_counter() - t0:.1f} s")
    return args, stack


def diffusion_path_phase(args, stack, image_path, steps, card):
    """One SD-2.1 edit of the 1024 px image through the diffusion CLI's
    functions, at ``steps`` DDIM steps (the stack's schedule is replaced when
    it was built for another count). Returns (the three launch counts, the
    output latents)."""
    import argparse
    import dataclasses

    from rgie_tpu_torch.cli import adapt_images as cli
    from rgie_tpu_torch.diffusion import schedulers as SCH
    from rgie_tpu_torch.ops.kernels import flash_attention as FA

    if steps != args.num_steps:
        args = argparse.Namespace(**{**vars(args), "num_steps": steps})
        stack = stack._replace(pipe=dataclasses.replace(stack.pipe, sched=SCH.make_schedule(steps)))
    adapter, manager = cli.make_adapter(stack, args.out_dir)
    gcfg, acfg = cli.make_configs(args)
    dtype = next(stack.pipe.unet.parameters()).dtype

    torch.cuda.reset_peak_memory_stats()
    FA.LAUNCHES_FWD = FA.LAUNCHES_BWD_DKV = FA.LAUNCHES_BWD_DQ = 0
    t0 = time.perf_counter()
    outputs = cli.adapt_image(adapter, manager, image_path, gcfg, acfg, "a random image")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = (FA.LAUNCHES_FWD, FA.LAUNCHES_BWD_DKV, FA.LAUNCHES_BWD_DQ)
    peak = torch.cuda.max_memory_allocated()

    log = adapter.last_log
    print(f"diffusion edit {dtype}: {steps} DDIM steps (the CLI's default is 50; nothing else "
          f"is cut), null-text inner steps per outer step {log.nto_inner_steps}")
    want_fwd, want_bwd = expected_flash_launches(steps, log.nto_inner_steps)
    print(f"  launches counted: forward {counts[0]}, dK/dV {counts[1]}, dQ {counts[2]}; "
          f"expected {want_fwd}, {want_bwd}, {want_bwd}")
    check(counts == (want_fwd, want_bwd, want_bwd), "K2 launch counts differ from the derivation")
    check(min(counts) > 0, "a flash attention kernel was not launched in the diffusion edit")

    (label, image), = outputs.items()
    check(image.shape == (1, DIFFUSION_SIZE, DIFFUSION_SIZE, 3), "edited image shape")
    check(bool(torch.isfinite(image).all()), "non-finite edited image")
    check(float(image.min()) >= 0.0 and float(image.max()) <= 1.0, "edited image outside [0, 1]")
    for name in ("latents", "noisy", "nto_embeds", "out_latents"):
        check(bool(torch.isfinite(log.tensors[name]).all()), f"non-finite {name}")
    check(log.tensors["nto_embeds"].shape == (steps, 77, 1024), "null-text embeddings")
    # Whatever the models' type, the null-text embeddings and their Adam
    # moments stay float32, as in the JAX package.
    for name in ("nto_embeds", "nto_adam_m", "nto_adam_v"):
        check(log.tensors[name].dtype == torch.float32, f"{name} is {log.tensors[name].dtype}")
    norms = [float(g) for g in log.clf_grad_norms]
    check(len(norms) == steps and all(np.isfinite(g) and g > 0 for g in norms),
          f"classifier-guidance gradient norms {norms}")
    check(os.path.exists(os.path.join(args.out_dir, label, os.path.basename(image_path))),
          "saved image")
    phases = ", ".join(f"{k} {v:.3f}" for k, v in log.seconds.items())
    print(f"diffusion edit {dtype}: {seconds:.3f} s for one 1024 px image at {steps} steps "
          f"(scoring the original included), peak memory {peak / 2**30:.2f} GiB, null-text "
          f"embeddings and Adam moments {log.tensors['nto_embeds'].dtype}, on {card}")
    print(f"  seconds per phase: {phases}; classifier-guidance gradient norms "
          + " ".join(f"{g:.3e}" for g in norms))
    return counts, log.tensors["out_latents"].detach().float().cpu()


def card_against_cpu_phase(stack, rng):
    """Phase 5: the full-width modules at 256 px (1024 positions, below the
    gate) on the card and on the CPU."""
    import copy
    import dataclasses

    from rgie_tpu_torch.diffusion import schedulers as SCH

    pipe = stack.pipe
    device = pipe.device
    pipe_cpu = dataclasses.replace(
        pipe, unet=copy.deepcopy(pipe.unet).cpu(), midu_model=copy.deepcopy(pipe.midu_model).cpu())

    def arr(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    lat, lat_prev = arr(1, 32, 32, 4), arr(1, 32, 32, 4)
    embeds, nto = arr(2, 77, 1024), arr(FLOAT32_STEPS, 77, 1024)
    ref = torch.tensor([[0.4, 0.6]])
    ts, next_ts, i_vals = pipe.sample_tables(0)

    def sample_step(p, dev):
        out, _ = p.sample_steps(lat.to(dev), None, embeds.to(dev), None, ts[:1], next_ts[:1],
                                i_vals[:1], guidance_scale=CFG_SCALE,
                                guidance_clf_scale=CLF_SCALE,
                                uncond_embeds_per_step=nto.to(dev),
                                midu_reference_value=ref.to(dev))
        return out.cpu()

    def inner_step(p, dev):
        t = int(ts[0])
        with torch.no_grad():
            eps_cond, _ = p._unet(lat.to(dev), t, embeds[1:].to(dev), None)
        loss, grad = p.null_inner_loss_and_grad(embeds[:1].to(dev), lat.to(dev), t, eps_cond,
                                                lat_prev.to(dev), CFG_SCALE)
        return loss.cpu(), grad.cpu()

    def table_dpm_inversion_steps(p, dev):
        # The first two steps of table-DPM inversion: first order, then second.
        p = dataclasses.replace(p, scheduler_type="dpm")
        ts, src_ts, i_vals = p.invert_tables()
        state = SCH.dpm_init_state(lat.shape, device=dev)
        _, _, pivots = p.invert_steps(lat.to(dev), state, embeds[:1].to(dev), None, ts[:2],
                                      src_ts[:2], i_vals[:2])
        return pivots.cpu()

    t0 = time.perf_counter()
    step_card, step_cpu = sample_step(pipe, device), sample_step(pipe_cpu, torch.device("cpu"))
    (loss_card, grad_card), (loss_cpu, grad_cpu) = (inner_step(pipe, device),
                                                    inner_step(pipe_cpu, torch.device("cpu")))
    inv_card = table_dpm_inversion_steps(pipe, device)
    inv_cpu = table_dpm_inversion_steps(pipe_cpu, torch.device("cpu"))
    e_step, e_grad = rel_err(step_card, step_cpu), rel_err(grad_card, grad_cpu)
    e_inv = rel_err(inv_card, inv_cpu)
    print(f"card against CPU at 256 px, full width: guided sampling step {e_step:.3e}; null-text "
          f"inner loss {float(loss_card):.7f} vs {float(loss_cpu):.7f}, gradient {e_grad:.3e}; "
          f"two table-DPM inversion steps {e_inv:.3e} (of the largest entry; limit 1e-3) in "
          f"{time.perf_counter() - t0:.1f} s")
    check(e_step <= 1e-3, "guided sampling step disagrees with the CPU")
    check(abs(float(loss_card) - float(loss_cpu)) <= 1e-3 * abs(float(loss_cpu)),
          "null-text inner loss disagrees with the CPU")
    check(e_grad <= 1e-3, "null-text inner gradient disagrees with the CPU")
    check(e_inv <= 1e-3, "table-DPM inversion steps disagree with the CPU")


def module_route_phase(stack, rng):
    """Phase 6: the attention modules at the path's shapes in the stack's
    type, kernel route (through the module) against plain route (the same
    projections through the plain flash attention)."""
    from rgie_tpu_torch.ops.kernels import flash_attention as FA

    pipe = stack.pipe
    device = pipe.device
    dtype = next(pipe.unet.parameters()).dtype
    # float32: the kernels' own limits; bfloat16: the modules round their
    # result once more, so one step of the grid on the output and the
    # kernels' gradient limit.
    limit_y, limit_g = ((1e-4, 1e-4) if dtype == torch.float32 else
                        (K2_TOLERANCE[dtype]["out"], K2_TOLERANCE[dtype]["grad"]))

    def compare(name, module_fn, plain_fn, shape):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device).to(dtype)
        w = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device).to(dtype)
        results = []
        for fn in (module_fn, plain_fn):
            xin = x.clone().requires_grad_(True)
            y = fn(xin)
            (g,) = torch.autograd.grad((y * w).sum(), xin)
            results.append((y.detach(), g))
        (y_k, g_k), (y_p, g_p) = results
        e_y, e_g = rel_err(y_k, y_p), rel_err(g_k, g_p)
        print(f"{name} at {shape} {dtype}: kernel route against plain route, output {e_y:.3e} "
              f"(limit {limit_y:g}), input gradient {e_g:.3e} (limit {limit_g:g}), of the "
              f"largest entry")
        check(e_y <= limit_y and e_g <= limit_g,
              f"{name}: kernel route disagrees with the plain route in {dtype}")

    attn = pipe.unet.down_blocks[0].attentions[0].transformer_blocks[0].attn1

    def cross_plain(x):
        b, n, _ = x.shape
        q, k, v = (proj(x).view(b, n, attn.heads, attn.dim_head).transpose(1, 2)
                   for proj in (attn.to_q, attn.to_k, attn.to_v))
        out = FA.plain_flash_attention(q, k, v, 1.0 / attn.dim_head ** 0.5)
        return attn.to_out[0](out.transpose(1, 2).reshape(b, n, -1))

    compare("CrossAttention (self)", attn, cross_plain, (2, 16384, 320))

    vattn = pipe.vae.decoder.mid_block.attentions[0]

    def vae_plain(x):
        b, c, h, w = x.shape
        y = vattn.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        q, k, v = vattn.to_q(y), vattn.to_k(y), vattn.to_v(y)
        y = FA.plain_flash_attention(q[:, None], k[:, None], v[:, None], 1.0 / c ** 0.5)[:, 0]
        return x + vattn.to_out[0](y).reshape(b, h, w, c).permute(0, 3, 1, 2)

    compare("VaeAttention", vattn, vae_plain, (1, 512, 128, 128))


def expected_sdxl_flash_launches():
    """The K2 launches of one SDXL edit at 1024 px, with the derivation: the
    VAE's mid block attends over 128 x 128 = 16384 positions with one head of
    512 (the forward's wide route), once per VAE pass; the UNet's
    self-attention sits at 64 x 64 and 32 x 32 (4096 and 1024 positions),
    below the gate, and nothing differentiates the VAE."""
    lines = [("score the original: VAE encode", 1), ("VAE encode", 1),
             ("invert, null-text optimization, sample: UNet only", 0), ("VAE decode", 1),
             ("rescore the edit: VAE encode", 1)]
    for what, fwd in lines:
        print(f"  launches expected, {what}: forward {fwd}, dK/dV 0, dQ 0")
    return sum(f for _, f in lines)


def sdxl_path_phase(device, image_path, card):
    """Phase 8: the SDXL edit in the CLI's type at ``--scale sdxl``, through
    ``build_models`` and ``adapt_image``. Returns (the stack, the launch
    counts)."""
    from rgie_tpu_torch.cli import adapt_images as cli
    from rgie_tpu_torch.ops.kernels import flash_attention as FA

    args = cli.build_parser().parse_args([
        "--scale", "sdxl", "--scheduler", "dpm", "--num-steps", str(SDXL_STEPS),
        "--cfg-scale", str(CFG_SCALE), "--clf-scale", str(CLF_SCALE),
        "--reference-value", str(REFERENCE_VALUE),
        "--out-dir", os.path.join(os.path.dirname(image_path), "out_sdxl"),
        "--device", "cuda", "--seed", "0"])
    t0 = time.perf_counter()
    stack = cli.build_models(args, torch.Generator().manual_seed(args.seed), device)
    pipe = stack.pipe
    dtype = pipe.unet.dtype
    check(dtype == torch.bfloat16, f"the diffusion CLI's default type at --scale sdxl is {dtype}")
    check(stack.input_size == DIFFUSION_SIZE and pipe.is_xl, "the SDXL stack's input size")
    print(f"SDXL edit: models built in {dtype} (random weights, seed 0) in "
          f"{time.perf_counter() - t0:.1f} s; sigma tables: {SDXL_STEPS} forward steps (karras "
          f"timesteps {pipe.sigma_sched.timesteps.tolist()}), inverse table of "
          f"{pipe.sigma_sched_inv.num_inference_steps} steps after the dedup (timesteps "
          f"{pipe.sigma_sched_inv.timesteps.tolist()})")
    adapter, manager = cli.make_adapter(stack, args.out_dir)
    gcfg, acfg = cli.make_configs(args, is_xl=True)

    torch.cuda.reset_peak_memory_stats()
    FA.LAUNCHES_FWD = FA.LAUNCHES_BWD_DKV = FA.LAUNCHES_BWD_DQ = 0
    t0 = time.perf_counter()
    outputs = cli.adapt_image(adapter, manager, image_path, gcfg, acfg, "a random image")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = (FA.LAUNCHES_FWD, FA.LAUNCHES_BWD_DKV, FA.LAUNCHES_BWD_DQ)
    peak = torch.cuda.max_memory_allocated()

    log = adapter.last_log
    print(f"SDXL edit {dtype}: {SDXL_STEPS} DPM steps (the CLI's default is 50; nothing else is "
          f"cut), null-text inner steps per outer step {log.nto_inner_steps}")
    want = expected_sdxl_flash_launches()
    print(f"  launches counted: forward {counts[0]}, dK/dV {counts[1]}, dQ {counts[2]}; expected "
          f"{want}, 0, 0; forward route at the VAE's head: "
          f"{FA.kernel_route('fwd', dtype, pipe.vae.cfg.block_out_channels[-1])}")
    check(counts == (want, 0, 0), "SDXL K2 launch counts differ from the derivation")
    check(FA.kernel_route("fwd", dtype, pipe.vae.cfg.block_out_channels[-1]) == "wide",
          "the SDXL VAE's attention is not on the wide route")

    (label, image), = outputs.items()
    check(image.shape == (1, DIFFUSION_SIZE, DIFFUSION_SIZE, 3), "SDXL edited image shape")
    check(bool(torch.isfinite(image).all()), "non-finite SDXL edited image")
    check(float(image.min()) >= 0.0 and float(image.max()) <= 1.0,
          "SDXL edited image outside [0, 1]")
    for name in ("latents", "noisy", "nto_embeds", "out_latents"):
        check(bool(torch.isfinite(log.tensors[name]).all()), f"non-finite SDXL {name}")
    ucfg = pipe.unet.cfg
    check(log.tensors["nto_embeds"].shape == (SDXL_STEPS, 77, ucfg.cross_attention_dim),
          "SDXL null-text embeddings")
    added = adapter.added_cond_fn("a random image", "")
    check(added.text_embeds.shape == (2, ucfg.addition_pooled_dim) and
          added.time_ids.shape == (2, 6), "SDXL added conditioning")
    check(bool(torch.isfinite(added.text_embeds).all()), "non-finite pooled embeddings")
    check(added.time_ids[0].tolist() == [DIFFUSION_SIZE, DIFFUSION_SIZE, 0, 0, DIFFUSION_SIZE,
                                         DIFFUSION_SIZE], "SDXL time ids")
    float32 = {"pooled embeddings": added.text_embeds, "time ids": added.time_ids,
               **{name: log.tensors[name] for name in ("nto_embeds", "nto_adam_m", "nto_adam_v")}}
    for name, tensor in float32.items():
        check(tensor.dtype == torch.float32, f"SDXL {name} is {tensor.dtype}")
    norms = [float(g) for g in log.clf_grad_norms]
    check(len(norms) == SDXL_STEPS and all(np.isfinite(g) and g > 0 for g in norms),
          f"SDXL classifier-guidance gradient norms {norms}")
    check(os.path.exists(os.path.join(args.out_dir, label, os.path.basename(image_path))),
          "saved SDXL image")
    phases = ", ".join(f"{k} {v:.3f}" for k, v in log.seconds.items())
    print(f"SDXL edit {dtype}: {seconds:.3f} s for one 1024 px image at {SDXL_STEPS} steps "
          f"(scoring the original included), peak memory {peak / 2**30:.2f} GiB; pooled "
          f"embeddings, time ids, null-text embeddings and Adam moments float32; on {card}")
    print(f"  seconds per phase: {phases}; classifier-guidance gradient norms "
          + " ".join(f"{g:.3e}" for g in norms))
    return stack, counts


def sdxl_card_against_cpu_phase(stack, rng):
    """Phase 9: float32 copies of the SDXL stack's UNet at 256 px on the card
    and on the CPU."""
    import copy
    import dataclasses

    from rgie_tpu_torch.diffusion import schedulers as SCH
    from rgie_tpu_torch.diffusion.pipeline import SdxlCond
    from rgie_tpu_torch.diffusion.text_encoder import get_add_time_ids
    from rgie_tpu_torch.models.midu import create_midu

    pipe = stack.pipe
    device, cpu = pipe.device, torch.device("cpu")
    unet_cpu = copy.deepcopy(pipe.unet).cpu().float()
    ucfg = unet_cpu.cfg
    midu = create_midu(torch.Generator().manual_seed(1), is_sdxl=False,
                       in_channels=ucfg.block_out_channels[-1])
    pipes = {device: dataclasses.replace(pipe, unet=copy.deepcopy(unet_cpu).to(device),
                                         midu_model=copy.deepcopy(midu).to(device)),
             cpu: dataclasses.replace(pipe, unet=unet_cpu, midu_model=midu)}

    def arr(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    hw = SDXL_CPU_SIZE // pipe.vae.upscale_factor
    lat, lat_prev = arr(1, hw, hw, 4), arr(1, hw, hw, 4)
    width = ucfg.cross_attention_dim
    embeds, nto = arr(2, 77, width), arr(pipe.sched.num_inference_steps, 77, width)
    added = SdxlCond(arr(2, ucfg.addition_pooled_dim),
                     get_add_time_ids(SDXL_CPU_SIZE, SDXL_CPU_SIZE).expand(2, 6))
    ref = torch.tensor([[0.4, 0.6]])
    ts, next_ts, i_vals = pipe.sample_tables(0)

    def on(dev, c):
        return SdxlCond(c.text_embeds.to(dev), c.time_ids.to(dev))

    def sample_step(dev):
        out, _ = pipes[dev].sample_steps(
            lat.to(dev), SCH.dpm_init_state(lat.shape, device=dev), embeds.to(dev),
            on(dev, added), ts[:1], next_ts[:1], i_vals[:1], guidance_scale=CFG_SCALE,
            guidance_clf_scale=CLF_SCALE, uncond_embeds_per_step=nto.to(dev),
            midu_reference_value=ref.to(dev))
        return out.cpu()

    def inner_step(dev):
        p, t = pipes[dev], int(pipe.sched.timesteps[0])
        row = lambda i: on(dev, SdxlCond(added.text_embeds[i:i + 1], added.time_ids[i:i + 1]))
        with torch.no_grad():
            eps_cond, _ = p._unet(lat.to(dev), t, embeds[1:].to(dev), row(1))
        loss, grad = p.null_inner_loss_and_grad(embeds[:1].to(dev), lat.to(dev), t, eps_cond,
                                                lat_prev.to(dev), CFG_SCALE, row(0))
        return loss.cpu(), grad.cpu()

    t0 = time.perf_counter()
    step_card = sample_step(device)
    loss_card, grad_card = inner_step(device)
    t1 = time.perf_counter()
    step_cpu = sample_step(cpu)
    loss_cpu, grad_cpu = inner_step(cpu)
    e_step, e_grad = rel_err(step_card, step_cpu), rel_err(grad_card, grad_cpu)
    print(f"SDXL card against CPU at {SDXL_CPU_SIZE} px, full width, float32: guided sigma-DPM "
          f"sampling step {e_step:.3e}; null-text inner loss {float(loss_card):.7f} vs "
          f"{float(loss_cpu):.7f}, gradient {e_grad:.3e} (of the largest entry; limit 1e-3); "
          f"card {t1 - t0:.1f} s, CPU {time.perf_counter() - t1:.1f} s")
    check(e_step <= 1e-3, "SDXL guided sampling step disagrees with the CPU")
    check(abs(float(loss_card) - float(loss_cpu)) <= 1e-3 * abs(float(loss_cpu)),
          "SDXL null-text inner loss disagrees with the CPU")
    check(e_grad <= 1e-3, "SDXL null-text inner gradient disagrees with the CPU")


def tiled_vae_phase(stack, rng):
    """Phase 10: the SDXL VAE in float32, tiled, on the card and on the CPU."""
    import copy

    from rgie_tpu_torch.diffusion import vae as V

    device, cpu = stack.pipe.device, torch.device("cpu")
    vae_cpu = copy.deepcopy(stack.pipe.vae).cpu().float()
    vaes = {device: copy.deepcopy(vae_cpu).to(device), cpu: vae_cpu}
    hw = TILED_VAE_SIZE // vae_cpu.upscale_factor
    stride = (VAE_TILE * 3) // 4
    lat = torch.from_numpy(rng.standard_normal((1, hw, hw, 4)).astype(np.float32))
    img = torch.from_numpy(rng.uniform(-1, 1, (1, TILED_VAE_SIZE, TILED_VAE_SIZE, 3))
                           .astype(np.float32))
    results = {}
    for dev, vae in vaes.items():
        t0 = time.perf_counter()
        with torch.no_grad():
            dec = V.decode_tiled(vae, lat.to(dev), tile=VAE_TILE, stride=stride).cpu()
            enc = V.encode_tiled(vae, img.to(dev), tile=VAE_TILE, stride=stride).cpu()
        results[dev] = (dec, enc, time.perf_counter() - t0)
    (dec_card, enc_card, s_card), (dec_cpu, enc_cpu, s_cpu) = results[device], results[cpu]
    e_dec = float((dec_card - dec_cpu).abs().max())
    e_enc = float((enc_card - enc_cpu).abs().max())
    n_tiles = len(V.tile_positions(hw, VAE_TILE, stride)) ** 2
    print(f"tiled SDXL VAE at {TILED_VAE_SIZE} px (latent tiles of {VAE_TILE}, stride {stride}: "
          f"{n_tiles} tiles), float32, card against CPU: decode max abs err {e_dec:.3e}, encode "
          f"{e_enc:.3e} (limit 1e-4); card {s_card:.1f} s, CPU {s_cpu:.1f} s")
    check(n_tiles > 1, "the tiled VAE ran one tile")
    check(dec_card.shape == (1, TILED_VAE_SIZE, TILED_VAE_SIZE, 3) and
          enc_card.shape == (1, hw, hw, 4), "tiled VAE shapes")
    check(e_dec <= 1e-4, "tiled VAE decode disagrees with the CPU")
    check(e_enc <= 1e-4, "tiled VAE encode disagrees with the CPU")


def kernel_launches():
    """The launch counts of K1 and the three K2 kernels."""
    from rgie_tpu_torch.ops.kernels import flash_attention as FA
    from rgie_tpu_torch.ops.kernels import pointwise_chain as PC

    return PC.LAUNCHES, FA.LAUNCHES_FWD, FA.LAUNCHES_BWD_DKV, FA.LAUNCHES_BWD_DQ


def reset_kernel_launches():
    from rgie_tpu_torch.ops.kernels import flash_attention as FA
    from rgie_tpu_torch.ops.kernels import pointwise_chain as PC

    PC.LAUNCHES = FA.LAUNCHES_FWD = FA.LAUNCHES_BWD_DKV = FA.LAUNCHES_BWD_DQ = 0


def print_row(what, row, seconds, card):
    d = row["detail"]
    print(f"{what}: {d['batch']} images {d['steps']} steps in {d['edit_seconds']:.3f} s = "
          f"{d['per_step_ms_batched']:.2f} ms/step, {row['value']:.4f} img/s, "
          f"{d['achieved_tflops']:.2f} TFLOP/s ({d['step_tflop']:.3f} TFLOP a step as "
          f"FlopCounterMode counts it), MFU {d['mfu_pct']:.2f} % of the {d['dtype']} peak, "
          f"peak memory {d['peak_memory_gib']:.2f} GiB, phase {seconds:.1f} s, on {card}")
    print(json.dumps(row))


def check_edit(result, edited, lo, hi, what):
    check(bool(torch.isfinite(result.losses).all()), f"{what}: non-finite loss")
    check(bool((result.best_loss <= result.first_loss).all()), f"{what}: best_loss > first_loss")
    check(bool(torch.isfinite(edited).all()), f"{what}: non-finite edited image")
    check(float(edited.min()) >= lo and float(edited.max()) <= hi,
          f"{what}: edited images outside [{lo}, {hi}]")
    check(result.best_x.dtype == torch.float32, f"{what}: optimized vector not float32")


def parametric_terms(models, cfg, weights, images, alphas, x):
    """{term: (value, gradient)} of the parametric objective at ``x`` for
    each (weight_clf, weight_recon) of ``weights``, one image."""
    import dataclasses

    from rgie_tpu_torch.engine import parametric as P

    out = {}
    for term, (weight_clf, weight_recon) in weights.items():
        c = dataclasses.replace(cfg, weight_clf=weight_clf, weight_recon=weight_recon)
        ctx = P.make_context(models, c, images, alphas)
        v = x.detach().clone().requires_grad_(True)
        loss = P.make_objective(models, c)(v, ctx)
        loss.sum().backward()
        out[term] = (float(loss[0].detach()), v.grad[0].double().cpu())
    return out


def bench_phase(device, card):
    """Phase 11: cli/bench.py's workload in bfloat16, and its objective
    against the float32 models'."""
    from rgie_tpu_torch.cli import bench
    from rgie_tpu_torch.ops import chain as CH

    t0 = time.perf_counter()
    models, cfg, images, alphas = bench.build(BENCH_BATCH, torch.bfloat16, False, device)
    reset_kernel_launches()
    row, result, edited = bench.run(models, cfg, images, alphas, runs=1)
    torch.cuda.synchronize()
    launches = kernel_launches()
    check(launches == (0, 0, 0, 0), f"the bench's edit launched K1/K2: {launches}")
    check(result.losses.shape == (BENCH_BATCH, bench.NUM_STEPS), "bench: loss trajectory shape")
    check_edit(result, edited, 0.0, 1.0, "bench")
    check(next(models.va_loss.regressor.net.parameters()).dtype == torch.bfloat16,
          "bench: the regressor is not bfloat16")

    models32, _, images32, _ = bench.build(1, torch.float32, False, device)
    check(bool((images32[0] == images[0]).all()), "bench: the float32 build drew other images")
    identity = CH.pack_params(CH.init_params(device=device))[None]
    away = identity + (torch.rand(identity.shape, generator=torch.Generator().manual_seed(1))
                       * 2 - 1).to(device) * AWAY
    weights = {"VA": (1.0, 0.0), "CLIP": (0.0, 1.0),
               "objective": (cfg.weight_clf, cfg.weight_recon)}
    for where, x in (("away from the identity", away), ("its last vector", result.last_x[:1])):
        terms = {name: parametric_terms(m, cfg, weights, images[:1], alphas[:1], x)
                 for name, m in (("bfloat16", models), ("float32", models32))}
        for term in weights:
            (v16, g16), (v32, g32) = terms["bfloat16"][term], terms["float32"][term]
            dist = float((g16 - g32).norm() / g32.norm())
            print(f"bench {term} of image 0 at {where}: bfloat16 {v16:.6f}, float32 {v32:.6f}, "
                  f"difference {abs(v16 - v32):.3e} ({abs(v16 - v32) / abs(v32):.3e} of it); "
                  f"gradient {dist:.3e} of the float32 gradient's norm "
                  f"({float(g32.norm()):.3e}) away from it")
            check(bool(torch.isfinite(g16).all()), f"bench: non-finite bfloat16 {term} gradient")
        if x is away:
            va_tol = BF16_VA_RTOL * abs(terms["float32"]["VA"][0])
            tolerance = {"VA": va_tol, "CLIP": BF16_CLIP_ATOL,
                         "objective": cfg.weight_clf * va_tol + cfg.weight_recon * BF16_CLIP_ATOL}
            for term, tol in tolerance.items():
                (v16, g16), (v32, g32) = terms["bfloat16"][term], terms["float32"][term]
                check(abs(v32) > 4 * tol, f"bench: the float32 {term} is within 4 tolerances of 0")
                check(abs(v16 - v32) <= tol, f"bench: the bfloat16 {term} is too far from float32")
                check(float((g16 - g32).norm() / g32.norm()) <= BF16_GRAD_DIST,
                      f"bench: the bfloat16 {term} gradient is too far from float32")
        else:
            v16, v32 = terms["bfloat16"]["objective"][0], terms["float32"]["objective"][0]
            check(abs(v16 - v32) <= BF16_LAST_RTOL * abs(v32),
                  "bench: the bfloat16 objective at the last vector is too far from float32")
    print_row("bench (256 px parametric edit, bfloat16)", row, time.perf_counter() - t0, card)


def gan_phase(device, card):
    """Phase 12: the MUNIT edit at full width in bfloat16, through
    cli/bench_gan.py."""
    from rgie_tpu_torch.cli import bench_gan

    t0 = time.perf_counter()
    models, cfg, images, alphas = bench_gan.build(GAN_BATCH, torch.bfloat16, False, NUM_STEPS,
                                                  GAN_SIZE, device)
    build_s = time.perf_counter() - t0
    reset_kernel_launches()
    row, result, edited = bench_gan.run(models, cfg, images, alphas, runs=1)
    torch.cuda.synchronize()
    launches = kernel_launches()
    check(launches == (0, 0, 0, 0), f"the GAN edit launched K1/K2: {launches}")
    check(result.losses.shape == (GAN_BATCH, NUM_STEPS), "GAN edit: loss trajectory shape")
    check(result.best_x.shape == (GAN_BATCH, 8), "GAN edit: style shape")
    check(edited.shape == images.shape, "GAN edit: edited shape")
    check_edit(result, edited, -1.0, 1.0, "GAN edit")
    print(f"GAN edit: models built in {build_s:.1f} s; losses (image 0, every 10th step): "
          + " ".join(f"{v:.5f}" for v in result.losses[0, ::10].tolist())
          + f"; best {result.best_loss.tolist()} at steps {result.best_step.tolist()}")
    print_row("GAN edit (MUNIT 1024 px, bfloat16)", row, time.perf_counter() - t0, card)


def gan_card_against_cpu_phase(device, rng):
    """Phase 13: the full-width GAN objective in float32 on the card and on
    the CPU, the discriminator term on."""
    from rgie_tpu_torch.config import GanEditConfig, MunitGenConfig, OptimizeConfig
    from rgie_tpu_torch.engine import gan as GE
    from rgie_tpu_torch.losses.emotion_loss import ValenceArousalLoss
    from rgie_tpu_torch.models.discriminators import MultiResPatchDiscriminator
    from rgie_tpu_torch.models.emotion import create_regressor
    from rgie_tpu_torch.models.init import freeze_, random_init_
    from rgie_tpu_torch.models.munit import create_generator

    t0 = time.perf_counter()
    g = torch.Generator().manual_seed(0)
    models = GE.GanEditModels(
        generator=create_generator(g, MunitGenConfig()).autoencoder_a,
        va_loss=ValenceArousalLoss(create_regressor(g, normalize=False)),
        dis=freeze_(random_init_(MultiResPatchDiscriminator(), g)))
    cfg = GanEditConfig(optimize=OptimizeConfig(num_steps=1), input_size=GAN_CPU_SIZE,
                        crop_size=GAN_CPU_SIZE, weight_dis=0.1)
    images = torch.from_numpy(rng.uniform(-1, 1, (2, GAN_CPU_SIZE, GAN_CPU_SIZE, 3))
                              .astype(np.float32))
    alphas = torch.tensor([[0.1, 0.1], [-0.1, 0.2]])
    grads = {}
    reset_kernel_launches()
    for dtype in (torch.float32, torch.float64):
        out = []
        for dev in (torch.device("cpu"), device):   # the CPU first: .to() moves the modules
            m = GE.GanEditModels(*(x.to(dev, dtype) for x in models))
            ctx, style0 = GE.make_context(m, images.to(dev, dtype), alphas.to(dev, dtype))
            style = (style0 + 0.3).requires_grad_(True)
            loss = GE.make_objective(m, cfg)(style, ctx)
            loss.sum().backward()
            with torch.no_grad():
                decoded = m.generator.decode(ctx.content, style0 + 0.3)
            out.append({"content": ctx.content, "style": style0, "decode": decoded,
                        "objective": loss.detach(), "style gradient": style.grad})
        cpu, card = out
        grads[dtype] = card["style gradient"].cpu()
        errs = {k: float((card[k].cpu().double() - cpu[k].double()).abs().max()
                         / cpu[k].double().abs().max()) for k in cpu}
        print(f"GAN card against CPU, {str(dtype)[6:]} at {GAN_CPU_SIZE} px (max abs error "
              "relative to the largest entry): " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + f"; objective {card['objective'].tolist()}; "
              f"{time.perf_counter() - t0:.1f} s into the phase")
        for k, v in errs.items():
            tol = GAN_GRAD32_RTOL if (k, dtype) == ("style gradient", torch.float32) else GAN_CPU_RTOL
            check(v <= tol, f"GAN card against CPU: {k} disagrees in {dtype}")
    launches = kernel_launches()
    check(launches == (0, 0, 0, 0), f"the GAN objective launched K1/K2: {launches}")
    print("GAN style gradient on the card, float32 against float64: "
          f"{rel_err(grads[torch.float32], grads[torch.float64]):.2e} of the largest entry")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    sys.path.insert(0, REPO)
    from rgie_tpu_torch.cli import optimize_image_param as cli
    from rgie_tpu_torch.cli.kernel_variants import graph_ms
    from rgie_tpu_torch.device import resolve_device
    from rgie_tpu_torch.ops import chain as CH
    from rgie_tpu_torch.ops.kernels import build
    from rgie_tpu_torch.ops.kernels import flash_attention as FA
    from rgie_tpu_torch.ops.kernels import pointwise_chain as PC

    # ---- 1. device
    t_start = time.perf_counter()
    device = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")

    # ---- 2. kernels against their plain versions: the batch of 4 at the
    # output size, the re-render's own one-image call, and a ragged shape
    t0 = time.perf_counter()
    sources = FA.KERNEL_SOURCES + (PC.KERNEL_SOURCE,)
    build.build_libraries(sources)
    print(f"{len(sources)} CUDA sources ({', '.join(sources)}) built with nvcc for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    errors, times, device_times = [], {}, {}
    timed_shape = (NUM_IMAGES, OUTPUT_SIZE, OUTPUT_SIZE, 3)
    for shape in [timed_shape, (1, OUTPUT_SIZE, OUTPUT_SIZE, 3), (1, 1000, 760, 3)]:
        img = torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32)).to(device)
        params = draw_params(rng, device)
        got = PC.pointwise_chain(img, params)
        expect = PC.reference_pointwise_chain(img, params)
        torch.cuda.synchronize()
        err = float((got - expect).abs().max())
        print(f"pointwise_chain {shape}: max abs err {err:.3e} (tolerance {TOLERANCE:g})")
        check(err <= TOLERANCE, f"pointwise_chain disagrees with its plain version at {shape}")
        errors.append(err)
        if shape[1] == OUTPUT_SIZE:
            times[shape] = time_group([lambda: PC.pointwise_chain(img, params),
                                       lambda: PC.reference_pointwise_chain(img, params)])
            device_times[shape] = graph_ms(lambda: PC.pointwise_chain(img, params))
            print(f"pointwise_chain {shape}: kernel {times[shape][0]:.4f} ms a call, plain "
                  f"{times[shape][1]:.4f} ms (median of 20, CUDA events around the call); "
                  f"kernel on the device alone {device_times[shape]:.4f} ms (CUDA graph "
                  f"replay) on {card}")
    kernel_ms, plain_ms = times[timed_shape]
    one_image = (1, OUTPUT_SIZE, OUTPUT_SIZE, 3)
    # K1 reads the image once and writes it once; its arithmetic is far below
    # the float32 rate, so the memory rate bounds it.
    k1_bound_ms, k1_bound_by = bound(60.0 * np.prod(timed_shape), 2 * 4 * np.prod(timed_shape),
                                     torch.float32)
    print(f"pointwise_chain {timed_shape}: bound {k1_bound_ms:.4f} ms by {k1_bound_by}")
    k2_entries = flash_attention_phase(device, card)
    print(f"kernel phase: build, checks and timing {time.perf_counter() - t0:.1f} s")

    # ---- 3. the main path, through the CLI's per-batch function
    args = cli.build_parser().parse_args([
        "--num-steps", str(NUM_STEPS), "--learning-rate", "0.05", "--weight-clf", "0.15",
        "--weight-recon", "1.0", "--batch", str(NUM_IMAGES), "--output-size", str(OUTPUT_SIZE),
        "--adaptations", f"smoke:{ALPHA}", "--va-model", os.path.join(REPO, "build", "no_va_model"),
        "--device", "cuda", "--seed", "0"])
    models = cli.build_models(args, torch.Generator().manual_seed(args.seed), device)
    cfg = cli.make_config(args)
    images = torch.from_numpy(rng.uniform(0, 1, (NUM_IMAGES, EDIT_SIZE, EDIT_SIZE, 3))
                              .astype(np.float32)).to(device)
    full = torch.from_numpy(rng.uniform(0, 1, (NUM_IMAGES, OUTPUT_SIZE, OUTPUT_SIZE, 3))
                            .astype(np.float32)).to(device)
    alpha = cli.parse_adaptations(args.adaptations)[0][1]

    # Warm-up: cuDNN and the allocator spend seconds on the first steps; a
    # 2-step edit of the same batch (no re-render) keeps that out of the
    # per-step figure of the main path below.
    cli.edit_batch(models, cli.make_config(cli.build_parser().parse_args(
        ["--num-steps", "2", "--device", "cuda"])), images, alpha)

    torch.cuda.reset_peak_memory_stats()
    PC.LAUNCHES = 0
    out = cli.edit_batch(models, cfg, images, alpha, full)
    torch.cuda.synchronize()
    launches = PC.LAUNCHES
    peak = torch.cuda.max_memory_allocated()

    res = out.result
    check(launches >= NUM_IMAGES, f"pointwise_chain launched {launches} times in the main path")
    check(res.losses.shape == (NUM_IMAGES, NUM_STEPS), "loss trajectory shape")
    check(bool(torch.isfinite(res.losses).all()), "non-finite loss")
    check(bool((res.best_loss <= res.first_loss).all()), "best_loss > first_loss")
    check(out.outputs.shape == (NUM_IMAGES, OUTPUT_SIZE, OUTPUT_SIZE, 3), "output shape")
    check(bool(torch.isfinite(out.outputs).all()), "non-finite output")
    check(float(out.outputs.min()) >= 0.0 and float(out.outputs.max()) <= 1.0, "outputs outside [0, 1]")
    check(all(bool(torch.isfinite(v).all()) for v in out.metrics.values()), "non-finite metric")

    # Against the CPU: the objective of image 0 at its last vector (away from
    # the identity, where the loss does not depend on the models), and the
    # re-render of image 0 through the plain chain.
    alpha0 = torch.tensor([alpha], dtype=torch.float32)
    probe = res.last_x[:1]
    with torch.no_grad():
        ctx = cli.P.make_context(models, cfg, images[:1], alpha0.to(device))
        loss_card = float(cli.P.make_objective(models, cfg)(probe, ctx)[0])
    cpu = torch.device("cpu")
    models_cpu = cli.P.EditModels(va_loss=models.va_loss.to(cpu), clip=models.clip.to(cpu))
    with torch.no_grad():
        ctx = cli.P.make_context(models_cpu, cfg, images[:1].cpu(), alpha0)
        loss_cpu = float(cli.P.make_objective(models_cpu, cfg)(probe.cpu(), ctx)[0])
        render_cpu = CH.edit_image(full[:1].cpu(), res.best_x[:1].cpu(), input_size=cfg.crop_size)
    render_err = float((out.outputs[:1].cpu() - render_cpu).abs().max())
    print(f"objective of image 0 at its last vector: card {loss_card:.7f}, CPU {loss_cpu:.7f}; "
          f"re-render vs CPU plain chain: max abs err {render_err:.3e}")
    check(abs(loss_card - loss_cpu) <= 1e-3 * abs(loss_cpu) + 1e-6, "objective disagrees with the CPU")
    check(render_err <= 1e-4, "re-render disagrees with the CPU plain chain")

    step_ms = out.edit_seconds / NUM_STEPS * 1e3
    print(f"main path: {NUM_IMAGES} images {EDIT_SIZE} px, {NUM_STEPS} Adam steps in "
          f"{out.edit_seconds:.3f} s = {step_ms:.2f} ms/step, {NUM_IMAGES / out.edit_seconds:.4f} img/s "
          f"(after a 2-step warm-up edit), peak memory {peak / 2**30:.2f} GiB, on {card}")
    print("losses (image 0, every 10th step): "
          + " ".join(f"{v:.5f}" for v in res.losses[0, ::10].tolist())
          + f"; best {res.best_loss.tolist()} at steps {res.best_step.tolist()}")

    # ---- 4-6. the float32 diffusion edit, its modules against the CPU, and
    # the attention modules' two routes
    del models, models_cpu, out, res, images, full, ctx
    torch.cuda.empty_cache()
    from PIL import Image

    work = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    image_path = os.path.join(work, "random_1024.jpg")
    Image.fromarray((rng.uniform(0, 1, (DIFFUSION_SIZE, DIFFUSION_SIZE, 3)) * 255)
                    .astype(np.uint8)).save(image_path)
    edit_args, stack = diffusion_models(device, image_path, "float32", FLOAT32_STEPS)
    counts_f32, latents_f32 = diffusion_path_phase(edit_args, stack, image_path, FLOAT32_STEPS, card)
    card_against_cpu_phase(stack, rng)
    module_route_phase(stack, rng)
    del stack
    torch.cuda.empty_cache()

    # ---- 7 (and 6 again). the bfloat16 diffusion edit: the CLI's default type
    edit_args, stack = diffusion_models(device, image_path, None, DIFFUSION_STEPS)
    check(next(stack.pipe.unet.parameters()).dtype == torch.bfloat16,
          "the diffusion CLI's default type at --scale sd is not bfloat16")
    module_route_phase(stack, rng)
    _, latents_short = diffusion_path_phase(edit_args, stack, image_path, FLOAT32_STEPS, card)
    distance = float((latents_short - latents_f32).abs().max())
    print(f"bfloat16 edit against float32 edit, both {FLOAT32_STEPS} steps from seed 0: output "
          f"latents differ by at most {distance:.4f}, mean {float((latents_short - latents_f32).abs().mean()):.4f} "
          f"(float32 latents: largest entry {float(latents_f32.abs().max()):.4f}, mean magnitude "
          f"{float(latents_f32.abs().mean()):.4f}); recorded, not checked")
    counts_bf16, _ = diffusion_path_phase(edit_args, stack, image_path, DIFFUSION_STEPS, card)
    del stack
    torch.cuda.empty_cache()

    # ---- 8-10. the SDXL edit, its UNet against the CPU, the tiled VAE
    stack, counts_sdxl = sdxl_path_phase(device, image_path, card)
    sdxl_card_against_cpu_phase(stack, rng)
    tiled_vae_phase(stack, rng)
    del stack
    torch.cuda.empty_cache()

    # ---- 11-13. the bench's bfloat16 workload, the GAN edit, its check
    # against the CPU
    bench_phase(device, card)
    torch.cuda.empty_cache()
    gan_phase(device, card)
    torch.cuda.empty_cache()
    gan_card_against_cpu_phase(device, rng)
    for entry, a, b, c in zip(k2_entries, counts_f32, counts_bf16, counts_sdxl):
        entry["launches"] = a + b + c
    k2_entries[0]["sdxl_launches"] = counts_sdxl[0]
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": [{
        "name": "pointwise_chain", "route": "cuda",
        "source": "rgie_tpu_torch/csrc/pointwise_chain.cu",
        "replaces": "rgie_tpu/ops/pallas/pointwise_chain.py:38",
        "replaces_function": "_prefix_kernel",
        "launches": launches, "max_abs_err": max(errors), "timed_shape": list(timed_shape),
        "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "device_ms": device_times[timed_shape], "one_image_ms": times[one_image][0],
        "one_image_plain_ms": times[one_image][1], "one_image_device_ms": device_times[one_image],
        "bound_ms": k1_bound_ms, "bound_by": k1_bound_by, "library_ms": None,
    }] + k2_entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
