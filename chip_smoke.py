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
   types. The shapes a batch of 2 adds, (4, 5, 16384, 64) and
   (2, 1, 16384, 512), forward only, in bfloat16: checked and timed beside
   the plain version, ``sdpa`` and the bound.
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
   and ``adapt_batches`` at ``--batch 1`` on one random 1024 px image at
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
   ``adapt_batches`` on the 1024 px image with ``--scheduler dpm`` (karras
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
14. The batched edit's rows, in float32 with TF32 off on phase 4's stack (run
   after phase 6): a batch of ``BATCH`` random 1024 px images with their
   conds from the CLI's ``batch_conds``, ``BATCH_CHECK_STEPS`` DDIM steps and
   ``BATCH_CHECK_INNER`` null-text inner steps, each row against the
   single-image edit of its image (the pipeline's single-image functions), and
   ``make_segmented_edit`` with windows of 1 step against the whole batched
   edit: images, scores and null-text embeddings within ``BATCH_RTOL`` of the
   largest entry.
15. Midu training through its CLI (``cli/train_guidance_clf.py``) at
   ``--scale sd`` (SD-2.1 width, 512 px, bfloat16 frozen models, random
   weights and images from the seed) for 2 steps at batch 8 and one
   validation batch; then the best checkpoint is read into phase 7's stack
   by ``--midu-ckpt``'s loader (``strict=True``) and held equal to it.
16. The batched edit through the diffusion CLI's ``adapt_batches`` at
   ``--batch BATCH`` on a feed of random 1024 px JPEGs, on phase 7's stack
   (bfloat16, the trained midu) at ``BATCH_STEPS`` DDIM steps. Checks: the
   K2 launch counts equal ``expected_flash_launches`` with each step's most
   inner steps (the batch rides in each launch); the batch's K2 shapes
   launched (printed); images, scores, null-text embeddings (float32) and
   guidance norms per image. Seconds per image, img/s and peak memory are
   printed beside phase 7's single edit at the same steps.
17. ControlNet at SD-2.1 width on phase 7's bfloat16 UNet (zero convolutions
   drawn away from zero), 1024 px, batch 2: forward and backward of
   ``controlled_unet_apply`` to the latents and the control image; K2 launches
   equal the derived count (the UNet's 5 top-level sites and the ControlNet's
   copies of its top down block, each with a backward); kernel route against
   plain route (the modules' flash attention swapped for its plain version):
   ``CN_OUT_TOL`` / ``CN_GRAD_TOL`` of the largest entry. Then float32 copies on
   the card against the CPU at ``CN_CPU_SIZE`` px: 1e-3.
18. Midu training at SDXL width on phase 8's stack (run after phase 10): the
   training CLI's ``features_and_labels`` and train step, ``MIDU_STEPS`` steps
   at batch ``MIDU_BATCH``, 1024 px; K2-fwd ``wide`` once per VAE encode and no
   other launch. One float32 step on the card against the CPU from the same
   weights on the same features and labels.
19. Each path is driven with the launch counts set to 0 just before it and
   read just after. One JSON line ``{"kernels": [...]}`` (the K2 entries'
   times are bfloat16's, the type the full-width path runs by default, with
   float32's beside them under ``float32_*`` and the shapes a batch of 2
   adds under ``batch_shapes``; their launches the sum over the paths, by
   path under ``launches_by_path``; the GAN path and the bench launch
   none), then the card, then the last line ``{"ok": true, "device":
   {...}}``.

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

# The batched edit: phase 16's batch and DDIM steps, and phase 14's float32
# check of each row against its image's single edit (as few steps as still
# run null-text optimization and guidance, 2 inner steps each). A batch of 2
# may take other cuDNN algorithms than a batch of 1, and a segmented run of a
# backward need not repeat it bit for bit: rows and windows are held to 1e-3
# of the largest entry (a tenth of phase 5's single steps' limit would be
# 1e-4; two outer steps of normalized Adam and normalized guidance carry a
# rounding on at its own relative size).
BATCH, BATCH_STEPS, BATCH_CHECK_STEPS, BATCH_CHECK_INNER, BATCH_RTOL = 2, 6, 2, 2, 1e-3
# The K2 shapes a batch of 2 adds: the CFG pair of two images, and two images
# through the VAE's mid block (phase 16; also phase 18's VAE encode).
BATCH_K2_SHAPES = [(4, 5, 16384, 64), (2, 1, 16384, 512)]
# ControlNet (phase 17): the controlled UNet's kernel route against its plain
# route in bfloat16, through 7 attention sites in two networks: 2^-5 of the
# largest entry on eps and the mid features, 5e-2 on the gradients (the limits
# of the JAX package's check_flash_attn.py); card against CPU in float32 1e-3.
CN_OUT_TOL, CN_GRAD_TOL, CN_CPU_SIZE = 2.0 ** -5, 5e-2, 256
# Midu training (phases 15 and 18): SDXL steps at batch 2 on phase 8's stack;
# one float32 step on the card against the CPU: the loss, the predictions and
# the gradients 1e-4 relative (to the largest entry), the updates within a
# hundredth of lr where the gradient (+ the L2 term) is above MIDU_SETTLED of
# its largest entry. Adam's first step is lr * g / (|g| + eps), a full step
# of either sign: an entry whose gradient is at the level of its rounding
# (1.9e-6 of the largest entry on an NVIDIA H100 at 700 W) may step the
# other way on the other device (5186 of 7.48 M entries 2 lr apart there).
MIDU_STEPS, MIDU_BATCH, MIDU_RTOL, MIDU_SETTLED = 3, 2, 1e-4, 1e-3

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

    # The shapes a batch of 2 adds (phases 16 and 18), forward only there: the
    # CFG pair of two images and two images through the VAE's mid block.
    batch_rows = []
    for shape in BATCH_K2_SHAPES:
        q, k, v, _ = make(shape, torch.bfloat16, 13)
        scale = 1.0 / shape[3] ** 0.5
        o, lse = FA.flash_attention_with_lse(q, k, v, scale)
        o_ref, lse_ref = FA.reference_flash_attention(q, k, v, scale)
        e_out = float((o.float() - o_ref.float()).abs().max() / o_ref.float().abs().max())
        e_lse = float((lse - lse_ref).abs().max())
        tol = K2_TOLERANCE[torch.bfloat16]
        check(e_out <= tol["out"] and e_lse <= tol["lse"],
              f"flash attention forward disagrees with its plain version at {shape} bfloat16")
        qs, ks, vs = (FA._strided(t) for t in (q, k, v))
        fwd = time_group([lambda: FA._launch_fwd(qs, ks, vs, scale),
                          lambda: FA.reference_flash_attention(q, k, v, scale),
                          lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)], 1, 5)
        b, h, n, d = shape
        fwd_bound = bound(4.0 * b * h * n * n * d, 4 * b * h * n * d * 2 + b * h * n * 4,
                          torch.bfloat16)
        route = FA.kernel_route("fwd", torch.bfloat16, d)
        print(f"flash attention {shape} bfloat16 forward ({route}) ms (median of 5, CUDA events) "
              f"on {card}: kernel {fwd[0]:.3f} plain {fwd[1]:.3f} library sdpa {fwd[2]:.3f} "
              f"bound {fwd_bound[0]:.3f} ({fwd_bound[1]}); out {e_out:.3e}, lse {e_lse:.3e}")
        batch_rows.append(dict(shape=list(shape), dtype="bfloat16", route=route, ms=fwd[0],
                               plain_ms=fwd[1], library_ms=fwd[2], bound_ms=fwd_bound[0],
                               bound_by=fwd_bound[1], max_abs_err=max(e_out, e_lse)))
        del q, k, v, o, lse, o_ref, lse_ref, qs, ks, vs
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
    entries[0]["batch_shapes"] = batch_rows
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


def edit_one_image(args, stack, gcfg, acfg, image_path):
    """The diffusion CLI's ``adapt_batches`` on one image (``--batch 1``):
    returns (the output label, the edited image (1, H, W, 3) and the run's
    ``RunLog``)."""
    from rgie_tpu_torch.cli import adapt_images as cli

    item = (os.path.basename(image_path), image_path, "a random image")
    (_, out, log, _), = cli.adapt_batches(args, stack, cli.make_adapter(stack), [item], gcfg,
                                          acfg, args.out_dir)
    return gcfg.resolved_label(), out.edited, log


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
    gcfg, acfg = cli.make_configs(args)
    dtype = next(stack.pipe.unet.parameters()).dtype

    torch.cuda.reset_peak_memory_stats()
    FA.LAUNCHES_FWD = FA.LAUNCHES_BWD_DKV = FA.LAUNCHES_BWD_DQ = 0
    t0 = time.perf_counter()
    label, image, log = edit_one_image(args, stack, gcfg, acfg, image_path)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = (FA.LAUNCHES_FWD, FA.LAUNCHES_BWD_DKV, FA.LAUNCHES_BWD_DQ)
    peak = torch.cuda.max_memory_allocated()

    print(f"diffusion edit {dtype}: {steps} DDIM steps (the CLI's default is 50; nothing else "
          f"is cut), null-text inner steps per outer step {log.nto_inner_steps}")
    want_fwd, want_bwd = expected_flash_launches(steps, log.nto_inner_steps)
    print(f"  launches counted: forward {counts[0]}, dK/dV {counts[1]}, dQ {counts[2]}; "
          f"expected {want_fwd}, {want_bwd}, {want_bwd}")
    check(counts == (want_fwd, want_bwd, want_bwd), "K2 launch counts differ from the derivation")
    check(min(counts) > 0, "a flash attention kernel was not launched in the diffusion edit")

    check(image.shape == (1, DIFFUSION_SIZE, DIFFUSION_SIZE, 3), "edited image shape")
    check(bool(torch.isfinite(image).all()), "non-finite edited image")
    check(float(image.min()) >= 0.0 and float(image.max()) <= 1.0, "edited image outside [0, 1]")
    for name in ("latents", "noisy", "nto_embeds", "out_latents"):
        check(bool(torch.isfinite(log.tensors[name]).all()), f"non-finite {name}")
    check(log.tensors["nto_embeds"].shape == (steps, 1, 77, 1024), "null-text embeddings")
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
    return counts, log.tensors["out_latents"].detach().float().cpu(), seconds, peak


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
    ``build_models`` and ``adapt_batches``. Returns (the stack, the launch
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
    gcfg, acfg = cli.make_configs(args, is_xl=True)

    torch.cuda.reset_peak_memory_stats()
    FA.LAUNCHES_FWD = FA.LAUNCHES_BWD_DKV = FA.LAUNCHES_BWD_DQ = 0
    t0 = time.perf_counter()
    label, image, log = edit_one_image(args, stack, gcfg, acfg, image_path)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = (FA.LAUNCHES_FWD, FA.LAUNCHES_BWD_DKV, FA.LAUNCHES_BWD_DQ)
    peak = torch.cuda.max_memory_allocated()

    print(f"SDXL edit {dtype}: {SDXL_STEPS} DPM steps (the CLI's default is 50; nothing else is "
          f"cut), null-text inner steps per outer step {log.nto_inner_steps}")
    want = expected_sdxl_flash_launches()
    print(f"  launches counted: forward {counts[0]}, dK/dV {counts[1]}, dQ {counts[2]}; expected "
          f"{want}, 0, 0; forward route at the VAE's head: "
          f"{FA.kernel_route('fwd', dtype, pipe.vae.cfg.block_out_channels[-1])}")
    check(counts == (want, 0, 0), "SDXL K2 launch counts differ from the derivation")
    check(FA.kernel_route("fwd", dtype, pipe.vae.cfg.block_out_channels[-1]) == "wide",
          "the SDXL VAE's attention is not on the wide route")

    check(image.shape == (1, DIFFUSION_SIZE, DIFFUSION_SIZE, 3), "SDXL edited image shape")
    check(bool(torch.isfinite(image).all()), "non-finite SDXL edited image")
    check(float(image.min()) >= 0.0 and float(image.max()) <= 1.0,
          "SDXL edited image outside [0, 1]")
    for name in ("latents", "noisy", "nto_embeds", "out_latents"):
        check(bool(torch.isfinite(log.tensors[name]).all()), f"non-finite SDXL {name}")
    ucfg = pipe.unet.cfg
    check(log.tensors["nto_embeds"].shape == (SDXL_STEPS, 1, 77, ucfg.cross_attention_dim),
          "SDXL null-text embeddings")
    added = cli.make_adapter(stack).added_cond_fn("a random image", "")
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


def single_image_edit(pipe, image, empty, cfg_embeds, cond_embeds, alpha, num_inner_steps):
    """One image's edit through the pipeline's single-image functions, as
    ``ImageAdapter.revert_and_sample`` runs them. Returns (image, adapted
    score, null-text embeddings)."""
    from rgie_tpu_torch.models.midu import ValenceArousalMidu

    t_last = int(pipe.sched.timesteps[-1])
    clf = ValenceArousalMidu(model=pipe.midu_model)

    def score(img):
        with torch.no_grad():
            _, mid = pipe._unet(pipe.encode_image(img), t_last, empty, None)
            return clf.predict(mid)

    reference = torch.clamp(score(image) + alpha, 0.0, 1.0)
    noisy, pivots = pipe.reverse_sample(pipe.encode_image(image), empty)
    nto = pipe.null_optimization(pivots, cond_embeds, empty, CFG_SCALE,
                                 num_inner_steps=num_inner_steps)
    lat = pipe.sample(noisy, cfg_embeds, guidance_scale=CFG_SCALE, guidance_clf_scale=CLF_SCALE,
                      uncond_embeds_per_step=nto, midu_reference_value=reference)
    edited = pipe.decode_latents(lat)
    return edited, score(edited), nto


def batched_equality_phase(args, stack, rng, card):
    """Phase 14: float32 with TF32 off, the SD-2.1 stack of phase 4 at
    ``BATCH_CHECK_STEPS`` steps: each row of a batched edit of ``BATCH`` 1024
    px images against the single-image edit of its image, and ``--segment 1``
    against the whole batched edit."""
    import dataclasses

    from rgie_tpu_torch.cli import adapt_images as cli
    from rgie_tpu_torch.diffusion import schedulers as SCH
    from rgie_tpu_torch.diffusion.batched import make_batched_edit
    from rgie_tpu_torch.diffusion.pipeline import RunLog
    from rgie_tpu_torch.diffusion.segmented import make_segmented_edit

    t0 = time.perf_counter()
    pipe = dataclasses.replace(stack.pipe, sched=SCH.make_schedule(BATCH_CHECK_STEPS))
    adapter = cli.make_adapter(stack._replace(pipe=pipe))
    gcfg, _ = cli.make_configs(args)
    conds = cli.batch_conds(adapter, gcfg, [f"a random image {b}" for b in range(BATCH)])
    empty = adapter.embeds_fn("", "")
    images = torch.from_numpy(rng.uniform(0, 1, (BATCH, DIFFUSION_SIZE, DIFFUSION_SIZE, 3))
                              .astype(np.float32)).to(pipe.device)
    alphas = torch.full((BATCH, 2), REFERENCE_VALUE, device=pipe.device)
    kw = dict(guidance_scale=CFG_SCALE, guidance_clf_scale=CLF_SCALE, use_nto=True,
              use_reference=True, num_inner_steps=BATCH_CHECK_INNER)
    log = RunLog()
    whole = make_batched_edit(pipe, **kw)(images, empty, conds, alphas, log=log)
    seg = make_segmented_edit(pipe, chunk_steps=1, **kw)(images, empty, conds, alphas)
    errors = {"segmented image": rel_err(seg.edited, whole.edited),
              "segmented score": rel_err(seg.adapted_score, whole.adapted_score)}
    for b in range(BATCH):
        edited, adapted, nto = single_image_edit(pipe, images[b:b + 1], empty,
                                                 conds.cfg_embeds[b], conds.cond_embeds[b],
                                                 alphas[b:b + 1], BATCH_CHECK_INNER)
        errors[f"row {b} image"] = rel_err(whole.edited[b:b + 1], edited)
        errors[f"row {b} score"] = rel_err(whole.adapted_score[b:b + 1], adapted)
        errors[f"row {b} null-text embeddings"] = rel_err(log.tensors["nto_embeds"][:, b], nto)
    print(f"batched edit, float32, {BATCH} images, {BATCH_CHECK_STEPS} DDIM steps, "
          f"{BATCH_CHECK_INNER} inner steps (per image {log.nto_image_steps}), each row against "
          f"its single-image edit and --segment 1 against the whole edit (of the largest entry; "
          f"limit {BATCH_RTOL:g}): " + ", ".join(f"{k} {v:.3e}" for k, v in errors.items())
          + f"; {time.perf_counter() - t0:.1f} s on {card}")
    for what, err in errors.items():
        check(err <= BATCH_RTOL, f"batched edit: {what} disagrees")
    check(whole.edited.shape == (BATCH, DIFFUSION_SIZE, DIFFUSION_SIZE, 3), "batched edit shape")


def training_cli_phase(work, card):
    """Phase 15: the midu training CLI at --scale sd (SD-2.1 width, 512 px,
    bfloat16 frozen models, random weights and images from the seed) for 2
    steps at batch 8 and one validation batch. Returns the best checkpoint's
    path."""
    from rgie_tpu_torch.cli import train_guidance_clf

    out = os.path.join(work, "midu_sd")
    reset_kernel_launches()
    t0 = time.perf_counter()
    train_guidance_clf.main(["--scale", "sd", "--epochs", "1", "--num-batches", "2",
                             "--val-batches", "1", "--batch-size", "8", "--out-dir", out,
                             "--device", "cuda", "--seed", "0"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernel_launches()
    with open(os.path.join(out, "best_meta.json")) as f:
        meta = json.load(f)
    print(f"midu training CLI, --scale sd, 512 px, batch 8, 2 steps: {seconds:.1f} s (models made "
          f"on the host included), best validation loss {meta['val_loss']:.5f} at step "
          f"{meta['step']}; K1/K2 launches {launches} (512 px: the VAE attends over 4096 "
          f"positions, below the gate); on {card}")
    check(meta["step"] == 2 and np.isfinite(meta["val_loss"]), "midu training: checkpoint meta")
    check(launches == (0, 0, 0, 0), f"midu training at 512 px launched K1/K2: {launches}")
    return os.path.join(out, "best.pt")


def load_checkpoint_phase(args, stack, path):
    """The trained midu read into the SD edit by ``--midu-ckpt``'s loader
    (``strict=True``)."""
    from rgie_tpu_torch.cli import adapt_images as cli
    from rgie_tpu_torch.utils.checkpoint import load_torch_state_dict

    midu = stack.pipe.midu_model
    cli.load_midu_checkpoint(midu, path)
    saved, got = load_torch_state_dict(path), midu.state_dict()
    check(sorted(saved) == sorted(got) and
          all(torch.equal(saved[k].to(got[k].device), got[k]) for k in saved),
          "the edit's midu differs from the trained checkpoint")


def record_k2_shapes():
    """Wrap the three launch functions to count the shapes they launch at;
    returns (the counter, a function that unwraps them)."""
    from collections import Counter

    from rgie_tpu_torch.ops.kernels import flash_attention as FA

    shapes, saved = Counter(), {}
    for name in ("_launch_fwd", "_launch_bwd_dkv", "_launch_bwd_dq"):
        fn = saved[name] = getattr(FA, name)

        def wrapped(q, *rest, _fn=fn, _name=name):
            shapes[(_name.removeprefix("_launch_"), tuple(q.shape), str(q.dtype)[6:])] += 1
            return _fn(q, *rest)

        setattr(FA, name, wrapped)
    return shapes, lambda: [setattr(FA, name, fn) for name, fn in saved.items()]


def batched_path_phase(args, stack, work, rng, card, single_s, single_peak):
    """Phase 16: the diffusion CLI's batched path (``adapt_batches``) at
    ``--batch BATCH`` on a feed of random 1024 px JPEGs, the stack of phase 7
    (bfloat16, its midu the one phase 15 trained) at ``BATCH_STEPS`` DDIM
    steps. Returns the K2 launch counts."""
    import argparse
    import dataclasses

    from PIL import Image

    from rgie_tpu_torch.cli import adapt_images as cli
    from rgie_tpu_torch.diffusion import schedulers as SCH
    from rgie_tpu_torch.ops.kernels import flash_attention as FA

    feed = os.path.join(work, "feed")
    os.makedirs(os.path.join(feed, "images"), exist_ok=True)
    os.makedirs(os.path.join(feed, "annotations"), exist_ok=True)
    for b in range(BATCH):
        Image.fromarray((rng.uniform(0, 1, (DIFFUSION_SIZE, DIFFUSION_SIZE, 3)) * 255)
                        .astype(np.uint8)).save(os.path.join(feed, "images", f"{b + 1:012d}.jpg"))
    with open(os.path.join(feed, "annotations", "captions.json"), "w") as f:
        json.dump({str(b + 1): f"a random image {b}" for b in range(BATCH)}, f)
    out_dir = os.path.join(work, "out_batched")
    args = argparse.Namespace(**{**vars(args), "batch": BATCH, "num_steps": BATCH_STEPS,
                                 "segment": 0, "out_dir": out_dir})
    stack = stack._replace(pipe=dataclasses.replace(stack.pipe,
                                                    sched=SCH.make_schedule(BATCH_STEPS)))
    adapter = cli.make_adapter(stack)
    gcfg, acfg = cli.make_configs(args)

    shapes, unwrap = record_k2_shapes()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_launches()
    try:
        (names, out, log, seconds), = cli.adapt_batches(args, stack, adapter,
                                                        cli.feed_items(feed), gcfg, acfg,
                                                        out_dir)
        torch.cuda.synchronize()
    finally:
        unwrap()
    counts = (FA.LAUNCHES_FWD, FA.LAUNCHES_BWD_DKV, FA.LAUNCHES_BWD_DQ)
    peak = torch.cuda.max_memory_allocated()

    print(f"batched edit, bfloat16, {BATCH} images: {BATCH_STEPS} DDIM steps, null-text inner "
          f"steps per outer step and image {log.nto_image_steps}")
    want_fwd, want_bwd = expected_flash_launches(BATCH_STEPS, log.nto_inner_steps)
    print(f"  launches counted: forward {counts[0]}, dK/dV {counts[1]}, dQ {counts[2]}; expected "
          f"{want_fwd}, {want_bwd}, {want_bwd} (the batch rides in each launch)")
    print("  K2 shapes launched: " + "; ".join(f"{k} {shape} {dt} x{n}" for (k, shape, dt), n
                                             in sorted(shapes.items())))
    check(counts == (want_fwd, want_bwd, want_bwd), "batched K2 launch counts differ")
    check(("fwd", BATCH_K2_SHAPES[0], "bfloat16") in shapes and
          ("fwd", BATCH_K2_SHAPES[1], "bfloat16") in shapes,
          "the batched edit did not launch the batch's shapes")
    check(out.edited.shape == (BATCH, DIFFUSION_SIZE, DIFFUSION_SIZE, 3), "batched image shape")
    check(bool(torch.isfinite(out.edited).all()), "non-finite batched images")
    check(float(out.edited.min()) >= 0.0 and float(out.edited.max()) <= 1.0,
          "batched images outside [0, 1]")
    check(bool(torch.isfinite(out.orig_score).all() and torch.isfinite(out.adapted_score).all()),
          "non-finite batched scores")
    nto = log.tensors["nto_embeds"]
    check(nto.shape == (BATCH_STEPS, BATCH, 77, 1024) and nto.dtype == torch.float32 and
          bool(torch.isfinite(nto).all()), "batched null-text embeddings")
    check(len(log.clf_grad_norms) == BATCH_STEPS and
          all(n.shape == (BATCH,) and bool((n > 0).all()) for n in log.clf_grad_norms),
          "batched classifier-guidance gradient norms")
    for name in names:
        check(os.path.exists(os.path.join(out_dir, gcfg.resolved_label(), name)),
              f"saved batched image {name}")
    phases = ", ".join(f"{k} {v:.3f}" for k, v in log.seconds.items())
    print(f"batched edit, bfloat16: {seconds:.3f} s for {BATCH} 1024 px images at {BATCH_STEPS} "
          f"steps = {seconds / BATCH:.3f} s an image, {BATCH / seconds:.4f} img/s, peak memory "
          f"{peak / 2**30:.2f} GiB; the single edit of phase 7 at the same steps {single_s:.3f} "
          f"s, {1 / single_s:.4f} img/s, peak {single_peak / 2**30:.2f} GiB; on {card}")
    print(f"  seconds per phase: {phases}")
    return counts


def controlnet_phase(stack, rng, card):
    """Phase 17: ControlNet at SD-2.1 width on phase 7's bfloat16 UNet, 1024
    px, batch 2: forward and backward (to the latents and the control image)
    of ``controlled_unet_apply``, kernel route against plain route; then
    float32 copies on the card against the CPU at ``CN_CPU_SIZE`` px. Returns
    the K2 launch counts of the kernel route."""
    import copy

    from rgie_tpu_torch.diffusion import unet as U
    from rgie_tpu_torch.diffusion.controlnet import controlled_unet_apply, create_controlnet
    from rgie_tpu_torch.ops.kernels import flash_attention as FA

    t0 = time.perf_counter()
    unet = stack.pipe.unet
    device, dtype, cfg = stack.pipe.device, unet.dtype, unet.cfg
    cn = create_controlnet(torch.Generator().manual_seed(2), cfg)
    with torch.no_grad():   # zero convolutions drawn away from zero: residuals with weight
        g = torch.Generator().manual_seed(3)
        for conv in [*cn.controlnet_down_blocks, cn.controlnet_mid_block,
                     cn.controlnet_cond_embedding.conv_out]:
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=g) * 0.02)
    cn_card = copy.deepcopy(cn).to(device, dtype)
    build_s = time.perf_counter() - t0

    def arr(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    def run(u, c, lat, ctx, image, w, dev):
        lat = lat.to(dev).requires_grad_(True)
        image = image.to(dev).requires_grad_(True)
        t = torch.tensor([500] * lat.shape[0], device=dev)
        eps, mid = controlled_unet_apply(u, c, lat, t, ctx.to(dev), image)
        ((eps.float() * w.to(dev)).sum() + mid.float().sum()).backward()
        return [x.detach().float().cpu() for x in (eps, mid, lat.grad, image.grad)]

    hw = DIFFUSION_SIZE // 8
    inputs = (arr(2, hw, hw, 4), arr(2, 77, cfg.cross_attention_dim),
              torch.from_numpy(rng.uniform(0, 1, (2, DIFFUSION_SIZE, DIFFUSION_SIZE, 3))
                               .astype(np.float32)), arr(2, hw, hw, 4))
    reset_kernel_launches()
    t1 = time.perf_counter()
    kernel = run(unet, cn_card, *inputs, device)
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t1
    counts = kernel_launches()[1:]
    saved = U.flash_attention
    U.flash_attention = lambda q, k, v, sm_scale: FA.plain_flash_attention(q, k, v, sm_scale)
    try:
        plain = run(unet, cn_card, *inputs, device)
    finally:
        U.flash_attention = saved
    check(kernel_launches()[1:] == counts, "the plain route launched K2")
    # Every self-attention site at 128 x 128 latents: the UNet's and the
    # ControlNet's copies of the top down block; all of them depend on the
    # latents, so each has a backward.
    cn_sites = cfg.layers_per_block * cfg.transformer_layers_per_block[0]
    sites = ATTENTION_SITES_UNET + cn_sites
    errs = {name: rel_err(k, p) for name, k, p in zip(
        ("eps", "mid features", "latents gradient", "control image gradient"), kernel, plain)}
    print(f"ControlNet, SD-2.1 width, 1024 px, batch 2, {str(dtype)[6:]}: forward and backward of "
          f"controlled_unet_apply in {kernel_s:.3f} s (ControlNet made in {build_s:.1f} s); K2 "
          f"launches {counts}, expected {sites} each ({ATTENTION_SITES_UNET} UNet sites + "
          f"{cn_sites} ControlNet sites); kernel route against plain route: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (limits {CN_OUT_TOL:g}, gradients {CN_GRAD_TOL:g}); on {card}")
    check(counts == (sites, sites, sites), "ControlNet K2 launch counts differ from the derivation")
    check(all(bool(torch.isfinite(x).all()) for x in kernel), "non-finite ControlNet outputs")
    check(errs["eps"] <= CN_OUT_TOL and errs["mid features"] <= CN_OUT_TOL,
          "ControlNet: kernel route disagrees with the plain route")
    check(errs["latents gradient"] <= CN_GRAD_TOL and errs["control image gradient"] <= CN_GRAD_TOL,
          "ControlNet: kernel route's gradients disagree with the plain route's")

    # Card against CPU, float32 copies (the UNet's bfloat16 weights widened).
    unet32, cn32 = copy.deepcopy(unet).cpu().float(), cn
    hw = CN_CPU_SIZE // 8
    small = (arr(1, hw, hw, 4), arr(1, 77, cfg.cross_attention_dim),
             torch.from_numpy(rng.uniform(0, 1, (1, CN_CPU_SIZE, CN_CPU_SIZE, 3))
                              .astype(np.float32)), arr(1, hw, hw, 4))
    t1 = time.perf_counter()
    on_card = run(copy.deepcopy(unet32).to(device), copy.deepcopy(cn32).to(device), *small, device)
    on_cpu = run(unet32, cn32, *small, torch.device("cpu"))
    errs = {name: rel_err(a, b) for name, a, b in zip(
        ("eps", "mid features", "latents gradient", "control image gradient"), on_card, on_cpu)}
    print(f"ControlNet card against CPU at {CN_CPU_SIZE} px, full width, float32 (of the largest "
          f"entry; limit 1e-3): " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f"; {time.perf_counter() - t1:.1f} s")
    for name, err in errs.items():
        check(err <= 1e-3, f"ControlNet {name} disagrees with the CPU")
    return counts


def sdxl_training_phase(stack, card):
    """Phase 18: midu training at SDXL width on phase 8's frozen UNet and VAE
    (bfloat16), 1024 px, ``MIDU_STEPS`` steps at batch ``MIDU_BATCH`` through
    the training CLI's ``features_and_labels`` and the train step; then one
    float32 step on the card against the CPU on the same features and labels.
    Returns the K2 launch counts of the steps."""
    import copy

    from rgie_tpu_torch.cli import train_guidance_clf as T
    from rgie_tpu_torch.config import TrainGuidanceConfig
    from rgie_tpu_torch.models.midu import create_midu
    from rgie_tpu_torch.ops.kernels import flash_attention as FA
    from rgie_tpu_torch.training import create_train_state, make_train_step
    from rgie_tpu_torch.training.clf_wrapper import create_teacher

    pipe = stack.pipe
    device, dtype = pipe.device, pipe.unet.dtype
    g = torch.Generator().manual_seed(4)
    teacher = create_teacher(g, dtype=dtype)
    teacher.loss.to(device)
    tstack = T.make_stack(pipe.unet, pipe.vae, teacher, DIFFUSION_SIZE)
    midu = create_midu(g, is_sdxl=True, in_channels=pipe.unet.cfg.block_out_channels[-1])
    midu0 = copy.deepcopy(midu)
    cfg = TrainGuidanceConfig()
    state, step = create_train_state(midu.to(device), cfg), make_train_step()
    data = torch.Generator().manual_seed(5)
    losses, times = [], []
    reset_kernel_launches()
    for i in range(MIDU_STEPS):
        t0 = time.perf_counter()
        images = torch.rand((MIDU_BATCH, DIFFUSION_SIZE, DIFFUSION_SIZE, 3),
                            generator=data).to(device)
        feats, labels = T.features_and_labels(tstack, data, images)
        state, loss, _ = step(state, feats, labels)
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
    counts = kernel_launches()[1:]
    route = FA.kernel_route("fwd", dtype, pipe.vae.cfg.block_out_channels[-1])
    print(f"SDXL midu training, 1024 px, batch {MIDU_BATCH}, frozen models {str(dtype)[6:]}: "
          f"losses {losses}, seconds per step {[round(t, 3) for t in times]} (the first "
          f"includes warm-up); K2 launches {counts}, expected ({MIDU_STEPS}, 0, 0): the VAE "
          f"encode's {route} forward, once per step; features {tuple(feats.shape)}; on {card}")
    check(counts == (MIDU_STEPS, 0, 0) and route == "wide", "SDXL training K2 launches")
    check(feats.shape == (MIDU_BATCH, 32, 32, 1280) and labels.shape == (MIDU_BATCH, 2),
          "SDXL training features and labels")
    check(all(np.isfinite(losses)), "non-finite SDXL training loss")

    # One float32 step on the card and on the CPU from the same weights.
    results = []
    for dev in (device, torch.device("cpu")):
        s = create_train_state(copy.deepcopy(midu0).to(dev), cfg)
        s, loss, out = step(s, feats.to(dev), labels.to(dev))
        results.append((float(loss), out.cpu(),
                        torch.cat([p.grad.cpu().flatten() for p in s.model.parameters()]),
                        torch.cat([p.detach().cpu().flatten() for p in s.model.parameters()])))
    (l_card, o_card, g_card, p_card), (l_cpu, o_cpu, g_cpu, p_cpu) = results
    p0 = torch.cat([p.detach().flatten() for p in midu0.parameters()])
    # What Adam steps on: the gradient plus the L2 term. Where that is set by
    # the gradient's rounding, the step's sign is not; elsewhere the steps agree.
    g_eff = (g_cpu + cfg.weight_decay * p0).abs()
    settled = g_eff > MIDU_SETTLED * g_eff.max()
    apart = (p_card - p_cpu).abs()[settled]
    e_step = float(apart.max())
    # a hundredth of lr, plus one float32 rounding of the weight it lands on
    within = bool((apart <= 1e-2 * cfg.learning_rate + p0.abs()[settled] * 2.0 ** -23).all())
    print(f"SDXL midu train step, float32, card against CPU: loss {l_card:.7f} vs {l_cpu:.7f}, "
          f"predictions {rel_err(o_card, o_cpu):.3e} and gradients {rel_err(g_card, g_cpu):.3e} "
          f"of the largest entry; updates (lr {cfg.learning_rate:g}) at the "
          f"{int(settled.sum())} of {p0.numel()} entries whose gradient is above "
          f"{MIDU_SETTLED:g} of the largest differ by at most {e_step:.3e} (limit a hundredth "
          f"of lr and a rounding); all entries by {float((p_card - p_cpu).abs().max()):.3e}")
    check(abs(l_card - l_cpu) <= MIDU_RTOL * abs(l_cpu), "midu train step loss: card vs CPU")
    check(rel_err(o_card, o_cpu) <= MIDU_RTOL, "midu train step predictions: card vs CPU")
    check(rel_err(g_card, g_cpu) <= MIDU_RTOL, "midu train step gradients: card vs CPU")
    check(float((p_cpu - p0)[settled].abs().min()) > 0.5 * cfg.learning_rate,
          "midu train step: a settled entry did not move")
    check(within, "midu train step updates: card vs CPU")
    return counts


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
    counts_f32, latents_f32, _, _ = diffusion_path_phase(edit_args, stack, image_path,
                                                         FLOAT32_STEPS, card)
    card_against_cpu_phase(stack, rng)
    module_route_phase(stack, rng)
    # ---- 14. the batched edit's rows against single-image edits, and the
    # segmented edit against the whole one, in float32
    batched_equality_phase(edit_args, stack, rng, card)
    del stack
    torch.cuda.empty_cache()

    # ---- 7 (and 6 again). the bfloat16 diffusion edit: the CLI's default type
    edit_args, stack = diffusion_models(device, image_path, None, DIFFUSION_STEPS)
    check(next(stack.pipe.unet.parameters()).dtype == torch.bfloat16,
          "the diffusion CLI's default type at --scale sd is not bfloat16")
    module_route_phase(stack, rng)
    _, latents_short, single_s, single_peak = diffusion_path_phase(edit_args, stack, image_path,
                                                                   FLOAT32_STEPS, card)
    distance = float((latents_short - latents_f32).abs().max())
    print(f"bfloat16 edit against float32 edit, both {FLOAT32_STEPS} steps from seed 0: output "
          f"latents differ by at most {distance:.4f}, mean {float((latents_short - latents_f32).abs().mean()):.4f} "
          f"(float32 latents: largest entry {float(latents_f32.abs().max()):.4f}, mean magnitude "
          f"{float(latents_f32.abs().mean()):.4f}); recorded, not checked")
    counts_bf16, _, _, _ = diffusion_path_phase(edit_args, stack, image_path, DIFFUSION_STEPS,
                                                card)

    # ---- 15-17. midu training at --scale sd through its CLI, its checkpoint
    # read by the edit, the batched edit in bfloat16 and ControlNet, on the
    # stack of phase 7
    midu_path = training_cli_phase(work, card)
    load_checkpoint_phase(edit_args, stack, midu_path)
    counts_batch = batched_path_phase(edit_args, stack, work, rng, card, single_s, single_peak)
    torch.cuda.empty_cache()
    counts_cn = controlnet_phase(stack, rng, card)
    del stack
    torch.cuda.empty_cache()

    # ---- 8-10. the SDXL edit, its UNet against the CPU, the tiled VAE
    stack, counts_sdxl = sdxl_path_phase(device, image_path, card)
    sdxl_card_against_cpu_phase(stack, rng)
    tiled_vae_phase(stack, rng)
    # ---- 18. midu training at SDXL width, 1024 px, on the same stack
    counts_train = sdxl_training_phase(stack, card)
    del stack
    torch.cuda.empty_cache()

    # ---- 11-13. the bench's bfloat16 workload, the GAN edit, its check
    # against the CPU
    bench_phase(device, card)
    torch.cuda.empty_cache()
    gan_phase(device, card)
    torch.cuda.empty_cache()
    gan_card_against_cpu_phase(device, rng)
    paths = {"float32 edit": counts_f32, "bfloat16 edit": counts_bf16, "SDXL edit": counts_sdxl,
             "batched edit": counts_batch, "ControlNet": counts_cn,
             "SDXL midu training": counts_train}
    for i, entry in enumerate(k2_entries):
        entry["launches"] = sum(counts[i] for counts in paths.values())
        entry["launches_by_path"] = {name: counts[i] for name, counts in paths.items()}
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
