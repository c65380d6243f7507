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
   (1, 1, 16384, 512), (1, 2, 16384, 256) (as many operations as the VAE's,
   at half its width), the ragged (1, 5, 9000, 64) and (1, 1, 2100, 512),
   and widths 32, 128, 36, 256, 192 and 136 (the last two ragged in N and
   zero-filled to 256 columns by the wide float32 dK/dV and dQ), in float32
   and bfloat16; tolerances in ``K2_TOLERANCE`` below; the route of each of
   the three kernels (``kernel_route``: tensor, wide, float32 or
   cuda_cores) is printed per shape. The float32 dK/dV and dQ at the VAE's
   shape are called twice and must give the same bits (fixed summation
   order, no atomics). Kernel and plain version are timed with CUDA events in
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
   weights on the same features and labels. The teacher is float32 (checked
   here and in phase 15, where the UNet and VAE are bfloat16).
19. The dataset transform run through its CLI (``cli/run_img_trans.py``):
   ``TRANS_IMAGES`` random 1024 px JPEGs in a COCO layout, ``--type CUSTOM
   --batch TRANS_BATCH --compare-emotions``; K1 launches once per batch (2),
   no K2; K1 on the first batch against its plain version (``TOLERANCE``) and
   timed at (12, 1024, 1024, 3) per call and on the device, beside its bound.
20. EmoNet: a random checkpoint under the reference's names drives the
   parametric-edit CLI's ``--va-model`` (4 images, ``EMONET_STEPS`` steps, one
   adaptation, the 1024 px re-render through K1); EmoNet card against CPU in
   float32 (``EMONET_RTOL``).
21. The analysis: ``cli/process_result_images.py --fid`` on phase 19's
   originals and outputs (full-width Inception-v3, random weights); Inception
   card against CPU in float32 (``INCEPTION_RTOL``); ``cli/run_eval_report.py
   --scale sd`` with its steps cut (512 px: no K1, no K2 launch).
22. Slice F: two ranks share the one card in an explicit ``gloo`` group
   (``parallel.spawn_ranks``: processes started with ``multiprocessing``'s
   spawn), each running the four CLIs with its share of the global batch:
   (a) the parametric CLI at full width (4 random 480 px JPEGs, global
   ``--batch 4``, ``F_PARAM_STEPS`` steps, the 1024 px re-render): each
   rank's rows against the one-process batch-4 rows of the same images
   (``F_ROW_ATOL``), each output written once, K1 launched once per image of
   the rank; (b) the training CLI at ``--scale sd`` (global ``--batch-size
   8``, 2 steps): both ranks end with bit-identical midus, only rank 0 writes
   the checkpoint, and one DDP step of a SD-width midu on fixed features
   equals the one-process step on their union (phase 18's limits); (c) the
   diffusion CLI at SD-2.1 width, 1024 px, bfloat16, global ``--batch 2``,
   ``F_DIFF_STEPS`` DDIM steps with the CLI's null-text inner steps and
   phase 15's midu: each rank's K2 counts equal the single-image derivation,
   its row against the one-process batch-2 row of its image
   (``F_DIFF_ATOL``; the one-process run is made after phase 16 on phase 7's
   stack, the same weights); (d) the GAN CLI at 256 px, global ``--batch 4``,
   ``F_GAN_STEPS`` steps: rows against the one-process rows
   (``F_ROW_ATOL``); (e) a one-rank ``nccl`` group: one all-reduce and a
   barrier. A failed rank fails the run. Seconds, img/s and peak memory per
   rank and for one process at the same global batch are printed (two ranks
   on one card measure overhead and contention, not scaling).
23. Each path is driven with the launch counts set to 0 just before it and
   read just after. One JSON line ``{"kernels": [...]}`` (the K2 entries'
   times are bfloat16's, the type the full-width path runs by default, with
   float32's beside them under ``float32_*`` and the shapes a batch of 2
   adds under ``batch_shapes``; the K1 entry has phase 19's shape under
   ``run_img_trans_*``; launches are the sum over the paths, by path under
   ``launches_by_path``; the GAN path and the bench launch none), then the
   card, then the last line ``{"ok": true, "device": {...}}``.

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

# The dataset transform run (phase 19): run_img_trans's default batch over a
# COCO layout of two batches' worth of random 1024 px JPEGs.
TRANS_IMAGES, TRANS_BATCH = 24, 12
# EmoNet (phase 20): the parametric edit's steps through --va-model, and its
# forward card against CPU in float32, relative to the largest entry.
EMONET_STEPS, EMONET_RTOL = 10, 1e-4
# The analysis (phase 21): Inception-v3 card against CPU in float32, relative
# to the largest entry; the evaluation report's images and cut steps.
INCEPTION_RTOL = 1e-4
REPORT_SCALE, REPORT_IMAGES, REPORT_STEPS, REPORT_DIFF_STEPS, REPORT_NTO_STEPS = "sd", 2, 10, 4, 2
# Slice F (phase 22): two ranks on the one card, and the CLIs' global
# batches and cut steps (the training CLI's are phase 15's). A rank edits
# its images at a batch of 1 or 2 where one process edits all at 2 or 4, and
# on the card neither run repeats bit for bit (cuDNN's backward algorithms
# sum in run-dependent orders). The parametric rows are held to F_ROW_ATOL
# (--segment's 1e-3 on the card; at F_PARAM_STEPS steps every image's best
# vector is the identity, the loss having risen from the first step) and
# their first losses to MIDU_RTOL. The GAN's loss trajectories agree within
# 2.7e-6 of the largest and are held to MIDU_RTOL; its rows, decoded from
# style codes that differ by rounding, moved 3.7e-4 to 4.0e-3 in [-1, 1]
# against one process at batch 2 or 4 (NVIDIA H100 at 700 W): F_GAN_ROW_ATOL,
# 2^-5; the distance between two images' edits is printed beside it. The
# diffusion edit runs
# in bfloat16, where one rounding step near 1 is 2^-8 and null-text Adam and
# guidance carry roundings on: the same one-process edit run twice moved by
# up to 0.024 (mean 0.0023). A row is held by its mean absolute distance from
# the one-process batch-2 row, F_DIFF_ATOL (reading 0.012), printed beside
# the largest entry and the mean distance between the two images' edits.
F_RANKS, F_PARAM_STEPS, F_DIFF_STEPS, F_GAN_SIZE, F_GAN_STEPS = 2, 10, 2, 256, 5
F_PARAM_BATCH, F_TRAIN_BATCH, F_DIFF_BATCH, F_GAN_BATCH = 4, 8, 2, 4
F_ROW_ATOL, F_GAN_ROW_ATOL, F_DIFF_ATOL = 1e-3, 2.0 ** -5, 2.0 ** -5

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
    for shape in [unet_shape, vae_shape, (1, 2, 16384, 256), (1, 5, 9000, 64), (2, 3, 1000, 32),
                  (1, 2, 2100, 128), (1, 2, 1000, 36), (1, 1, 2100, 512), (1, 2, 1000, 256),
                  (1, 2, 700, 192), (1, 1, 130, 136)]:
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
            if dtype == torch.float32 and shape == vae_shape:
                # The wide float32 dK/dV and dQ sum in a fixed order: a second
                # call gives the same bits.
                again = (FA._launch_bwd_dkv(qs, ks, vs, dos, lse, di, scale)
                         + (FA._launch_bwd_dq(qs, ks, vs, dos, lse, di, scale),))
                first = (FA._launch_bwd_dkv(qs, ks, vs, dos, lse, di, scale)
                         + (FA._launch_bwd_dq(qs, ks, vs, dos, lse, di, scale),))
                torch.cuda.synchronize()
                same = [torch.equal(a, b) for a, b in zip(first, again)]
                print(f"flash attention {shape} float32: dK, dV, dQ of two calls bit-equal: "
                      f"{same}")
                check(all(same), f"flash attention float32 backward differs between two calls "
                      f"at {shape}")
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
    # The float32 wide backward kernels at the VAE's single 512-wide head.
    for entry, key in ((entries[1], "dkv"), (entries[2], "dq")):
        entry.update(float32_wide_shape=list(vae_shape),
                     float32_wide_route=FA.kernel_route("bwd_" + key, torch.float32,
                                                        vae_shape[3]),
                     float32_wide_ms=wide32[key][0], float32_wide_plain_ms=wide32[key][1],
                     float32_wide_bound_ms=wide32["bounds"][key][0],
                     float32_wide_bound_by=wide32["bounds"][key][1],
                     float32_wide_library_ms=wide32[key][2], float32_wide_bit_equal=True)
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
    path, and the seconds and peak memory of the run (phase 22's one-process
    training run; its peak memory above what was held before it)."""
    from rgie_tpu_torch.cli import train_guidance_clf

    out = os.path.join(work, "midu_sd")
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()      # phase 7's stack, not this run's
    reset_kernel_launches()
    t0 = time.perf_counter()
    stack = train_guidance_clf.main(["--scale", "sd", "--epochs", "1", "--num-batches", "2",
                                     "--val-batches", "1", "--batch-size", "8", "--out-dir",
                                     out, "--device", "cuda", "--seed", "0"])
    torch.cuda.synchronize()
    frozen_dtype = next(stack.unet.parameters()).dtype
    teacher_dtype = next(stack.teacher.loss.parameters()).dtype
    print(f"midu training CLI types: UNet and VAE {str(frozen_dtype)[6:]}, teacher "
          f"{str(teacher_dtype)[6:]}")
    check(frozen_dtype == torch.bfloat16 and teacher_dtype == torch.float32,
          "midu training CLI: the frozen models are not bfloat16 or the teacher not float32")
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
    return os.path.join(out, "best.pt"), {"seconds": seconds,
                                          "peak": torch.cuda.max_memory_allocated() - held}


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

    from rgie_tpu_torch.cli import adapt_images as cli
    from rgie_tpu_torch.diffusion import schedulers as SCH
    from rgie_tpu_torch.ops.kernels import flash_attention as FA

    feed = write_feed(os.path.join(work, "feed"), rng, BATCH, DIFFUSION_SIZE)
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
    # The teacher is float32 whatever the frozen models' type, as the training
    # CLI builds it (its labels are the midu's targets).
    teacher = create_teacher(g)
    teacher.loss.to(device)
    teacher_dtype = next(teacher.loss.parameters()).dtype
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
          f"encode's {route} forward, once per step; features {tuple(feats.shape)}; teacher "
          f"{str(teacher_dtype)[6:]}, labels {str(labels.dtype)[6:]}; on {card}")
    check(teacher_dtype == torch.float32 and labels.dtype == torch.float32,
          "SDXL training: the teacher or its labels are not float32")
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


def write_coco(root, rng, n, size):
    """A COCO captions layout of ``n`` random ``size`` px JPEGs: annotations/
    captions_val2017.json and val2017/."""
    from PIL import Image

    os.makedirs(os.path.join(root, "val2017"), exist_ok=True)
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    images, annotations = [], []
    for i in range(n):
        name = f"{i + 1:012d}.jpg"
        Image.fromarray((rng.uniform(0, 1, (size, size, 3)) * 255).astype(np.uint8)).save(
            os.path.join(root, "val2017", name), quality=95)
        images.append({"id": i + 1, "file_name": name})
        annotations.append({"image_id": i + 1, "caption": f"a random image {i}"})
    with open(os.path.join(root, "annotations", "captions_val2017.json"), "w") as f:
        json.dump({"images": images, "annotations": annotations}, f)


def run_img_trans_phase(device, work, rng, card):
    """Phase 19: the dataset transform run at full width through its CLI:
    ``TRANS_IMAGES`` random 1024 px JPEGs in a COCO layout, ``--type CUSTOM
    --batch TRANS_BATCH --compare-emotions`` (the ten-crop ResNet-50 at
    480/448, random weights from the seed). K1 launches once per batch,
    ceil(TRANS_IMAGES / TRANS_BATCH) times, and no K2 kernel runs. Then K1 on
    the first batch against its plain version (``TOLERANCE``) and timed at
    that shape. Returns the K1 entry's fields for this path (``launches``: the
    path's K1/K2 launch counts), and the directories of the originals and the
    outputs."""
    from rgie_tpu_torch.cli import run_img_trans
    from rgie_tpu_torch.cli.kernel_variants import graph_ms
    from rgie_tpu_torch.data import CocoCaptionsDataset, iterate_batches
    from rgie_tpu_torch.ops.kernels import pointwise_chain as PC

    coco, out = os.path.join(work, "coco"), os.path.join(work, "img_trans")
    write_coco(coco, rng, TRANS_IMAGES, OUTPUT_SIZE)
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_launches()
    t0 = time.perf_counter()
    summary = run_img_trans.main([
        "--data-dir", coco, "--dataset", "coco", "--type", "CUSTOM", "--batch",
        str(TRANS_BATCH), "--input-size", str(OUTPUT_SIZE), "--crop-size", str(OUTPUT_SIZE),
        "--compare-emotions", "--output-dir", out, "--device", str(device), "--seed", "0"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernel_launches()
    expected = -(-TRANS_IMAGES // TRANS_BATCH)
    stats = summary.stats["CUSTOM"]
    print(f"run_img_trans, {TRANS_IMAGES} images of {OUTPUT_SIZE} px in batches of "
          f"{TRANS_BATCH}, --type CUSTOM --compare-emotions: {seconds:.2f} s with the models' "
          f"build (the transform loop {summary.seconds:.2f} s, JPEG decode and encode "
          f"included), peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; K1/K2 "
          f"launches {launches}, expected ({expected}, 0, 0, 0); VA means: valence "
          f"{np.mean(stats['valence']):.5f}, arousal {np.mean(stats['arousal']):.5f}, delta "
          f"({np.mean(stats['delta_valence']):.5f}, {np.mean(stats['delta_arousal']):.5f}), "
          f"rec_error {np.mean(stats['rec_error']):.5f}; on {card}")
    check(launches == (expected, 0, 0, 0), f"run_img_trans launches {launches}")
    check(summary.images == TRANS_IMAGES and summary.batches == expected,
          "run_img_trans: images or batches")
    check(all(len(v) == TRANS_IMAGES and np.all(np.isfinite(v)) for v in stats.values()),
          "run_img_trans: VA statistics")
    check(min(stats["rec_error"]) > 0, "run_img_trans: an output equals its original")
    check(len([n for n in os.listdir(out) if n.endswith(".jpg")]) == TRANS_IMAGES,
          "run_img_trans: outputs")

    # K1 on the CLI's first batch against its plain version, then timed there.
    images_np, _ = next(iterate_batches(CocoCaptionsDataset(coco), TRANS_BATCH, OUTPUT_SIZE,
                                        OUTPUT_SIZE))
    images = torch.from_numpy(images_np).to(device)
    params = summary.params
    err = float((PC.pointwise_chain(images, params)
                 - PC.reference_pointwise_chain(images, params)).abs().max())
    shape = tuple(images.shape)
    ms, plain_ms = time_group([lambda: PC.pointwise_chain(images, params),
                               lambda: PC.reference_pointwise_chain(images, params)])
    device_ms = graph_ms(lambda: PC.pointwise_chain(images, params))
    bound_ms, bound_by = bound(60.0 * np.prod(shape), 2 * 4 * np.prod(shape), torch.float32)
    print(f"pointwise_chain {shape} (run_img_trans's batch): max abs err {err:.3e} (tolerance "
          f"{TOLERANCE:g}); kernel {ms:.4f} ms a call, {device_ms:.4f} ms on the device alone "
          f"(CUDA graph replay), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by "
          f"{bound_by}; on {card}")
    check(err <= TOLERANCE, f"pointwise_chain disagrees with its plain version at {shape}")
    entry = {"launches": launches, "shape": list(shape), "ms": ms, "device_ms": device_ms,
             "plain_ms": plain_ms, "bound_ms": bound_ms, "max_abs_err": err}
    return entry, os.path.join(coco, "val2017"), out


def emonet_phase(device, work, rng, card):
    """Phase 20: EmoNet. A random EmoNet state dict under the reference's
    names, written as EmoNet_valence.pt, drives the parametric-edit CLI's
    ``--va-model`` on a feed of ``NUM_IMAGES`` random 480 px JPEGs at batch
    ``NUM_IMAGES``, ``EMONET_STEPS`` Adam steps (cut from the CLI's 300) and
    one adaptation (cut from five), re-rendered at 1024 px through K1 (one
    launch per image, no K2). Then EmoNet's forward on 2 images, card against
    CPU in float32 with TF32 off: ``EMONET_RTOL`` of the largest entry.
    Returns the path's K1/K2 launch counts."""
    from rgie_tpu_torch.cli import optimize_image_param
    from rgie_tpu_torch.models.emonet import create_emonet, load_emonet, to_reference_keys

    ckpt = os.path.join(work, "EmoNet_valence.pt")
    torch.save(to_reference_keys(create_emonet(torch.Generator().manual_seed(3)).net.state_dict()),
               ckpt)
    feed = write_feed(os.path.join(work, "emonet_feed"), rng, NUM_IMAGES, EDIT_SIZE)
    out = os.path.join(work, "emonet_edit")
    reset_kernel_launches()
    t0 = time.perf_counter()
    optimize_image_param.main([
        "--data-dir", feed, "--out-dir", out, "--va-model", ckpt, "--num-steps",
        str(EMONET_STEPS), "--batch", str(NUM_IMAGES), "--adaptations", f"smoke:{ALPHA}",
        "--device", str(device), "--seed", "0"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernel_launches()
    print(f"EmoNet parametric edit through the CLI: {NUM_IMAGES} images {EDIT_SIZE} px, "
          f"{EMONET_STEPS} steps, re-rendered at {OUTPUT_SIZE} px: {seconds:.2f} s with the "
          f"models' build; K1/K2 launches {launches}, expected ({NUM_IMAGES}, 0, 0, 0); on {card}")
    check(launches == (NUM_IMAGES, 0, 0, 0), f"EmoNet edit launches {launches}")
    check(len(os.listdir(out)) == NUM_IMAGES, "EmoNet edit: outputs")

    from rgie_tpu_torch.utils.checkpoint import load_torch_state_dict

    net = load_emonet(load_torch_state_dict(ckpt), normalize_input=True)
    x = torch.from_numpy(rng.uniform(0, 1, (2, EDIT_SIZE, EDIT_SIZE, 3)).astype(np.float32))
    with torch.no_grad():
        cpu_out = net(x)
        card_out = net.to(device)(x.to(device)).cpu()
    err = rel_err(card_out, cpu_out)
    print(f"EmoNet forward, 2 images {EDIT_SIZE} px, float32: card against CPU {err:.3e} of the "
          f"largest entry (limit {EMONET_RTOL:g}); valence {cpu_out[:, 0].tolist()}, fake "
          f"arousal {card_out[:, 1].tolist()}")
    check(err <= EMONET_RTOL, "EmoNet: card disagrees with the CPU")
    check(bool((card_out[:, 1] == 0).all()), "EmoNet: the fake arousal column is not zero")
    return launches


def analysis_phase(device, work, originals_dir, outputs_dir, rng, card):
    """Phase 21: the analysis. (a) The result-processing CLI with ``--fid`` on
    phase 19's originals and outputs as ``{name}_o.jpg`` and
    ``{name}_custom.jpg``: VA and low-level metrics per image, the stats
    test per metric, FID/KID/ISC with the full-width Inception-v3 (299 px,
    2048-d features, 1008 classes, random weights from seed 0). (b)
    Inception's features on 2 images, card against CPU in float32 with TF32
    off: ``INCEPTION_RTOL`` of the largest entry. (c) The evaluation report
    at ``--scale sd --limit REPORT_IMAGES`` with ``REPORT_STEPS`` edit steps
    (cut from 100), ``REPORT_DIFF_STEPS`` diffusion steps (cut from 50) and
    ``REPORT_NTO_STEPS`` null-text inner steps (cut from 10), float32. It
    runs at 512 px, where the diffusion attention attends over 4096
    positions, below the gate, so it launches no K2 kernel; its parametric
    edit renders with the separate ops, so no K1. Returns the K1/K2 launch
    counts of (a) and (c)."""
    import shutil

    from rgie_tpu_torch.cli import process_result_images, run_eval_report
    from rgie_tpu_torch.models.inception import create_inception, preprocess

    folder = os.path.join(work, "results")
    os.makedirs(folder, exist_ok=True)
    for name in sorted(os.listdir(outputs_dir)):
        stem = name[:-len(".jpg")]
        shutil.copy(os.path.join(originals_dir, name), os.path.join(folder, f"{stem}_o.jpg"))
        shutil.copy(os.path.join(outputs_dir, name), os.path.join(folder, f"{stem}_custom.jpg"))
    reset_kernel_launches()
    t0 = time.perf_counter()
    analysis = process_result_images.main([folder, "--fid", "--device", str(device)])
    torch.cuda.synchronize()
    counts = kernel_launches()
    q = analysis.quality["custom"]
    print(f"process_result_images --fid on {len(os.listdir(folder))} images: "
          f"{time.perf_counter() - t0:.1f} s (the FID's 2048 x 2048 matrix square root on the "
          f"host included); FID {q['frechet_inception_distance']:.6g}, KID "
          f"{q['kernel_inception_distance_mean']:.6g} +- {q['kernel_inception_distance_std']:.3g}, "
          f"ISC {q['inception_score_mean']:.6g} +- {q['inception_score_std']:.3g}; stats tests: "
          + "; ".join(f"{m} {r['test']} p={r['p_value']:.4g}" for m, r in analysis.stats.items())
          + f"; K1/K2 launches {counts}; on {card}")
    check(len(analysis.table["method"]) == 2 * TRANS_IMAGES, "analysis: scored images")
    check(set(analysis.stats) == {"valence", "arousal", "saturation", "bright", "colorful",
                                  "light", "contrast", "blur"}, "analysis: stats tests")
    check(all(np.isfinite(v) for v in q.values()), "analysis: non-finite FID/KID/ISC")
    check(counts == (0, 0, 0, 0), f"the analysis launched K1/K2: {counts}")

    model = create_inception(torch.Generator().manual_seed(0))
    x = torch.from_numpy(rng.uniform(0, 1, (2, OUTPUT_SIZE, OUTPUT_SIZE, 3)).astype(np.float32))
    with torch.no_grad():
        f_cpu, l_cpu = model(preprocess(x))
        f_card, l_card = (t.cpu() for t in model.to(device)(preprocess(x.to(device))))
    errs = rel_err(f_card, f_cpu), rel_err(l_card, l_cpu)
    print(f"Inception-v3 (1008 classes), 2 images {OUTPUT_SIZE} px -> 299, float32: card against "
          f"CPU features {errs[0]:.3e}, logits {errs[1]:.3e} of the largest entry (limit "
          f"{INCEPTION_RTOL:g}); features {tuple(f_card.shape)}, largest {float(f_cpu.abs().max()):.3e}")
    check(f_card.shape == (2, 2048) and l_card.shape == (2, 1008), "Inception: shapes")
    check(max(errs) <= INCEPTION_RTOL, "Inception: card disagrees with the CPU")
    del model
    torch.cuda.empty_cache()

    out = os.path.join(work, "eval_report")
    reset_kernel_launches()
    t0 = time.perf_counter()
    report = run_eval_report.main([
        "--scale", REPORT_SCALE, "--limit", str(REPORT_IMAGES), "--steps", str(REPORT_STEPS),
        "--diff-steps", str(REPORT_DIFF_STEPS), "--nto-steps", str(REPORT_NTO_STEPS),
        "--out-dir", out, "--device", str(device)])
    torch.cuda.synchronize()
    report_counts = kernel_launches()
    print(f"run_eval_report --scale {REPORT_SCALE} --limit {REPORT_IMAGES}, {REPORT_STEPS} edit steps, "
          f"{REPORT_DIFF_STEPS} diffusion steps, {REPORT_NTO_STEPS} null-text inner steps: "
          f"{time.perf_counter() - t0:.1f} s (edits {report['edit_seconds']} s, models built on "
          f"the host included); VA delta vs target {report['va_delta_vs_target']}; quality "
          f"{report['quality_vs_original']}; K1/K2 launches {report_counts}; on {card}")
    images = os.listdir(os.path.join(out, "images"))
    check(len(images) == 4 * REPORT_IMAGES, "eval report: outputs")
    check(all(np.all(np.isfinite(v)) for v in report["va_delta_vs_target"].values()),
          "eval report: VA deltas")
    check(set(report["quality_vs_original"]) == {"param", "gan", "diff"} and all(
        np.isfinite(v) for q in report["quality_vs_original"].values() for v in q.values()),
        "eval report: quality")
    check(report_counts == (0, 0, 0, 0), f"the eval report launched K1/K2: {report_counts}")
    return counts, report_counts


def write_feed(root, rng, n, size):
    """A captions feed of ``n`` random ``size`` px JPEGs: images/ and
    annotations/captions.json."""
    from PIL import Image

    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    for i in range(n):
        Image.fromarray((rng.uniform(0, 1, (size, size, 3)) * 255).astype(np.uint8)).save(
            os.path.join(root, "images", f"{i + 1:012d}.jpg"))
    with open(os.path.join(root, "annotations", "captions.json"), "w") as f:
        json.dump({str(i + 1): f"a random image {i}" for i in range(n)}, f)
    return root


class Recorder:
    """While active, records in this process what the slice F CLIs edit and
    write: the parametric CLI's ``edit_batch`` outputs and seconds, the GAN
    edit's outputs and seconds, the diffusion CLI's batches, the training
    CLI's state, and the name of every JPEG and ``torch.save`` file."""

    def __init__(self):
        self.saved, self.rows, self.seconds, self.batches, self.states = [], [], [], [], []
        self.best_steps, self.losses = [], []
        self._undo = []

    def _patch(self, owner, name, value):
        self._undo.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def __enter__(self):
        from PIL import Image

        from rgie_tpu_torch.cli import adapt_images, optimize_image_param
        from rgie_tpu_torch.engine import gan as GE
        from rgie_tpu_torch.training import train_midu

        save, torch_save = Image.Image.save, torch.save
        edit_batch, make_gan_edit = optimize_image_param.edit_batch, GE.make_batched_edit
        adapt_batches, shard = adapt_images.adapt_batches, train_midu.shard_train_step

        def image_save(img, fp, *a, **k):
            self.saved.append(os.path.basename(str(fp)))
            return save(img, fp, *a, **k)

        def file_save(obj, f, *a, **k):
            self.saved.append(os.path.basename(str(f)))
            return torch_save(obj, f, *a, **k)

        def param_edit(*a, **k):
            out = edit_batch(*a, **k)
            self.rows.append(out.outputs.cpu().numpy())
            self.best_steps += out.result.best_step.tolist()
            self.losses.append(out.result.losses.cpu().numpy())
            self.seconds.append(out.edit_seconds)
            return out

        def gan_edit(*a, **k):
            edit = make_gan_edit(*a, **k)

            def run(*args):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                result, edited = edit(*args)
                torch.cuda.synchronize()
                self.seconds.append(time.perf_counter() - t0)
                self.rows.append(edited.cpu().numpy())
                self.best_steps += result.best_step.tolist()
                self.losses.append(result.losses.cpu().numpy())
                return result, edited
            return run

        def diffusion_batches(*a, **k):
            done = adapt_batches(*a, **k)
            for names, out, log, seconds in done:
                self.batches.append((names, out.edited.cpu().numpy(), log.nto_inner_steps))
                self.seconds.append(seconds)
            return done

        def shard_train_step(state):
            self.states.append(state)
            return shard(state)

        self._patch(Image.Image, "save", image_save)
        self._patch(torch, "save", file_save)
        self._patch(optimize_image_param, "edit_batch", param_edit)
        self._patch(GE, "make_batched_edit", gan_edit)
        self._patch(adapt_images, "adapt_batches", diffusion_batches)
        self._patch(train_midu, "shard_train_step", shard_train_step)
        return self

    def __exit__(self, *exc):
        for owner, name, value in reversed(self._undo):
            setattr(owner, name, value)


def slice_f_argv(kind, work, tag, midu_path):
    """The argv of a slice F CLI run: its feed under ``work``, its outputs
    under ``work/f_<kind>_<tag>``, random weights from seed 0."""
    out = os.path.join(work, f"f_{kind}_{tag}")
    common = ["--out-dir", out, "--device", "cuda", "--seed", "0"]
    none = os.path.join(REPO, "build", "no_checkpoint")
    return {
        "param": ["--data-dir", os.path.join(work, "f_param_feed"), "--num-steps",
                  str(F_PARAM_STEPS), "--batch", str(F_PARAM_BATCH), "--output-size",
                  str(OUTPUT_SIZE), "--adaptations", f"smoke:{ALPHA}", "--va-model", none],
        "train": ["--scale", "sd", "--epochs", "1", "--num-batches", "2", "--val-batches", "1",
                  "--batch-size", str(F_TRAIN_BATCH)],
        "diffusion": ["--scale", "sd", "--input-size", str(DIFFUSION_SIZE), "--num-steps",
                      str(F_DIFF_STEPS), "--batch", str(F_DIFF_BATCH), "--cfg-scale",
                      str(CFG_SCALE), "--clf-scale", str(CLF_SCALE), "--reference-value",
                      str(REFERENCE_VALUE), "--midu-ckpt", midu_path, "--data-dir",
                      os.path.join(work, "f_diffusion_feed")],
        "gan": ["--data-dir", os.path.join(work, "f_gan_feed"), "--num-steps", str(F_GAN_STEPS),
                "--input-size", str(F_GAN_SIZE), "--batch", str(F_GAN_BATCH), "--adaptations",
                f"smoke:{ALPHA}", "--va-model", none, "--munit-model", none],
    }[kind] + common


def run_slice_f_cli(kind, work, tag, midu_path):
    """One slice F CLI in this process: seconds (the models' build
    included), edit seconds, peak memory, K1/K2 launches and what
    ``Recorder`` saw (the trained midu's parameters in place of its state)."""
    from rgie_tpu_torch.cli import (adapt_images, optimize_image_imaginaire,
                                    optimize_image_param, train_guidance_clf)

    main = {"param": optimize_image_param.main, "train": train_guidance_clf.main,
            "diffusion": adapt_images.main, "gan": optimize_image_imaginaire.main}[kind]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_launches()
    t0 = time.perf_counter()
    with Recorder() as rec:
        main(slice_f_argv(kind, work, tag, midu_path))
    torch.cuda.synchronize()
    run = {"seconds": time.perf_counter() - t0, "peak": torch.cuda.max_memory_allocated(),
           "launches": kernel_launches(), "saved": rec.saved, "rows": rec.rows,
           "best_steps": rec.best_steps, "losses": rec.losses, "edit_seconds": sum(rec.seconds),
           "batches": rec.batches}
    if rec.states:
        run["midu"] = {k: v.detach().cpu().numpy() for k, v in
                       rec.states[0].model.state_dict().items()}
    return run


def slice_f_ddp(feats, labels, device):
    """One DDP step of a SD-width midu on this rank's rows of ``feats``; rank
    1 starts from other weights, which ``shard_train_step``'s broadcast
    replaces. Returns the parameters and the averaged gradients, flat, and
    the mean loss."""
    from rgie_tpu_torch import parallel as PAR
    from rgie_tpu_torch.config import TrainGuidanceConfig
    from rgie_tpu_torch.training import create_train_state
    from rgie_tpu_torch.training.train_midu import shard_train_step

    rank, world = PAR.process_info()
    midu = slice_f_midu()
    with torch.no_grad():
        for p in midu.parameters():
            p.add_(rank)
    step, state = shard_train_step(create_train_state(midu.to(device), TrainGuidanceConfig()))
    rows = slice(rank * len(feats) // world, (rank + 1) * len(feats) // world)
    state, loss, _ = step(state, torch.from_numpy(feats[rows]).to(device),
                          torch.from_numpy(labels[rows]).to(device))
    params = torch.cat([p.detach().flatten() for p in state.model.parameters()]).cpu().numpy()
    grads = torch.cat([p.grad.flatten() for p in state.model.parameters()]).cpu().numpy()
    return params, grads, float(loss)


def slice_f_midu():
    from rgie_tpu_torch.models.midu import create_midu

    return create_midu(torch.Generator().manual_seed(6), in_channels=1280)


def slice_f_rank(work, midu_path, feats, labels):
    """One rank of phase 22: the DDP step, then the four CLIs."""
    from rgie_tpu_torch import parallel as PAR

    device = PAR.process_device("cuda")
    out = {"device": str(device), "ddp": slice_f_ddp(feats, labels, device)}
    for kind in ("param", "train", "diffusion", "gan"):
        out[kind] = run_slice_f_cli(kind, work, f"rank{PAR.process_info()[0]}", midu_path)
        torch.cuda.empty_cache()
    return out


def nccl_probe():
    """One all-reduce and one barrier in a one-rank NCCL group."""
    import torch.distributed as dist

    x = torch.full((4,), 3.0, device="cuda")
    dist.all_reduce(x)
    dist.barrier()
    torch.cuda.synchronize()
    return dist.get_backend(), x.cpu().tolist()


def slice_f_diffusion_reference(args, stack, work, rng, midu_path):
    """Phase 22's one-process diffusion runs, made after phase 16 on phase 7's
    stack (the weights the diffusion CLI builds from seed 0 with phase 15's
    midu): ``adapt_batches`` on a feed of ``F_DIFF_BATCH`` random 1024 px
    JPEGs at ``F_DIFF_STEPS`` DDIM steps, at ``--batch F_DIFF_BATCH`` (the
    run a rank's row is held to) and at ``--batch 1`` (what each rank runs),
    through ``Recorder``. Returns the first run's fields and, under
    ``batch1``, the second's batches."""
    import dataclasses

    from rgie_tpu_torch.cli import adapt_images as cli
    from rgie_tpu_torch.diffusion import schedulers as SCH

    feed = write_feed(os.path.join(work, "f_diffusion_feed"), rng, F_DIFF_BATCH, DIFFUSION_SIZE)
    args = cli.build_parser().parse_args(slice_f_argv("diffusion", work, "single", midu_path))
    check(args.data_dir == feed, "slice F diffusion feed")
    stack = stack._replace(pipe=dataclasses.replace(stack.pipe,
                                                    sched=SCH.make_schedule(args.num_steps)))
    gcfg, acfg = cli.make_configs(args)
    adapter, items = cli.make_adapter(stack), cli.feed_items(feed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_launches()
    t0 = time.perf_counter()
    with Recorder() as rec:
        cli.adapt_batches(args, stack, adapter, items, gcfg, acfg, args.out_dir)
    torch.cuda.synchronize()
    run = {"seconds": time.perf_counter() - t0, "peak": torch.cuda.max_memory_allocated(),
           "launches": kernel_launches(), "saved": rec.saved, "edit_seconds": sum(rec.seconds),
           "batches": rec.batches}
    args.batch = 1
    with Recorder() as rec:
        cli.adapt_batches(args, stack, adapter, items, gcfg, acfg, args.out_dir + "_batch1")
    run["batch1"] = rec.batches
    return run


def slice_f_phase(device, work, rng, card, midu_path, train_single, diffusion_single):
    """Phase 22, slice F: the four CLIs over two ranks that share the card in
    a gloo group, against one process at the same global batch (the
    parametric and GAN runs made here; the diffusion run after phase 16;
    training is phase 15's run), then a one-rank NCCL group. Returns the K1
    and K2 launch counts by path."""
    from rgie_tpu_torch import parallel as PAR
    from rgie_tpu_torch.config import TrainGuidanceConfig
    from rgie_tpu_torch.training import create_train_state, make_train_step

    t_phase = time.perf_counter()
    write_feed(os.path.join(work, "f_param_feed"), rng, F_PARAM_BATCH, EDIT_SIZE)
    write_feed(os.path.join(work, "f_gan_feed"), rng, F_GAN_BATCH, F_GAN_SIZE)
    feats = rng.standard_normal((F_TRAIN_BATCH, 8, 8, 1280)).astype(np.float32)
    labels = rng.uniform(0, 1, (F_TRAIN_BATCH, 2)).astype(np.float32)
    single = {kind: run_slice_f_cli(kind, work, "single", midu_path) for kind in ("param", "gan")}
    single.update(train=train_single, diffusion=diffusion_single)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = PAR.spawn_ranks(slice_f_rank, F_RANKS, work, midu_path, feats, labels,
                            backend="gloo", timeout=600)
    ranks_s = time.perf_counter() - t0

    images = {"param": F_PARAM_BATCH, "diffusion": F_DIFF_BATCH, "gan": F_GAN_BATCH}
    for kind in ("param", "train", "diffusion", "gan"):
        runs = [("one process", single[kind])] + [(f"rank {r}", ranks[r][kind])
                                                  for r in range(F_RANKS)]
        print(f"slice F {kind}: " + "; ".join(
            f"{who} {run['seconds']:.2f} s with the models' build"
            + (f", edit {run['edit_seconds']:.3f} s = "
               f"{images[kind] // (1 if who == 'one process' else F_RANKS) / run['edit_seconds']:.4f} img/s"
               if run.get("edit_seconds") else "")
            + (f", peak {run['peak'] / 2**30:.2f} GiB" if run.get("peak") else "")
            for who, run in runs) + f" (two ranks share one card: overhead and contention, not "
                                    f"scaling); on {card}")
    check([r["device"] for r in ranks] == ["cuda:0"] * F_RANKS, "slice F: ranks' devices")

    # (a) the parametric CLI: rank r edits images r, r + 2; K1 once per image
    names = [f"{i + 1:012d}_smoke.jpg" for i in range(F_PARAM_BATCH)]
    expect = np.concatenate(single["param"]["rows"])
    first = np.concatenate(single["param"]["losses"])[:, 0]
    for r, rank in enumerate(ranks):
        mine = list(range(r, F_PARAM_BATCH, F_RANKS))
        got = np.concatenate(rank["param"]["rows"])
        err = float(np.abs(got - expect[mine]).max())
        e_first = float(np.abs(np.concatenate(rank["param"]["losses"])[:, 0] - first[mine]).max()
                        / np.abs(first).max())
        print(f"slice F parametric edit, rank {r}: images {[i + 1 for i in mine]}, rows against "
              f"the one-process batch-{F_PARAM_BATCH} rows {err:.3e} (limit {F_ROW_ATOL:g}), "
              f"first losses {e_first:.3e} of the largest (limit {MIDU_RTOL:g}); best steps "
              f"{rank['param']['best_steps']} (one process {single['param']['best_steps']}); "
              f"K1/K2 launches {rank['param']['launches']}; wrote {rank['param']['saved']}")
        check(got.shape == (len(mine), OUTPUT_SIZE, OUTPUT_SIZE, 3), "slice F param rows")
        check(err <= F_ROW_ATOL, f"slice F parametric rows of rank {r}")
        check(e_first <= MIDU_RTOL, f"slice F parametric first losses of rank {r}")
        check(rank["param"]["launches"] == (len(mine), 0, 0, 0), f"slice F K1 launches, rank {r}")
        check(rank["param"]["saved"] == [names[i] for i in mine], f"slice F param outputs, rank {r}")
    check(single["param"]["launches"] == (F_PARAM_BATCH, 0, 0, 0), "slice F one-process K1")
    check(sorted(single["param"]["saved"]) == names, "slice F one-process param outputs")

    # (b) training: one midu on both ranks, rank 0 alone writes; the DDP step
    midus = [rank["train"]["midu"] for rank in ranks]
    check(all(np.array_equal(midus[0][k], midus[1][k]) for k in midus[0]),
          "slice F training: the ranks' midus differ")
    check("best.pt" in ranks[0]["train"]["saved"] and not ranks[1]["train"]["saved"],
          "slice F training: checkpoint writers")
    (p0, g0, l0), (p1, g1, l1) = (rank["ddp"] for rank in ranks)
    check(np.array_equal(p0, p1) and np.array_equal(g0, g1) and l0 == l1,
          "slice F DDP step: the ranks differ")
    cfg = TrainGuidanceConfig()
    midu = slice_f_midu()
    p_init = torch.cat([p.detach().flatten() for p in midu.parameters()])
    state, loss, _ = make_train_step()(create_train_state(midu.to(device), cfg),
                                       torch.from_numpy(feats).to(device),
                                       torch.from_numpy(labels).to(device))
    p_one = torch.cat([p.detach().flatten() for p in state.model.parameters()]).cpu()
    g_one = torch.cat([p.grad.flatten() for p in state.model.parameters()]).cpu()
    g_eff = (g_one + cfg.weight_decay * p_init).abs()
    settled = g_eff > MIDU_SETTLED * g_eff.max()
    apart = (torch.from_numpy(p0) - p_one).abs()[settled]
    e_grad = rel_err(torch.from_numpy(g0), g_one)
    print(f"slice F DDP midu step ({F_TRAIN_BATCH} rows of (8, 8, 1280) features, "
          f"{F_TRAIN_BATCH // F_RANKS} a rank) against one process on all: loss {l0:.7f} vs "
          f"{float(loss):.7f}, gradients {e_grad:.3e} of the largest entry (limit "
          f"{MIDU_RTOL:g}); updates at the {int(settled.sum())} of {p_one.numel()} settled "
          f"entries apart by at most {float(apart.max()):.3e} (limit a hundredth of lr and a "
          f"rounding); the ranks bit-identical; the training CLI's midus bit-identical, "
          f"checkpoint written by rank 0 only")
    check(abs(l0 - float(loss)) <= MIDU_RTOL * abs(float(loss)), "slice F DDP loss")
    check(e_grad <= MIDU_RTOL, "slice F DDP gradients")
    check(bool((apart <= 1e-2 * cfg.learning_rate + p_init.abs()[settled] * 2.0 ** -23).all()),
          "slice F DDP updates")

    # (c) the diffusion CLI: rank r edits image r + 1 alone
    def by_name(batches):
        return {n: row for names_, rows, _ in batches for n, row in zip(names_, rows)}

    expect, expect1 = by_name(single["diffusion"]["batches"]), by_name(single["diffusion"]["batch1"])
    rows2 = list(expect.values())
    across = float(np.abs(rows2[0] - rows2[1]).mean())
    k2_by_rank = []
    for r, rank in enumerate(ranks):
        (names_, rows, inner), = rank["diffusion"]["batches"]
        counts = rank["diffusion"]["launches"][1:]
        want_fwd, want_bwd = expected_flash_launches(F_DIFF_STEPS, inner)
        apart = np.abs(rows[0] - expect[names_[0]])
        again = np.abs(rows[0] - expect1[names_[0]])
        print(f"slice F diffusion edit, rank {r}: {names_}, K2 launches {counts}, expected "
              f"({want_fwd}, {want_bwd}, {want_bwd}); row against the one-process batch-"
              f"{F_DIFF_BATCH} row: mean {float(apart.mean()):.3e} (limit {F_DIFF_ATOL:g}), max "
              f"{float(apart.max()):.3e}, 99.9th percentile {float(np.quantile(apart, 0.999)):.3e}; "
              f"against the one-process batch-1 edit of its image (the same program run again): "
              f"mean {float(again.mean()):.3e}, max {float(again.max()):.3e}; the two images' "
              f"one-process rows apart by {across:.3e} on average; wrote "
              f"{rank['diffusion']['saved']}")
        check(names_ == [f"{r + 1:012d}.jpg"], f"slice F diffusion items, rank {r}")
        check(counts == (want_fwd, want_bwd, want_bwd), f"slice F K2 launches, rank {r}")
        check(bool(np.isfinite(rows).all()) and float(apart.mean()) <= F_DIFF_ATOL,
              f"slice F diffusion row {r}")
        check(rank["diffusion"]["saved"] == names_, f"slice F diffusion outputs, rank {r}")
        k2_by_rank.append(counts)

    # (d) the GAN CLI: the loss trajectories, then the rows
    expect = np.concatenate(single["gan"]["rows"])
    losses = np.concatenate(single["gan"]["losses"])
    across = float(np.abs(expect[0] - expect[1]).mean())
    for r, rank in enumerate(ranks):
        mine = list(range(r, F_GAN_BATCH, F_RANKS))
        got = np.concatenate(rank["gan"]["rows"])
        err = float(np.abs(got - expect[mine]).max())
        e_loss = float(np.abs(np.concatenate(rank["gan"]["losses"]) - losses[mine]).max()
                       / np.abs(losses).max())
        print(f"slice F GAN edit, rank {r}: loss trajectories against the one-process ones "
              f"{e_loss:.3e} of the largest (limit {MIDU_RTOL:g}), rows {err:.3e} (limit "
              f"{F_GAN_ROW_ATOL:g}; two images' edits {across:.3e} apart on average); best steps "
              f"{rank['gan']['best_steps']} (one process "
              f"{single['gan']['best_steps']}); K1/K2 launches {rank['gan']['launches']}")
        check(e_loss <= MIDU_RTOL, f"slice F GAN loss trajectories of rank {r}")
        check(got.shape == (len(mine), F_GAN_SIZE, F_GAN_SIZE, 3) and err <= F_GAN_ROW_ATOL,
              f"slice F GAN rows of rank {r}")
        check(rank["gan"]["saved"] == [names[i] for i in mine], f"slice F GAN outputs, rank {r}")

    # (e) NCCL starts
    backend, value = PAR.spawn_ranks(nccl_probe, 1, backend="nccl", timeout=300)[0]
    print(f"slice F one-rank NCCL group: backend {backend}, all-reduce {value}, barrier passed "
          f"(NCCL over several cards is unverified: the machine has one)")
    check(backend == "nccl" and value == [3.0] * 4, "slice F NCCL probe")
    print(f"phase 22: {time.perf_counter() - t_phase:.1f} s (the two ranks {ranks_s:.1f} s)")
    return {"k1": {f"slice F parametric edit, rank {r}": ranks[r]["param"]["launches"][0]
                   for r in range(F_RANKS)} | {
                       "slice F parametric edit, one process": single["param"]["launches"][0]},
            "k2": {f"slice F diffusion edit, rank {r}": k2_by_rank[r] for r in range(F_RANKS)} | {
                "slice F diffusion edit, one process": single["diffusion"]["launches"][1:]}}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    sys.path.insert(0, REPO)
    from rgie_tpu_torch.cli import optimize_image_param as cli
    from rgie_tpu_torch.cli.bench_fused_chain import draw_params
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
    midu_path, train_single = training_cli_phase(work, card)
    load_checkpoint_phase(edit_args, stack, midu_path)
    counts_batch = batched_path_phase(edit_args, stack, work, rng, card, single_s, single_peak)
    torch.cuda.empty_cache()
    # phase 22's one-process diffusion run, on the same weights (its own rng
    # keeps the later phases' inputs)
    rng_f = np.random.default_rng(22)
    diffusion_single = slice_f_diffusion_reference(edit_args, stack, work, rng_f, midu_path)
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
    torch.cuda.empty_cache()

    # ---- 19-21. the dataset transform run (K1 at its batch of 12), EmoNet
    # through --va-model, the analysis CLIs
    t0 = time.perf_counter()
    trans, originals_dir, outputs_dir = run_img_trans_phase(device, work, rng, card)
    print(f"phase 19: {time.perf_counter() - t0:.1f} s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    counts_emonet = emonet_phase(device, work, rng, card)
    print(f"phase 20: {time.perf_counter() - t0:.1f} s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    counts_analysis, counts_report = analysis_phase(device, work, originals_dir, outputs_dir,
                                                    rng, card)
    print(f"phase 21: {time.perf_counter() - t0:.1f} s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.empty_cache()

    # ---- 22. slice F: two ranks on the card against one process, and NCCL
    counts_f = slice_f_phase(device, work, rng_f, card, midu_path, train_single, diffusion_single)

    paths = {"float32 edit": counts_f32, "bfloat16 edit": counts_bf16, "SDXL edit": counts_sdxl,
             "batched edit": counts_batch, "ControlNet": counts_cn,
             "SDXL midu training": counts_train, "run_img_trans": trans["launches"][1:],
             "EmoNet parametric edit": counts_emonet[1:],
             "process_result_images": counts_analysis[1:],
             "eval report": counts_report[1:], **counts_f["k2"]}
    for i, entry in enumerate(k2_entries):
        entry["launches"] = sum(counts[i] for counts in paths.values())
        entry["launches_by_path"] = {name: counts[i] for name, counts in paths.items()}
    k1_paths = {"parametric edit": launches, "run_img_trans": trans["launches"][0],
                "EmoNet parametric edit": counts_emonet[0],
                "process_result_images": counts_analysis[0],
                "eval report": counts_report[0], **counts_f["k1"]}
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": [{
        "name": "pointwise_chain", "route": "cuda",
        "source": "rgie_tpu_torch/csrc/pointwise_chain.cu",
        "replaces": "rgie_tpu/ops/pallas/pointwise_chain.py:38",
        "replaces_function": "_prefix_kernel",
        "launches": sum(k1_paths.values()), "launches_by_path": k1_paths,
        "max_abs_err": max(errors + [trans["max_abs_err"]]), "timed_shape": list(timed_shape),
        "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "device_ms": device_times[timed_shape], "one_image_ms": times[one_image][0],
        "one_image_plain_ms": times[one_image][1], "one_image_device_ms": device_times[one_image],
        "bound_ms": k1_bound_ms, "bound_by": k1_bound_by, "library_ms": None,
        "run_img_trans_shape": trans["shape"], "run_img_trans_ms": trans["ms"],
        "run_img_trans_device_ms": trans["device_ms"], "run_img_trans_plain_ms": trans["plain_ms"],
        "run_img_trans_bound_ms": trans["bound_ms"],
    }] + k2_entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
