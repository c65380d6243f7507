#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA GPU and check it.

    python3 chip_smoke.py

Phases (every check raises; nothing is caught):

1. Device: require CUDA; print the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them, with the torch, CUDA and Triton versions.
2. Kernels: build each kernel of the path from this checkout's source, run
   it on the card at the main path's shapes (K1: the re-render's
   (1, 1024, 1024, 3), the batch (4, 1024, 1024, 3) and a ragged
   (1, 1000, 760, 3)) and hold it against its plain PyTorch version (max abs
   error <= 2e-5, the tolerance of tests/test_pallas.py); time both at the
   1024 px shapes with CUDA events (3 warm-up runs, median of 20,
   alternating).
3. Main path: the parametric-edit CLI's per-batch function
   (``edit_batch``) on 4 random 480x480 images: ResNet-50 ten-crop 480/448
   regressor and CLIP ViT-B/32 at 224 with random weights from the seed, 100
   Adam steps, one adaptation (alpha 0.1), then evaluate, then the 1024 px
   re-render through kernel K1 (after a 2-step warm-up edit without the
   re-render). The launch counts are zeroed just before and
   read just after. Checks: every kernel launched, finite losses, best <=
   first loss per image, outputs in [0, 1]; the objective at image 0's last
   vector (rtol 1e-3) and its re-render (atol 1e-4) agree with the same
   computation on the CPU.
4. One JSON line ``{"kernels": [...]}``, then the last line
   ``{"ok": true, "device": {...}}``.

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


def time_pair(kernel, plain, warmup=3, reps=20):
    """Median milliseconds of ``kernel()`` and ``plain()``, timed with CUDA
    events in alternation on the current stream."""
    for _ in range(warmup):
        kernel()
        plain()
    times = {kernel: [], plain: []}
    for _ in range(reps):
        for fn in (kernel, plain):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[fn].append(start.elapsed_time(end))
    return float(np.median(times[kernel])), float(np.median(times[plain]))


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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    sys.path.insert(0, REPO)
    import triton

    from rgie_tpu_torch.cli import optimize_image_param as cli
    from rgie_tpu_torch.device import resolve_device
    from rgie_tpu_torch.ops import chain as CH
    from rgie_tpu_torch.ops.kernels import pointwise_chain as PC

    # ---- 1. device
    device = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, triton {triton.__version__}, "
          f"device {torch.cuda.get_device_name(0)}")

    # ---- 2. kernels against their plain versions: the batch of 4 at the
    # output size, the re-render's own one-image call, and a ragged shape
    rng = np.random.default_rng(0)
    errors, times = [], {}
    t0 = time.perf_counter()
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
            times[shape] = time_pair(lambda: PC.pointwise_chain(img, params),
                                     lambda: PC.reference_pointwise_chain(img, params))
            print(f"pointwise_chain {shape}: kernel {times[shape][0]:.4f} ms, plain "
                  f"{times[shape][1]:.4f} ms (median of 20, CUDA events) on {card}")
    kernel_ms, plain_ms = times[timed_shape]
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

    print(json.dumps({"kernels": [{
        "name": "pointwise_chain", "route": "triton",
        "source": "rgie_tpu_torch/ops/kernels/pointwise_chain_triton.py",
        "replaces": "rgie_tpu/ops/pallas/pointwise_chain.py:38",
        "replaces_function": "_prefix_kernel",
        "launches": launches, "max_abs_err": max(errors), "timed_shape": list(timed_shape),
        "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
