"""Parametric pixel-space editing CLI on PyTorch — port of
``scripts/optimize_image_param.py`` (reference entry point
src/optimize_image_param.py; flags replace its constant block at :30-59).

    python -m rgie_tpu_torch.cli.optimize_image_param --data-dir DIR --device cuda

Per adaptation alpha, each batch of ``--batch`` images is edited in lockstep
(``edit_batch``: edit, evaluate, re-render at ``--output-size`` through the
fused pointwise kernel). Runs on one device; ``--device cuda`` fails when
CUDA is missing, and the CPU is used only for ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from rgie_tpu_torch.config import OptimizeConfig, ParamEditConfig
from rgie_tpu_torch.engine import parametric as P
from rgie_tpu_torch.engine.optimize import OptResult
from rgie_tpu_torch.ops import chain as CH


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data-dir", default=None, help="dataset root (captions.json feed)")
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--va-model", default=None, help="torch va_pred_all checkpoint")
    ap.add_argument("--num-steps", type=int, default=300)
    ap.add_argument("--learning-rate", type=float, default=0.05)
    ap.add_argument("--weight-clf", type=float, default=0.15)
    ap.add_argument("--weight-recon", type=float, default=1.0)
    ap.add_argument("--weight-dis", type=float, default=0.0,
                    help="realism term weight (reference: optimize_image_param.py:91-98,315-330)")
    ap.add_argument("--dis-model", default=None,
                    help="torch pixel-discriminator checkpoint (imagenet_w0_high_lookhere_dis)")
    ap.add_argument("--input-size", type=int, default=480)
    ap.add_argument("--crop-size", type=int, default=480)
    ap.add_argument("--va-input-size", type=int, default=480,
                    help="VA regressor resize (reference ten-crop 480/448)")
    ap.add_argument("--va-crop-size", type=int, default=448)
    ap.add_argument("--output-size", type=int, default=1024,
                    help="full-resolution re-render size (reference output_transform, "
                         "optimize_image_param.py:77-81,295-312); 0 disables")
    ap.add_argument("--batch", type=int, default=1, help="images edited in lockstep")
    ap.add_argument("--limit", type=int, default=500, help="dataset cap (reference: optimize_image.py:25)")
    ap.add_argument("--adaptations", default="pos_01:0.1,pos_02:0.2,neg_01:-0.1,neg_02:-0.1,neutral:0.0")
    ap.add_argument("--gradient-free", action="store_true", help="Nelder-Mead instead of Adam")
    ap.add_argument("--gf-maxiter", type=int, default=None, help="Nelder-Mead iteration cap")
    ap.add_argument("--save-orig", action="store_true")
    ap.add_argument("--remat", action="store_true",
                    help="recompute the objective's forwards on backward (bigger batches)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def parse_adaptations(spec: str) -> List[Tuple[str, Tuple[float, float]]]:
    """"name:a" applies a to both VA dims; "name:v:a" sets them separately."""
    out = []
    for item in spec.split(","):
        parts = item.split(":")
        v = float(parts[1])
        a = float(parts[2]) if len(parts) > 2 else v
        out.append((parts[0], (v, a)))
    return out


def build_models(args, generator: torch.Generator, device: torch.device) -> P.EditModels:
    """The frozen VA loss, CLIP encoder and (with ``--weight-dis``) pixel
    discriminator: checkpoints where the paths exist, else random stand-ins
    drawn from ``generator``."""
    from rgie_tpu_torch.config import MODELS_DIR
    from rgie_tpu_torch.models.clip import create_clip_image_encoder
    from rgie_tpu_torch.models.loader import load_va_loss

    va_path = args.va_model or str(MODELS_DIR / "va_pred_all")
    va_loss = load_va_loss(va_path, generator, is_input_range_0_1=True,
                           input_size=args.va_input_size, crop_size=args.va_crop_size)
    clip_enc = create_clip_image_encoder(generator) if args.weight_recon > 0 else None
    dis = None
    if args.weight_dis > 0:
        from rgie_tpu_torch.models.discriminators import PixelDiscriminator
        from rgie_tpu_torch.models.init import freeze_, random_init_

        dis = PixelDiscriminator(size_w=args.crop_size, size_h=args.crop_size)
        dis_path = args.dis_model or str(MODELS_DIR / "imagenet_w0_high_lookhere_dis")
        if os.path.exists(dis_path):
            from rgie_tpu_torch.utils.checkpoint import load_torch_state_dict

            dis.load_state_dict(load_torch_state_dict(dis_path), strict=True)
            print(f"loaded pixel discriminator from {dis_path}")
        else:
            random_init_(dis, generator)
            print(f"WARNING: {dis_path} not found; random-weight discriminator stand-in")
        dis = freeze_(dis)
    return P.EditModels(va_loss=va_loss.to(device),
                        clip=clip_enc.to(device) if clip_enc is not None else None,
                        dis=dis.to(device) if dis is not None else None)


def make_config(args) -> ParamEditConfig:
    return ParamEditConfig(
        optimize=OptimizeConfig(num_steps=args.num_steps, learning_rate=args.learning_rate),
        weight_clf=args.weight_clf, weight_recon=args.weight_recon,
        weight_dis=args.weight_dis, input_size=args.input_size, crop_size=args.crop_size,
        output_size=args.output_size, remat=args.remat)


class BatchOutput(NamedTuple):
    result: OptResult     # per image, see engine.optimize.OptResult
    metrics: dict         # per image: va_original, va_adapted, va_delta, rec_error
    outputs: torch.Tensor  # (B, S, S, 3): re-rendered at the output size, else the edits
    edit_seconds: float   # the Adam edit alone, device-synchronised


def edit_batch(models: P.EditModels, cfg: ParamEditConfig, images: torch.Tensor,
               alpha: Sequence[float], full_images: Optional[torch.Tensor] = None
               ) -> BatchOutput:
    """One batch of the CLI: edit (B, H, W, 3) images toward VA + alpha, then
    evaluate, then re-render each ``full_images[b]`` with its optimized
    vector through ``edit_image_fused`` (reference output_transform,
    optimize_image_param.py:295-312)."""
    alphas = torch.as_tensor(alpha, dtype=images.dtype, device=images.device)
    alphas = alphas.expand(images.shape[0], -1)
    sync = torch.cuda.synchronize if images.device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    result, edited = P.make_batched_edit(models, cfg)(images, alphas)
    sync()
    seconds = time.perf_counter() - t0
    metrics = P.make_evaluate(models.va_loss)(images, edited)
    outputs = edited if full_images is None else rerender(cfg, full_images, result.best_x)
    return BatchOutput(result=result, metrics=metrics, outputs=outputs, edit_seconds=seconds)


@torch.no_grad()
def rerender(cfg: ParamEditConfig, full_images: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Re-apply each image's optimized vector to its output-size original, one
    image at a time, through the fused pointwise kernel."""
    return torch.cat([CH.edit_image_fused(full_images[b:b + 1], xs[b], input_size=cfg.crop_size,
                                          order=cfg.transforms)
                      for b in range(full_images.shape[0])])


def gradient_free_edit(models: P.EditModels, cfg: ParamEditConfig, image: torch.Tensor,
                       alpha: Sequence[float], maxiter: Optional[int]) -> torch.Tensor:
    """Nelder-Mead on one (1, H, W, 3) image (optimize_image.py:126-148);
    returns its optimized (1, 41) vector."""
    from rgie_tpu_torch.engine.optimize import optimize_gradient_free

    alphas = torch.as_tensor(alpha, dtype=image.dtype, device=image.device)[None]
    ctx = P.make_context(models, cfg, image, alphas)
    objective = P.make_objective(models, cfg)
    x0 = CH.pack_params(CH.init_params()).numpy()

    @torch.no_grad()
    def f(x: np.ndarray) -> float:
        return float(objective(torch.from_numpy(x).to(image.device)[None], ctx)[0])

    x_opt, _ = optimize_gradient_free(f, x0, maxiter=maxiter)
    return torch.from_numpy(x_opt).to(image.device)[None]


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    from rgie_tpu_torch.device import resolve_device

    device = resolve_device(args.device)

    from PIL import Image

    from rgie_tpu_torch.config import DATA_DIR, OUT_DIR
    from rgie_tpu_torch.data import (CaptionFeedDataset, iterate_batches, load_image_rgb,
                                     preprocess_image)
    from rgie_tpu_torch.utils import stats as S

    data_dir = args.data_dir or str(DATA_DIR)
    out_dir = args.out_dir or str(OUT_DIR / f"optimized_param_{args.weight_clf:<1.2f}")
    os.makedirs(out_dir, exist_ok=True)

    generator = torch.Generator().manual_seed(args.seed)
    models = build_models(args, generator, device)
    cfg = make_config(args)
    adaptations = parse_adaptations(args.adaptations)
    dataset = CaptionFeedDataset(data_dir)
    stats = {}

    for images_np, metas in iterate_batches(dataset, args.batch, args.input_size,
                                            args.crop_size, limit=args.limit):
        images = torch.from_numpy(images_np).to(device)
        full = None
        if args.output_size:
            full = torch.from_numpy(np.concatenate([
                preprocess_image(load_image_rgb(m[1]), args.output_size, args.output_size)
                for m in metas])).to(device)
        for name, alpha in adaptations:
            S.check_init_stats_adapt(stats, name)
            if args.gradient_free:
                t0 = time.perf_counter()
                xs = torch.cat([gradient_free_edit(models, cfg, images[b:b + 1], alpha,
                                                   args.gf_maxiter)
                                for b in range(images.shape[0])])
                with torch.no_grad():
                    edited = CH.edit_image(images, xs, input_size=cfg.crop_size,
                                           order=cfg.transforms)
                dt = time.perf_counter() - t0
                metrics = P.make_evaluate(models.va_loss)(images, edited)
                outputs = edited if full is None else rerender(cfg, full, xs)
            else:
                out = edit_batch(models, cfg, images, alpha, full)
                metrics, outputs, dt = out.metrics, out.outputs, out.edit_seconds
            metrics = {k: v.cpu().numpy() for k, v in metrics.items()}
            outputs = outputs.cpu().numpy()
            for b, meta in enumerate(metas):
                va0 = metrics["va_original"][b:b + 1]
                va1 = metrics["va_adapted"][b:b + 1]
                S.print_score(va1, f"{meta[0]} {name}", va0)
                S.record_edit(stats[name], va0, va1, float(metrics["rec_error"][b]))
                img_out = np.clip(outputs[b] * 255, 0, 255).astype(np.uint8)
                base = meta[0].replace(".jpg", "")
                Image.fromarray(img_out).save(os.path.join(out_dir, f"{base}_{name}.jpg"))
                if args.save_orig:
                    orig = np.clip(images_np[b] * 255, 0, 255).astype(np.uint8)
                    Image.fromarray(orig).save(os.path.join(out_dir, f"{base}_orig.jpg"))
            n = len(metas)
            print(f"[{name}] batch of {n} edited in {dt:.2f}s ({n / dt:.3f} img/s)")

    print(f"weight_clf: {args.weight_clf}; weight_dis: {args.weight_dis}; "
          f"weight_recon: {args.weight_recon}")
    S.print_stats(stats)


if __name__ == "__main__":
    main()
