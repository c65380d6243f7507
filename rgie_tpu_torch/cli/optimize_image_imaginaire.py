"""MUNIT style-code editing CLI on PyTorch — port of
``scripts/optimize_image_imaginaire.py`` (reference entry point
src/optimize_image_imaginaire.py).

    python -m rgie_tpu_torch.cli.optimize_image_imaginaire --data-dir DIR --device cuda

Per adaptation alpha, each batch of ``--batch`` images (in [-1, 1]) has the
8-dim style codes of a frozen MUNIT autoencoder optimized in lockstep so the
decoded images reach VA(original) + alpha, with L1 content reconstruction;
then the edits are evaluated and saved as JPEGs. Missing checkpoints give
random-weight stand-ins with a WARNING. ``--device cuda`` fails when CUDA
is missing, and the CPU is used only for ``--device cpu``. Several processes
(``torchrun --nproc_per_node N``, one card each): ``--batch`` is the global
batch and must divide over them; rank p edits feed items p, p+N, ...
(``ShardedView``) and writes their outputs.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from rgie_tpu_torch.config import GanEditConfig, MunitGenConfig, OptimizeConfig
from rgie_tpu_torch.engine import gan as GE


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--va-model", default=None)
    ap.add_argument("--munit-model", default=None,
                    help="imaginaire .pt checkpoint (spectral norms folded on load)")
    ap.add_argument("--num-steps", type=int, default=300)
    ap.add_argument("--learning-rate", type=float, default=0.05)
    ap.add_argument("--weight-clf", type=float, default=0.2)
    ap.add_argument("--weight-recon", type=float, default=1.0)
    ap.add_argument("--weight-dis", type=float, default=0.0,
                    help="hinge realism term relu(-gan_loss) "
                         "(reference: optimize_image_imaginaire.py:132-137)")
    ap.add_argument("--input-size", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch, edited in lockstep (default: one per process)")
    ap.add_argument("--limit", type=int, default=500)
    ap.add_argument("--adaptations",
                    default="pos_01:0.1,pos_02:0.2,neg_01:-0.1,neg_02:-0.1,neutral:0.0")
    ap.add_argument("--remat", action="store_true",
                    help="recompute the objective's forwards on backward (bigger batches / 1024px)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def build_models(args, generator: torch.Generator, device: torch.device) -> GE.GanEditModels:
    """The VA loss on [-1, 1] images, MUNIT's domain-a autoencoder and (with
    ``--weight-dis``) its discriminator: checkpoints where the paths exist,
    else random stand-ins drawn from ``generator``."""
    from rgie_tpu_torch.config import MODELS_DIR
    from rgie_tpu_torch.models.loader import load_va_loss
    from rgie_tpu_torch.models.munit import create_generator

    va_path = args.va_model or str(MODELS_DIR / "va_pred_all")
    va_loss = load_va_loss(va_path, generator, is_input_range_0_1=False)
    munit_path = args.munit_model or str(MODELS_DIR / "imaginaire_munit_200000_s5.pt")
    dis = None
    if os.path.exists(munit_path):
        from rgie_tpu_torch.utils.checkpoint import load_munit_checkpoint

        gen, dis = load_munit_checkpoint(munit_path, MunitGenConfig(), args.weight_dis)
        print(f"loaded MUNIT generator from {munit_path}")
        if dis is not None:
            print("loaded MUNIT discriminator_a (weight_dis > 0)")
    else:
        gen = create_generator(generator, MunitGenConfig(), image_size=64).autoencoder_a
        print(f"WARNING: {munit_path} not found; random-weight MUNIT stand-in")
    if args.weight_dis > 0 and dis is None:
        from rgie_tpu_torch.models.discriminators import MultiResPatchDiscriminator
        from rgie_tpu_torch.models.init import freeze_, random_init_

        dis = freeze_(random_init_(MultiResPatchDiscriminator(), generator))
        print("WARNING: random-weight MUNIT discriminator stand-in")
    return GE.GanEditModels(generator=gen.to(device), va_loss=va_loss.to(device),
                            dis=dis.to(device) if dis is not None else None)


def make_config(args) -> GanEditConfig:
    return GanEditConfig(
        optimize=OptimizeConfig(num_steps=args.num_steps, learning_rate=args.learning_rate),
        weight_clf=args.weight_clf, weight_recon=args.weight_recon,
        weight_dis=args.weight_dis, input_size=args.input_size, crop_size=args.input_size,
        remat=args.remat)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    from rgie_tpu_torch.parallel import (create_hybrid_mesh, process_device, process_info,
                                         split_batch)

    local_batch = split_batch(args.batch or create_hybrid_mesh().size)
    device = process_device(args.device)
    pid, nproc = process_info()

    from PIL import Image

    from rgie_tpu_torch.cli.optimize_image_param import parse_adaptations
    from rgie_tpu_torch.config import DATA_DIR, OUT_DIR
    from rgie_tpu_torch.data import CaptionFeedDataset, ShardedView, iterate_batches
    from rgie_tpu_torch.engine import parametric as P
    from rgie_tpu_torch.utils import stats as S

    data_dir = args.data_dir or str(DATA_DIR)
    out_dir = args.out_dir or str(OUT_DIR / "imaginaire" / f"weight_{args.weight_clf:<1.2f}")
    os.makedirs(out_dir, exist_ok=True)

    models = build_models(args, torch.Generator().manual_seed(args.seed), device)
    cfg = make_config(args)
    edit = GE.make_batched_edit(models, cfg)
    evaluate = P.make_evaluate(models.va_loss)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    dataset = ShardedView(CaptionFeedDataset(data_dir), pid, nproc)
    stats = {}

    for images_np, metas in iterate_batches(dataset, local_batch, args.input_size,
                                            args.input_size, normalize=True,
                                            limit=dataset.local_count(args.limit)):
        images = torch.from_numpy(images_np).to(device)
        for name, alpha in parse_adaptations(args.adaptations):
            S.check_init_stats_adapt(stats, name)
            alphas = torch.as_tensor(alpha, dtype=images.dtype, device=device)
            sync()
            t0 = time.perf_counter()
            _, edited = edit(images, alphas.expand(images.shape[0], -1))
            sync()
            dt = time.perf_counter() - t0
            metrics = {k: v.cpu().numpy() for k, v in evaluate(images, edited).items()}
            out01 = GE.to_unit_range(edited).cpu().numpy()
            for b, meta in enumerate(metas):
                va0 = metrics["va_original"][b:b + 1]
                va1 = metrics["va_adapted"][b:b + 1]
                S.print_score(va1, f"{meta[0]} {name}", va0)
                S.record_edit(stats[name], va0, va1, float(metrics["rec_error"][b]))
                base = os.path.basename(meta[0]).replace(".jpg", "")
                Image.fromarray(np.clip(out01[b] * 255, 0, 255).astype(np.uint8)).save(
                    os.path.join(out_dir, f"{base}_{name}.jpg"))
            print(f"[{name}] batch of {len(metas)} edited in {dt:.2f}s")

    if nproc > 1:
        print(f"[process {pid}/{nproc}] per-process stats follow")
    print(f"weight_clf: {args.weight_clf}; weight_dis: {args.weight_dis}; "
          f"weight_recon: {args.weight_recon}")
    S.print_stats(stats)


if __name__ == "__main__":
    main()
