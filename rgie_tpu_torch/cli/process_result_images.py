"""Offline result analysis on PyTorch: port of ``scripts/process_result_images.py``
(reference ``src/analysis/process_result_images.py``): scan a folder of
``{name}_{method}.jpg`` edited outputs, compute VA and the low-level metrics
per image, run the significance tests per metric, and with ``--fid`` the
FID, KID and Inception Score of each method against the originals.

    python -m rgie_tpu_torch.cli.process_result_images FOLDER --fid --device cuda

``--fid`` extracts Inception-v3 features (pytorch-fid's graph, 2048-d pool
features and 1008 classes): from ``--inception-ckpt`` when it is given (a
pytorch-fid ``pt_inception-2015-12-05`` or torchvision state dict; the
calibrated numbers), else from random weights drawn from seed 0, since
no checkpoint ships with the repository. ``--clip-fid`` uses the CLIP image
tower instead, the JAX CLI's fallback without a checkpoint. The VA regressor
and the feature extractor run on ``--device`` (``cuda`` by default, or
``cpu``); the covariance square root of the FID runs on the host.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("folder", help="folder of {name}_{method}.jpg result images")
    ap.add_argument("--va-model", default=None, help="torch va_pred_all checkpoint")
    ap.add_argument("--fid", action="store_true", help="also compute FID/KID/ISC vs originals")
    ap.add_argument("--inception-ckpt", default=None,
                    help="torch Inception-v3 state_dict (pytorch-fid "
                         "pt_inception-2015-12-05 or torchvision) for calibrated "
                         "FID/KID/ISC; random weights from seed 0 without it")
    ap.add_argument("--clip-fid", action="store_true",
                    help="CLIP image-tower features instead of Inception's (CLIP-FID)")
    ap.add_argument("--kid-subset", type=int, default=20)
    ap.add_argument("--csv", default=None, help="write the metrics table to CSV")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def build_feature_extractor(args, device: torch.device):
    """The ``--fid`` features: Inception-v3 (the checkpoint's, or random from
    seed 0, the seed of JAX's CLI) or, with ``--clip-fid``, the CLIP image
    tower."""
    generator = torch.Generator().manual_seed(0)
    if args.clip_fid:
        from rgie_tpu_torch.analysis.fid import make_clip_feature_extractor
        from rgie_tpu_torch.models.clip import create_clip_image_encoder

        return make_clip_feature_extractor(create_clip_image_encoder(generator).to(device))
    from rgie_tpu_torch.models.inception import (create_inception, load_inception,
                                                 make_feature_extractor)

    if args.inception_ckpt:
        from rgie_tpu_torch.utils.checkpoint import load_torch_state_dict

        model = load_inception(load_torch_state_dict(args.inception_ckpt))
        print(f"loaded Inception-v3 from {args.inception_ckpt}")
    else:
        model = create_inception(generator)
        print("WARNING: no --inception-ckpt; random-weight Inception-v3 stand-in "
              "(uncalibrated FID/KID/ISC)")
    return make_feature_extractor(model.to(device))


def main(argv: Optional[Sequence[str]] = None):
    """Analyse the folder; returns ``process_results.Analysis`` (the metrics
    table, the stats tests, FID/KID/ISC per method)."""
    args = build_parser().parse_args(argv)
    from rgie_tpu_torch.analysis.process_results import (process_result_images, table_size,
                                                         write_csv)
    from rgie_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    feature_extractor = build_feature_extractor(args, device) if args.fid else None
    analysis = process_result_images(args.folder, model_path=args.va_model,
                                     feature_extractor=feature_extractor,
                                     kid_subset_size=args.kid_subset, device=device)
    if args.csv and table_size(analysis.table):
        write_csv(analysis.table, args.csv)
        print(f"wrote {args.csv}")
    return analysis


if __name__ == "__main__":
    main()
