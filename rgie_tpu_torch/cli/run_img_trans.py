"""Dataset transform runner on PyTorch: port of ``scripts/run_img_trans.py``
(reference ``src/baselines/run_img_trans.py``): apply fixed, random, min,
max or custom filter-chain parameters to a dataset, compare the VA emotions
before and after (the evaluation primitive, run_img_trans.py:361-386), and
save the outputs.

    python -m rgie_tpu_torch.cli.run_img_trans --data-dir DIR --dataset coco \\
        --type CUSTOM --batch 12 --compare-emotions --device cuda

Each batch of up to ``--batch`` images is transformed in one call of
``ops/chain.py``'s ``apply_filter_chain_fused``: on a CUDA batch the
exposure -> saturation -> tone -> color -> contrast prefix is one launch of
kernel K1 (``csrc/pointwise_chain.cu``), the sharpen, blur and scale ops
follow in PyTorch. ``--va-model`` goes through ``models/loader.py``'s
dispatch, so a path naming EmoNet scores with EmoNet. Runs on one device:
``--device cuda`` (the default) fails when CUDA is missing, and the CPU is
used only for ``--device cpu``.
"""

from __future__ import annotations

import argparse
import enum
import os
import time
from typing import Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from rgie_tpu_torch.ops import chain as CH


class TransformationType(enum.Enum):
    SAME = 1
    RANDOM = 2
    MAX = 3
    MIN = 4
    CUSTOM = 5


def build_params(ttype: TransformationType, generator: torch.Generator,
                 dtype: torch.dtype = torch.float32) -> CH.FilterParams:
    """Parameter tables per type (reference: check_apply_params and
    init_custom_params, run_img_trans.py:94-465), on the CPU. RANDOM draws
    from ``generator`` in the JAX package's ranges, in this order: exposure
    [-0.5, 0.5), saturation [0.2, 2.5), contrast [0.4, 2.0), sharp [0, 3),
    blur [1e-4, 4), the tone curve (8, 1) [0.6, 1.4)."""
    p = CH.init_params(dtype)

    def scalar(v):
        return torch.tensor(v, dtype=dtype)

    if ttype == TransformationType.SAME:
        return p
    if ttype == TransformationType.CUSTOM:
        # the shipped custom look (run_img_trans.py:389-465): slight
        # underexposure, desaturation, red/blue curve pull at knot 1, blur 1.
        color = p.color.clone()
        color[1, 0] *= 0.7
        color[1, 2] *= 0.7
        p.exposure, p.contrast, p.saturation = scalar(-0.1), scalar(0.85), scalar(0.85)
        p.blur, p.color = scalar(1.0), color
        return p
    if ttype == TransformationType.MIN:
        p.exposure, p.saturation = scalar(-0.5), scalar(0.3)
        p.contrast, p.blur = scalar(0.5), scalar(4.0)
        return p
    if ttype == TransformationType.MAX:
        p.exposure, p.saturation = scalar(0.5), scalar(2.5)
        p.contrast, p.sharp = scalar(1.8), scalar(3.0)
        return p
    if ttype == TransformationType.RANDOM:
        def u(lo, hi, shape=()):
            return lo + (hi - lo) * torch.rand(shape, generator=generator, dtype=dtype)

        p.exposure, p.saturation, p.contrast = u(-0.5, 0.5), u(0.2, 2.5), u(0.4, 2.0)
        p.sharp, p.blur, p.tone = u(0.0, 3.0), u(1e-4, 4.0), u(0.6, 1.4, (8, 1))
        return p
    raise ValueError(ttype)


def params_to(params: CH.FilterParams, device: torch.device) -> CH.FilterParams:
    return CH.FilterParams(**{k: v.to(device) for k, v in vars(params).items()})


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--dataset", choices=("feed", "coco"), default="coco")
    ap.add_argument("--split", default="val")
    ap.add_argument("--type", default="CUSTOM", choices=[t.name for t in TransformationType])
    ap.add_argument("--output-dir", default="./out_img_trans")
    ap.add_argument("--input-size", type=int, default=1024)
    ap.add_argument("--crop-size", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=12)
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--compare-emotions", action="store_true")
    ap.add_argument("--va-model", default=None,
                    help="VA regressor checkpoint; a path naming EmoNet gives EmoNet")
    ap.add_argument("--one-batch", action="store_true")
    ap.add_argument("--check-individual", action="store_true",
                    help="apply each op separately and save per-op outputs "
                         "(the reference's is_ind_func_check, run_img_trans.py:27)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def load_dataset(args):
    from rgie_tpu_torch.data import CaptionFeedDataset, CocoCaptionsDataset

    if args.dataset == "coco":
        return CocoCaptionsDataset(args.data_dir, args.split)
    return CaptionFeedDataset(args.data_dir)


@torch.no_grad()
def transform_batch(images: torch.Tensor, params: CH.FilterParams) -> torch.Tensor:
    """The whole batch through the chain, the pointwise prefix as one K1
    launch on a CUDA batch."""
    return CH.apply_filter_chain_fused(images, params)


def transformed_batches(args, params: CH.FilterParams, device: torch.device
                        ) -> Iterator[Tuple[torch.Tensor, torch.Tensor, List[Tuple[str, str, str]]]]:
    """(images, transformed images, metas) per batch of the dataset, on
    ``device``; ``--one-batch`` stops after the first."""
    from rgie_tpu_torch.data import iterate_batches

    for images_np, metas in iterate_batches(load_dataset(args), args.batch, args.input_size,
                                            args.crop_size, limit=args.limit):
        images = torch.from_numpy(images_np).to(device)
        yield images, transform_batch(images, params), metas
        if args.one_batch:
            return


class RunSummary(NamedTuple):
    params: CH.FilterParams
    stats: dict            # utils.stats tables, {type name: {key: [...]}}
    images: int
    batches: int
    seconds: float         # the run's wall time, device-synchronised


def main(argv: Optional[Sequence[str]] = None) -> RunSummary:
    args = build_parser().parse_args(argv)
    from rgie_tpu_torch.device import resolve_device

    device = resolve_device(args.device)

    from PIL import Image

    from rgie_tpu_torch.engine import parametric as P
    from rgie_tpu_torch.models.loader import load_va_loss
    from rgie_tpu_torch.utils import stats as S

    ttype = TransformationType[args.type]
    generator = torch.Generator().manual_seed(args.seed)
    params = params_to(build_params(ttype, generator), device)
    os.makedirs(args.output_dir, exist_ok=True)

    evaluate = None
    if args.compare_emotions:
        va_loss = load_va_loss(args.va_model, generator)
        evaluate = P.make_evaluate(va_loss.to(device))

    stats = {}
    S.check_init_stats_adapt(stats, args.type)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    n_images = n_batches = 0
    t0 = time.perf_counter()
    for images, adapted, metas in transformed_batches(args, params, device):
        if args.check_individual:
            # per-op visual spot checks (reference: is_ind_func_check)
            with torch.no_grad():
                for op in CH.DEFAULT_TRANSFORMS:
                    single = CH.apply_filter_chain(images[:1], params, (op,))
                    arr = np.clip(single[0].cpu().numpy() * 255, 0, 255).astype(np.uint8)
                    Image.fromarray(arr).save(os.path.join(args.output_dir, f"check_{op}.jpg"))
        if evaluate is not None:
            m = {k: v.cpu().numpy() for k, v in evaluate(images, adapted).items()}
            for b in range(images.shape[0]):
                S.record_edit(stats[args.type], m["va_original"][b:b + 1],
                              m["va_adapted"][b:b + 1], float(m["rec_error"][b]))
        out = np.clip(adapted.cpu().numpy() * 255, 0, 255).astype(np.uint8)
        for b, meta in enumerate(metas):
            name = os.path.basename(meta[0]).replace(".jpg", "")
            Image.fromarray(out[b]).save(os.path.join(args.output_dir, f"{name}.jpg"))
        n_images += len(metas)
        n_batches += 1
    sync()
    seconds = time.perf_counter() - t0
    print(f"{args.type}: {n_images} images in {n_batches} batches of up to {args.batch} in "
          f"{seconds:.2f} s ({n_images / max(seconds, 1e-9):.3f} img/s) on {device}")
    if args.compare_emotions:
        S.print_stats(stats)
    return RunSummary(params=params, stats=stats, images=n_images, batches=n_batches,
                      seconds=seconds)


if __name__ == "__main__":
    main()
