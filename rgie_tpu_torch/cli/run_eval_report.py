"""The integrated edit -> analysis evaluation on PyTorch: port of
``scripts/run_eval_report.py``.

Chains the reference's evaluation workflow (``src/analysis/
process_result_images.py:17-89``) over one edit run: edit a caption feed (or
synthetic images) with all three backends (the parametric filter chain, the
MUNIT style edit, and the diffusion edit: inversion, null-text
optimization, guided resampling, plus its unguided control), write
``{name}_{method}.jpg``, then run the analysis suite on those files (VA and
low-level metrics per image, the stats test per metric, Inception-v3
FID/KID/ISC per method against the originals) and write one JSON and one
markdown report.

    python -m rgie_tpu_torch.cli.run_eval_report --scale sd --limit 2 --device cuda

``--scale tiny`` runs small random-weight models at 64 px (its guidance
classifier teacher-trained first, as in the JAX package); ``--scale sd`` the
full-width models at 512 px, random weights drawn from ``--seed`` (SD-2.1's
UNet, VAE and text tower; ResNet-50, CLIP ViT-B/32, MUNIT, Inception-v3), in
float32. The JAX script edits at 480 px there, a size SD-2.1's UNet cannot
take (its 60 px latents go down to 8 and come back up as 16 against a 15 px
skip); 512 is the nearest size it takes, the diffusion CLI's default. The
edits run on ``--device`` (``cuda`` by default, or ``cpu``).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional, Sequence

import numpy as np
import torch


def parse_args(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data-dir", default=None,
                    help="caption feed dir; default: synthetic images")
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--scale", choices=("tiny", "sd"), default="tiny")
    ap.add_argument("--limit", type=int, default=4)
    ap.add_argument("--steps", type=int, default=None,
                    help="edit optimization steps (default 20 tiny / 100 sd)")
    ap.add_argument("--diff-steps", type=int, default=None,
                    help="diffusion inversion/sampling steps (default 3 tiny / 50 sd)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--alpha", type=float, nargs=2, default=(0.2, 0.2),
                    help="target VA delta for the param/GAN edits")
    ap.add_argument("--clf-scale", type=float, default=None,
                    help="diffusion classifier-guidance scale (default 1.5 tiny / 0.2 sd)")
    ap.add_argument("--nto-steps", type=int, default=None,
                    help="null-text-optimization inner Adam steps (default 10, the "
                         "production value; fewer loosen inversion fidelity)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def _save_jpg(path: str, image01: torch.Tensor) -> None:
    from PIL import Image

    arr = np.clip(image01.detach().float().cpu().numpy() * 255.0, 0, 255).astype("uint8")
    if arr.ndim == 4:
        arr = arr[0]
    Image.fromarray(arr).save(path, quality=95)


def model_generators(seed: int) -> List[torch.Generator]:
    """One independent generator per model, as the JAX script splits its key
    eight ways: the regressor, CLIP, MUNIT, the UNet, the VAE, the midu, the
    text tower, Inception."""
    return [torch.Generator().manual_seed(int(s))
            for s in np.random.SeedSequence(seed).generate_state(8)]


def markdown_table(columns: dict, index: Optional[List[str]] = None) -> str:
    """A pipe table of ``{column: {row: value}}`` (or of lists, with
    ``index`` naming the rows)."""
    names = list(columns)
    if index is None:
        index = list(dict.fromkeys(r for col in columns.values() for r in col))
        cells = {c: columns[c] for c in names}
    else:
        cells = {c: dict(zip(index, columns[c])) for c in names}
    lines = ["| | " + " | ".join(names) + " |", "|" + "---|" * (len(names) + 1)]
    for r in index:
        lines.append(f"| {r} | " + " | ".join(str(cells[c].get(r, "")) for c in names) + " |")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    from rgie_tpu_torch.device import resolve_device

    device = resolve_device(args.device)

    from rgie_tpu_torch.analysis import process_results as PR
    from rgie_tpu_torch.config import (OUT_DIR, GanEditConfig, MunitGenConfig, OptimizeConfig,
                                       ParamEditConfig, TrainGuidanceConfig)
    from rgie_tpu_torch.diffusion import schedulers as SCH
    from rgie_tpu_torch.diffusion.pipeline import InversionResamplingPipeline
    from rgie_tpu_torch.diffusion.text_encoder import TextTowerConfig, create_sd_prompt_encoder
    from rgie_tpu_torch.diffusion.unet import UNetConfig, create_unet
    from rgie_tpu_torch.diffusion.vae import VaeConfig, create_vae
    from rgie_tpu_torch.engine import gan as GE
    from rgie_tpu_torch.engine import parametric as P
    from rgie_tpu_torch.losses.emotion_loss import ValenceArousalLoss
    from rgie_tpu_torch.models.clip import create_clip_image_encoder
    from rgie_tpu_torch.models.emotion import EmotionRegressor, create_regressor
    from rgie_tpu_torch.models.inception import create_inception, make_feature_extractor
    from rgie_tpu_torch.models.init import freeze_
    from rgie_tpu_torch.models.midu import create_midu
    from rgie_tpu_torch.models.munit import create_generator
    from rgie_tpu_torch.ops import geometry as G
    from rgie_tpu_torch.ops.numerics import clip
    from rgie_tpu_torch.training.train_midu import create_train_state, make_train_step

    tiny = args.scale == "tiny"
    size = 64 if tiny else 512
    steps = args.steps or (20 if tiny else 100)
    diff_steps = args.diff_steps or (3 if tiny else 50)
    out_dir = args.out_dir or str(OUT_DIR / "eval_report")
    img_dir = os.path.join(out_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    keys = model_generators(args.seed)

    # ---- source images -----------------------------------------------------
    if args.data_dir:
        from rgie_tpu_torch.data import CaptionFeedDataset, first_caption, load_image_rgb

        ds = CaptionFeedDataset(args.data_dir)
        items = []
        for i in range(min(args.limit, len(ds))):
            _, (name, path, captions) = ds[i]
            items.append((name, load_image_rgb(path), first_caption(captions)))
    else:
        rng = np.random.default_rng(args.seed)
        items = []
        for i in range(args.limit):
            base = rng.uniform(0.15, 0.85, size=(3,))
            img = np.clip(base + 0.25 * rng.standard_normal((size, size, 3)),
                          0, 1).astype(np.float32)
            items.append((f"synthetic{i}", img, f"a synthetic test image {i}"))

    def prep(img01: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(np.asarray(img01, np.float32))[None].to(device)
        if x.shape[1] != size or x.shape[2] != size:
            x = G.resize(x, (size, size), antialias=True)
        return torch.clamp(x, 0.0, 1.0)

    alphas = torch.tensor([args.alpha], dtype=torch.float32, device=device)
    report = {"config": {"scale": args.scale, "images": len(items), "steps": steps,
                         "diff_steps": diff_steps, "size": size},
              "edits": {}}
    t_start = time.time()

    # ---- backend 1: parametric filter-chain edit ---------------------------
    reg_kw = dict(input_size=64, crop_size=56) if tiny else {}
    va_loss = ValenceArousalLoss(regressor=create_regressor(keys[0], **reg_kw)).to(device)
    clip_enc = create_clip_image_encoder(
        keys[1], **(dict(width=32, layers=2, heads=2, patch_size=16, input_resolution=64,
                           output_dim=16) if tiny else {})).to(device)
    # At tiny scale the random CLIP term is a noise surface that pins the
    # best vector at the identity under the production weighting: reweight
    # toward the VA term, as the JAX package does; sd keeps the reference's
    # weights (optimize_image_param.py:30-59).
    p_weights = dict(weight_clf=1.0, weight_recon=0.1) if tiny else {}
    pcfg = ParamEditConfig(optimize=OptimizeConfig(
        num_steps=steps, learning_rate=0.1 if tiny else 0.05), **p_weights)
    p_edit = P.make_batched_edit(P.EditModels(va_loss=va_loss, clip=clip_enc), pcfg)
    evaluate = P.make_evaluate(va_loss)

    # ---- backend 2: MUNIT style edit ---------------------------------------
    gcfg_model = (MunitGenConfig(num_filters=8, max_num_filters=32, num_filters_mlp=16,
                                 num_res_blocks=2, num_downsamples_style=3,
                                 num_downsamples_content=2) if tiny else MunitGenConfig())
    gen = create_generator(keys[2], gcfg_model).autoencoder_a.to(device)
    # The GAN objective optimizes the function the report evaluates: the same
    # weights on [-1, 1] images (normalize=False), so VA(x) there is the
    # evaluation's VA((x + 1) / 2).
    reg = va_loss.regressor
    va_loss_gan = ValenceArousalLoss(regressor=freeze_(EmotionRegressor(
        reg.net, num_classes=reg.num_classes, input_size=reg.input_size,
        crop_size=reg.crop_size, normalize=False, use_sigmoid=reg.use_sigmoid)))
    g_weights = dict(weight_clf=1.0, weight_recon=0.1) if tiny else {}
    gan_cfg = GanEditConfig(optimize=OptimizeConfig(
        num_steps=steps, learning_rate=0.1 if tiny else 0.05), **g_weights)
    g_edit = GE.make_batched_edit(GE.GanEditModels(generator=gen, va_loss=va_loss_gan), gan_cfg)

    # ---- backend 3: diffusion edit -----------------------------------------
    ucfg = UNetConfig.tiny() if tiny else UNetConfig.sd21()
    vcfg = VaeConfig.tiny() if tiny else VaeConfig.sd()
    unet = create_unet(keys[3], ucfg).to(device)
    vae = create_vae(keys[4], vcfg).to(device)
    midu = create_midu(keys[5], num_outputs=2, in_channels=ucfg.block_out_channels[-1])
    pipe = InversionResamplingPipeline(unet=unet, vae=vae, sched=SCH.make_schedule(diff_steps),
                                       midu_model=midu.to(device))
    prompt_enc = create_sd_prompt_encoder(keys[6], TextTowerConfig.tiny() if tiny else None)
    prompt_enc.tower1.to(device)

    if tiny:
        # Teacher-train the tiny guidance classifier (the reference's workflow:
        # clf/train_guidance_clf.py labels mid-block features with the frozen
        # VA teacher), with labels from the regressor the report evaluates
        # with, on the decoded latents: a random midu has no correlation with
        # it, so guidance could steer VA only by chance.
        rng_t = np.random.default_rng(args.seed + 1)
        uncond1 = prompt_enc.encode_sd("", do_cfg=False)
        sched_ts = pipe.sched.timesteps.tolist()
        feats_l, labels_l = [], []
        with torch.no_grad():
            for _, img01, _ in items:
                x = prep(img01)
                for _ in range(8):
                    scale = torch.from_numpy(rng_t.uniform(0.6, 1.4, (1, 1, 1, 3))
                                             .astype(np.float32)).to(device)
                    shift = torch.from_numpy(rng_t.uniform(-0.25, 0.25, (1, 1, 1, 3))
                                             .astype(np.float32)).to(device)
                    lat = pipe.encode_image(torch.clamp(x * scale + shift, 0.0, 1.0))
                    label = va_loss.predict_loss_metric(pipe.decode_latents(lat))
                    eps = torch.from_numpy(rng_t.standard_normal(tuple(lat.shape))
                                           .astype(np.float32)).to(device)
                    for t in sched_ts:
                        tt = torch.tensor([t], device=device)
                        noisy = SCH.add_noise(pipe.sched, lat, eps, tt)
                        feats_l.append(pipe._unet(noisy, tt, uncond1, None)[1].float())
                        labels_l.append(label)
        feats_all, labels_all = torch.cat(feats_l), torch.cat(labels_l)
        tcfg = TrainGuidanceConfig(batch_size=32, learning_rate=3e-3, weight_decay=0.0)
        tstate, tstep = create_train_state(midu, tcfg), make_train_step()
        idx = np.arange(len(feats_all))
        loss0 = loss_t = None
        for _ in range(40):
            rng_t.shuffle(idx)
            for b in range(0, len(idx) - tcfg.batch_size + 1, tcfg.batch_size):
                sel = torch.from_numpy(idx[b:b + tcfg.batch_size]).to(device)
                tstate, loss_t, _ = tstep(tstate, feats_all[sel], labels_all[sel])
                if loss0 is None:
                    loss0 = float(loss_t)
        freeze_(tstate.model)
        report["midu_teacher_training"] = {"samples": int(len(feats_all)),
                                           "first_loss": round(loss0, 6),
                                           "final_loss": round(float(loss_t), 6)}
        print(f"teacher-trained tiny midu: {len(feats_all)} samples, "
              f"loss {loss0:.5f} -> {float(loss_t):.5f}", flush=True)

    # Guidance steers the midu's VA toward the per-image target the param and
    # GAN objectives use (va0 + alpha); tiny scale needs a larger scale (the
    # normalized-gradient step moves the latent by clf_scale per step).
    clf_scale = args.clf_scale if args.clf_scale is not None else (1.5 if tiny else 0.2)
    nto_steps = args.nto_steps if args.nto_steps is not None else 10

    def diffusion_edit(image01: torch.Tensor, caption: str, scale: float) -> torch.Tensor:
        """One invert -> NTO -> guided-resample edit at classifier-guidance
        ``scale``; ``scale=0`` is the unguided control (same inversion, same
        NTO, same CFG resample)."""
        lat = pipe.encode_image(image01)
        with torch.no_grad():
            va0 = va_loss.predict_loss_metric(image01)
        cond = prompt_enc.encode_sd(caption, do_cfg=False)
        noisy, pivots = pipe.reverse_sample(lat, cond)
        cfg_embeds = prompt_enc.encode_sd(caption, do_cfg=True)
        uncond_steps = pipe.null_optimization(pivots, cond, cfg_embeds[0:1], guidance_scale=2.0,
                                              num_inner_steps=nto_steps)
        final = pipe.sample(noisy, cfg_embeds, guidance_scale=2.0, guidance_clf_scale=scale,
                            uncond_embeds_per_step=uncond_steps, midu_is_minimized=False,
                            midu_reference_value=clip(va0 + alphas, 0.0, 1.0))
        return pipe.decode_latents(final)

    # ---- run all edits -----------------------------------------------------
    for name, img01, caption in items:
        x = prep(img01)
        _save_jpg(os.path.join(img_dir, f"{name}_o.jpg"), x)
        _, p_out = p_edit(x, alphas)
        _save_jpg(os.path.join(img_dir, f"{name}_param.jpg"), p_out)
        _, g_out = g_edit(x * 2.0 - 1.0, alphas)
        g_out01 = g_out * 0.5 + 0.5
        _save_jpg(os.path.join(img_dir, f"{name}_gan.jpg"), g_out01)
        d_out = diffusion_edit(x, caption, clf_scale)
        _save_jpg(os.path.join(img_dir, f"{name}_diff.jpg"), d_out)
        d_out0 = diffusion_edit(x, caption, 0.0)

        # The achieved VA delta of each backend, all scored by the same
        # regressor in [0, 1]; diff - diff_unguided is what the guidance
        # term itself contributed.
        deltas = {}
        for method, out01 in (("param", p_out), ("gan", g_out01), ("diff", d_out),
                              ("diff_unguided", d_out0)):
            ev = evaluate(x, torch.clamp(out01, 0.0, 1.0))
            deltas[method] = ev["va_delta"].reshape(-1).cpu().tolist()
        deltas["diff_guidance_effect"] = [
            a - b for a, b in zip(deltas["diff"], deltas["diff_unguided"])]
        report["edits"][name] = {"caption": caption, "va_delta": deltas,
                                 "va_target_delta": [float(a) for a in args.alpha]}
        print(f"edited {name} (param/gan/diff)", flush=True)
    report["edit_seconds"] = round(time.time() - t_start, 2)
    report["va_delta_vs_target"] = {
        "target": [float(a) for a in args.alpha],
        **{m: np.mean([e["va_delta"][m] for e in report["edits"].values()],
                      axis=0).round(5).tolist()
           for m in ("param", "gan", "diff", "diff_unguided", "diff_guidance_effect")},
    }

    # ---- analysis: the reference's process_result_images workflow ----------
    table = PR.collect_scores(img_dir, device=device)
    report["scores"] = {metric: {m: float(np.round(v, 5)) for m, v in by_method.items()}
                        for metric, by_method in PR.method_means(table).items()}
    # FID/KID/ISC per method against the originals (16 classes at tiny scale).
    inception = create_inception(keys[7], num_classes=16 if tiny else 1008).to(device)
    analysis = PR.analyse(table, make_feature_extractor(inception, batch_size=4),
                          kid_subset_size=None, verbose=False)
    report["stats_tests"] = {
        k: {kk: (float(vv) if isinstance(vv, (int, float)) else str(vv)) for kk, vv in v.items()}
        for k, v in analysis.stats.items()}
    report["quality_vs_original"] = {
        method: {k: round(float(v), 5) for k, v in q.items()}
        for method, q in analysis.quality.items()}
    report["total_seconds"] = round(time.time() - t_start, 2)

    # ---- write the report --------------------------------------------------
    json_path = os.path.join(out_dir, "eval_report.json")
    with open(json_path, "w") as f:
        json.dump(report, f, indent=2)
    md = ["# rgie_tpu edit -> analysis evaluation report", "",
          f"scale={args.scale}, {len(items)} images, {steps} opt steps, "
          f"{diff_steps} diffusion steps, {report['total_seconds']}s total", "",
          "## Mean scores by method", "", markdown_table(report["scores"]),
          "", "## Achieved VA delta vs target (same regressor, [0,1] space)", "",
          markdown_table({"valence": [v[0] for v in report["va_delta_vs_target"].values()],
                          "arousal": [v[1] for v in report["va_delta_vs_target"].values()]},
                         index=list(report["va_delta_vs_target"]))]
    if tiny:
        md += ["", "diff_unguided is the clf-scale-0 control (same inversion/NTO/CFG "
               "resample); diff_guidance_effect = diff - diff_unguided is the "
               "classifier-guidance term's own contribution. At tiny scale (random-weight "
               "UNet/VAE, teacher-trained midu) it sits below the resampling drift, so the "
               "diffusion rows' deltas are reconstruction drift, not steering; the param and "
               "gan rows are direction-correct steering."]
    md += ["", "## Quality vs originals (Inception FID/KID/ISC)", "",
           markdown_table(report["quality_vs_original"]), "",
           "## Stats tests (one-way, per metric)", ""]
    for metric, res in report["stats_tests"].items():
        md.append(f"- **{metric}**: {res}")
    with open(os.path.join(out_dir, "eval_report.md"), "w") as f:
        f.write("\n".join(md) + "\n")
    print(f"report written to {json_path}")
    return report


if __name__ == "__main__":
    main()
