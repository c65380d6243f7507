"""Diffusion dataset-editing orchestration. Port of
``rgie_tpu/adapt/adapter.py`` (reference package ``src/adapt_images/``:
adapter.py, scoring.py, output.py, plus the ``revert_and_sample`` loop of
``src/pipelines/InversionResamplingDiffusionPipeline.py:74-122``): score the
original, compute the relative VA reference value, DDIM-invert, optionally
run the null-text optimization (recomputed only when the CFG scale changes),
sample per guidance setting, save and rescore each output.

As in the JAX package, the shared GuidanceConfig's reference_value is NOT
mutated in place (the reference compounds the alpha offset from image 2
onward, adapter.py:33-36), and pivot latents are per-call outputs.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from rgie_tpu_torch.config import GuidanceConfig
from rgie_tpu_torch.diffusion.pipeline import InversionResamplingPipeline, RunLog, SdxlCond
from rgie_tpu_torch.models.midu import ValenceArousalMidu
from rgie_tpu_torch.utils.stats import print_score


def _cond_row(both: SdxlCond, row: int) -> SdxlCond:
    return SdxlCond(both.text_embeds[row:row + 1], both.time_ids[row:row + 1])


@dataclasses.dataclass
class ImageScorer:
    """VA scoring through the latent-space midu classifier
    (reference: src/adapt_images/scoring.py:7-24)."""

    pipe: InversionResamplingPipeline
    embeds_fn: Callable[[str, str], torch.Tensor]  # (prompt, negative) -> (1, L, D)
    added_cond_fn: Optional[Callable[[str, str], SdxlCond]] = None  # SDXL

    def __post_init__(self):
        self._empty = self.embeds_fn("", "")
        self._added = None
        if self.pipe.is_xl and self.added_cond_fn is not None:
            self._added = _cond_row(self.added_cond_fn("", ""), 1)

    @torch.no_grad()
    def score(self, image: torch.Tensor) -> np.ndarray:
        """(1, H, W, 3) in [0,1] (already transform_image'd) -> (1, 2) VA."""
        pipe = self.pipe
        latents = pipe.encode_image(image)
        t = int(pipe.sched.timesteps[-1])
        _, mid = pipe._unet(latents, t, self._empty, self._added)
        return ValenceArousalMidu(model=pipe.midu_model).predict(mid).cpu().numpy()

    def rec_error(self, orig: torch.Tensor, adapted: torch.Tensor) -> float:
        return float(torch.mean(torch.abs(adapted - orig)))

    print_score = staticmethod(print_score)


@dataclasses.dataclass
class OutputImageManager:
    """Saves each adapted image and rescores it
    (reference: src/adapt_images/output.py)."""

    scorer: ImageScorer
    output_path: str = "."
    image_name: Optional[str] = None
    orig_image_score: Optional[np.ndarray] = None
    orig_image: Optional[torch.Tensor] = None

    def set_image_name(self, name: str):
        self.image_name = name

    def set_orig_image_score(self, score: np.ndarray):
        self.orig_image_score = score

    def set_orig_image(self, img: torch.Tensor):
        self.orig_image = img

    def callback(self, adapted_image: torch.Tensor, label: str = None):
        from PIL import Image

        out_dir = os.path.join(self.output_path, str(label))
        os.makedirs(out_dir, exist_ok=True)
        arr = np.clip(adapted_image[0].cpu().numpy() * 255, 0, 255).astype(np.uint8)
        Image.fromarray(arr).save(os.path.join(out_dir, f"{self.image_name}.jpg"))

        score = self.scorer.score(adapted_image)
        self.scorer.print_score(score, "adapted", self.orig_image_score)
        rec = self.scorer.rec_error(self.orig_image, adapted_image)
        print("Reconstruction error: {:.4f}".format(rec))


def transform_image(image_hwc: np.ndarray, input_size: int) -> torch.Tensor:
    """Resize(shorter)+CenterCrop+ToTensor (pipeline transform,
    InversionResamplingDiffusionPipeline.py:23-27), NHWC [0,1], on the CPU."""
    from rgie_tpu_torch.data.dataset import preprocess_image

    return torch.from_numpy(preprocess_image(image_hwc, input_size, input_size))


@dataclasses.dataclass
class ImageAdapter:
    """Per-image adapt loop (reference: src/adapt_images/adapter.py:13-51 +
    revert_and_sample, InversionResamplingDiffusionPipeline.py:74-122).
    ``last_log`` holds the ``RunLog`` of the latest ``revert_and_sample``."""

    pipe: InversionResamplingPipeline
    scorer: ImageScorer
    embeds_fn: Callable[[str, str], torch.Tensor]       # single-prompt embeds
    cfg_embeds_fn: Callable[[str, str], torch.Tensor]   # (2, L, D) [uncond; cond]
    # SDXL only: (prompt, negative) -> SdxlCond with rows [uncond; cond]
    # (text_embeds + micro-conditioning time_ids, diff_utils.py:274-367).
    added_cond_fn: Optional[Callable[[str, str], SdxlCond]] = None
    input_size: int = 512
    last_log: Optional[RunLog] = None

    def adapt(self, image_path: str, config: GuidanceConfig,
              output_manager: OutputImageManager, end_iteration: Optional[int],
              caption: str = "") -> Dict[str, torch.Tensor]:
        from rgie_tpu_torch.data.dataset import load_image_rgb

        image_name = os.path.basename(image_path).replace(".jpg", "")
        raw = load_image_rgb(image_path)
        image = transform_image(raw, self.input_size).to(self.pipe.device)

        orig_score = self.scorer.score(image)
        self.scorer.print_score(orig_score, "original")

        # Relative reference value, computed per image WITHOUT mutating the
        # shared config.
        reference_value = None
        if config.reference_value is not None:
            reference_value = torch.clamp(
                torch.from_numpy(orig_score) + config.reference_value, 0.0, 1.0
            ).to(self.pipe.device)

        output_manager.set_image_name(image_name)
        output_manager.set_orig_image_score(orig_score)
        output_manager.set_orig_image(image)

        return self.revert_and_sample(
            image, caption, end_iteration,
            {config.resolved_label(): dataclasses.replace(config)},
            reference_value=reference_value,
            callback_outputs=output_manager.callback)

    def revert_and_sample(self, image: torch.Tensor, caption: str,
                          end_iteration: Optional[int],
                          configs: Dict[str, GuidanceConfig],
                          reference_value=None,
                          callback_outputs=None) -> Dict[str, torch.Tensor]:
        pipe = self.pipe
        log = self.last_log = RunLog()
        clock = _PhaseClock(pipe.device, log)
        s = pipe.sched.num_inference_steps
        end_it = end_iteration if end_iteration is not None else s
        start_iteration = 0 if s != pipe.sched.num_inference_steps else s - end_it

        # Null-text inversion uses empty prompts (pipeline.py:83-84).
        empty = self.embeds_fn("", "")
        added_empty = None
        if pipe.is_xl and self.added_cond_fn is not None:
            added_empty = _cond_row(self.added_cond_fn("", ""), 1)
        latents = pipe.encode_image(image)
        clock.lap("encode")
        noisy, pivots = pipe.reverse_sample(latents, empty, added=added_empty,
                                            end_iteration=end_it)
        clock.lap("invert")
        log.tensors.update(latents=latents, noisy=noisy)

        outputs: Dict[str, torch.Tensor] = {}
        nto_embeds = None
        nto_scale = -1.0
        for key, cfg in configs.items():
            prompt = cfg.prompt if not cfg.use_caption else (caption + " " + cfg.prompt)
            if cfg.is_nto and nto_scale != cfg.cfg_scale:
                nto_scale = cfg.cfg_scale
                cond = self.embeds_fn(caption, "")
                uncond = self.embeds_fn("", "")
                nto_added_c, nto_added_u = None, None
                if pipe.is_xl and self.added_cond_fn is not None:
                    both = self.added_cond_fn(caption, "")
                    nto_added_u, nto_added_c = _cond_row(both, 0), _cond_row(both, 1)
                clock.lap("prompts")
                nto_embeds = pipe.null_optimization(
                    pivots, cond, uncond, added_cond=nto_added_c, added_uncond=nto_added_u,
                    guidance_scale=cfg.cfg_scale, log=log)
                clock.lap("nto")
                log.tensors["nto_embeds"] = nto_embeds
            elif not cfg.is_nto:
                nto_embeds = None
                nto_scale = -1.0

            embeds = self.cfg_embeds_fn(prompt, cfg.negative_prompt)
            added = None
            if pipe.is_xl and self.added_cond_fn is not None:
                added = self.added_cond_fn(prompt, cfg.negative_prompt)
            clock.lap("prompts")
            out_lat = pipe.sample(
                noisy, embeds, added=added, guidance_scale=cfg.cfg_scale,
                guidance_clf_scale=cfg.clf_scale, uncond_embeds_per_step=nto_embeds,
                start_iteration=start_iteration, midu_is_minimized=not cfg.max,
                midu_reference_value=reference_value, log=log)
            clock.lap("sample")
            img = pipe.decode_latents(out_lat)
            clock.lap("decode")
            log.tensors["out_latents"] = out_lat
            outputs[key] = img
            if callback_outputs is not None:
                callback_outputs(img, key)
                clock.lap("save_and_rescore")
        return outputs


class _PhaseClock:
    """Adds the seconds since the previous lap to ``log.seconds[name]``, after
    waiting for the device so that a phase is charged its own work."""

    def __init__(self, device: torch.device, log: RunLog):
        self.device, self.log = device, log
        self.last = self._now()

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def lap(self, name: str) -> None:
        now = self._now()
        self.log.seconds[name] = self.log.seconds.get(name, 0.0) + now - self.last
        self.last = now
