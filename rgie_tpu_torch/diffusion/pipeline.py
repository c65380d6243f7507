"""Inversion-resampling diffusion pipeline: DDIM-invert a real image, run
null-text optimization, resample with classifier-free + classifier guidance.
Port of the DDIM branch of ``rgie_tpu/diffusion/pipeline.py`` (reference
pipeline family: ``src/pipelines/InversionResamplingDiffusionPipeline.py``,
``InversionResamplingStableDiffusionPipeline.py``).

  * inversion (reverse_sample:26-49): a loop over ascending DDIM steps; the
    pivot latents are returned per call;
  * sampling (sample:51-145): the CFG pair batched through the UNet, a DDIM
    step, then classifier guidance as the gradient of the midu score with
    respect to the POST-step latents (the reference's autograd.grad at
    :126-142), gradient-normalized;
  * null-text optimization (_null_optimization:124-219): an outer loop over
    timesteps, an inner loop with the reference's early stop
    ``loss < eps + i*2e-5`` and per-step Adam on the uncond embeddings
    (lr = base_lr * (1 - i/100)).

The JAX package scans these loops into XLA programs and passes the weights as
a ``PipelineParams`` pytree; here the loops are Python, the pipeline holds
the modules, and everything runs under ``torch.no_grad()`` except the two
places where a gradient is taken. The DPM-Solver++ branches (``scheduler_type
"dpm"``, the sigma tables) come with slice C2 and raise until then; so does
the tiled VAE transport, which the CLI refuses.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from rgie_tpu_torch.diffusion import schedulers as SCH
from rgie_tpu_torch.diffusion.schedulers import DiffusionSchedule
from rgie_tpu_torch.diffusion.unet import UNet2DCondition
from rgie_tpu_torch.diffusion.vae import AutoencoderKL
from rgie_tpu_torch.models.midu import ValenceArousalMidu


class SdxlCond(NamedTuple):
    """SDXL added conditioning, rows aligned with the embeds batch."""

    text_embeds: torch.Tensor  # (B, 1280) pooled
    time_ids: torch.Tensor     # (B, 6)


@dataclasses.dataclass
class RunLog:
    """What one edit did, for callers that check or time it: the inner Adam
    steps each null-text outer step ran, the norm of each classifier-guidance
    gradient (0-dim tensors, left on their device), the seconds per phase and
    the intermediate tensors of the last edit."""

    nto_inner_steps: List[int] = dataclasses.field(default_factory=list)
    clf_grad_norms: List[torch.Tensor] = dataclasses.field(default_factory=list)
    seconds: Dict[str, float] = dataclasses.field(default_factory=dict)
    tensors: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class InversionResamplingPipeline:
    """Static configuration: the frozen modules and the schedule."""

    unet: UNet2DCondition
    vae: AutoencoderKL
    sched: DiffusionSchedule
    midu_model: Optional[nn.Module] = None  # MiduSD/MiduSDXL (or None)
    normalize_gradient: bool = True         # AdaptConfig.normalize_gradient
    is_xl: bool = False
    scheduler_type: str = "ddim"            # AdaptConfig.scheduler_type
    # Recompute the whole UNet call on the backward pass of the two
    # differentiated paths (the null-text inner loss, classifier guidance).
    # The per-block variant is the UNet's own ``block_remat``.
    remat_unet: bool = False

    def __post_init__(self):
        if self.scheduler_type != "ddim":
            raise NotImplementedError(
                f"scheduler_type {self.scheduler_type!r}: the DPM-Solver++ schedulers (table "
                "and sigma-space) are not ported yet; they come with slice C2")

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    # -- UNet call helper ---------------------------------------------------

    def _unet(self, latents, t, embeds, added: Optional[SdxlCond]):
        kwargs = {}
        if self.is_xl and added is not None:
            b = latents.shape[0]
            kwargs = dict(added_text_embeds=added.text_embeds.expand(b, -1),
                          added_time_ids=added.time_ids.expand(b, 6))
        t = torch.as_tensor(t, device=latents.device)
        if self.remat_unet and torch.is_grad_enabled():
            return checkpoint(lambda lat, e: self.unet(lat, t, e, **kwargs), latents, embeds,
                              use_reentrant=False)
        return self.unet(latents, t, embeds, **kwargs)

    # -- VAE transport (get_latents_from_img / decode_to_pil analogs) -------

    @torch.no_grad()
    def encode_image(self, image: torch.Tensor, generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
        """(B, H, W, 3) in [0,1] -> scaled latents, float32 (the scheduler
        math runs in float32 whatever the VAE's working type)."""
        return self.vae.encode(image * 2.0 - 1.0, generator).float()

    @torch.no_grad()
    def decode_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """latents -> images in [0,1] (diff_utils.decode_latents:109-119)."""
        return torch.clamp(self.vae.decode(latents) * 0.5 + 0.5, 0.0, 1.0)

    # -- inversion ----------------------------------------------------------

    def invert_tables(self, end_iteration: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Inversion step tables ``(ts, src_ts, i_vals)``, aligned per step.
        ``src_ts`` is only meaningful for table-DPM and ``i_vals`` for
        sigma-DPM; DDIM reads ``ts``."""
        ts = SCH.inverse_timesteps(self.sched)
        if end_iteration is not None:
            ts = ts[:end_iteration]
        return ts, torch.zeros_like(ts), torch.arange(ts.shape[0])

    @torch.no_grad()
    def invert_steps(self, latents: torch.Tensor, state, embeds: torch.Tensor,
                     added: Optional[SdxlCond], ts: torch.Tensor, src_ts: torch.Tensor,
                     i_vals: torch.Tensor):
        """Inversion over an explicit step window (a slice of
        ``invert_tables``). ``state`` is the DPM carry, unused by DDIM and
        passed through. Returns (final_latents, state, pivots (K, ...))."""
        pivots = []
        for t in ts.tolist():
            eps, _ = self._unet(latents, t, embeds, added)
            latents = SCH.ddim_inverse_step(self.sched, eps, t, latents)
            pivots.append(latents)
        return latents, state, torch.stack(pivots)

    def reverse_sample(self, latents: torch.Tensor, embeds: torch.Tensor,
                       added: Optional[SdxlCond] = None, end_iteration: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """DDIM inversion (reference: reverse_sample,
        ...StableDiffusionPipeline.py:26-49). Returns (noisy_latents,
        pivot_latents (S+1, ...)); pivots[0] is the clean latent."""
        ts, src_ts, i_vals = self.invert_tables(end_iteration)
        final, _, pivots = self.invert_steps(latents, None, embeds, added, ts, src_ts, i_vals)
        return final, torch.cat([latents[None], pivots], dim=0)

    # -- sampling with CFG + classifier guidance -----------------------------

    def sample(self, latents: torch.Tensor, prompt_embeds: torch.Tensor,
               added: Optional[SdxlCond] = None, guidance_scale: float = 7.5,
               guidance_clf_scale: float = 0.0, guidance_rescale: float = 0.0,
               uncond_embeds_per_step: Optional[torch.Tensor] = None,
               start_iteration: int = 0, midu_is_minimized: bool = True,
               midu_reference_value: Optional[torch.Tensor] = None,
               log: Optional[RunLog] = None) -> torch.Tensor:
        """Denoise with CFG and per-step classifier guidance (reference:
        sample, ...StableDiffusionPipeline.py:51-145). ``prompt_embeds`` is
        (2, L, D) [uncond; cond] when guidance_scale > 1 else (1, L, D).
        ``uncond_embeds_per_step`` (S, L, D) substitutes the null-text
        embeddings (:108-109)."""
        ts, next_ts, steps = self.sample_tables(start_iteration)
        lat, _ = self.sample_steps(
            latents, None, prompt_embeds, added, ts, next_ts, steps,
            guidance_scale=guidance_scale, guidance_clf_scale=guidance_clf_scale,
            guidance_rescale=guidance_rescale, uncond_embeds_per_step=uncond_embeds_per_step,
            midu_is_minimized=midu_is_minimized, midu_reference_value=midu_reference_value,
            log=log)
        return lat

    def sample_tables(self, start_iteration: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Sampling step tables ``(ts, next_ts, i_vals)`` from
        ``start_iteration`` to the end; slice all three together to feed
        ``sample_steps`` window by window."""
        ts = self.sched.timesteps[start_iteration:]
        dt = self.sched.num_train_timesteps // self.sched.num_inference_steps
        next_ts = torch.cat([ts[1:], ts[-1:] - dt])
        steps = torch.arange(start_iteration, start_iteration + ts.shape[0])
        return ts, next_ts, steps

    @torch.no_grad()
    def sample_steps(self, latents: torch.Tensor, dpm_state, prompt_embeds: torch.Tensor,
                     added: Optional[SdxlCond], ts: torch.Tensor, next_ts: torch.Tensor,
                     i_vals: torch.Tensor, guidance_scale: float = 7.5,
                     guidance_clf_scale: float = 0.0, guidance_rescale: float = 0.0,
                     uncond_embeds_per_step: Optional[torch.Tensor] = None,
                     midu_is_minimized: bool = True,
                     midu_reference_value: Optional[torch.Tensor] = None,
                     log: Optional[RunLog] = None):
        """Guided sampling over an explicit step window (a slice of
        ``sample_tables``); ``i_vals`` are GLOBAL step indices (they index
        ``uncond_embeds_per_step``). Returns (latents, dpm_state)."""
        do_cfg = guidance_scale > 1.0
        do_clf = self.midu_model is not None and guidance_clf_scale > 0.0
        lat = latents

        # Classifier guidance runs single-latent UNet passes with the UNCOND
        # conditioning row (the reference uses prompt_embeds[0],
        # ...StableDiffusionPipeline.py:130).
        added_uncond = None
        if added is not None:
            added_uncond = SdxlCond(added.text_embeds[0:1], added.time_ids[0:1])
        clf = None
        if do_clf:
            clf = ValenceArousalMidu(model=self.midu_model, is_minimized=midu_is_minimized,
                                     reference_value=midu_reference_value)

        for t, i in zip(ts.tolist(), i_vals.tolist()):
            if do_cfg:
                embeds = prompt_embeds
                if uncond_embeds_per_step is not None:
                    embeds = torch.cat([uncond_embeds_per_step[i][None].to(embeds.dtype),
                                        embeds[1:]], dim=0)
                eps_pair, _ = self._unet(torch.cat([lat, lat], dim=0), t, embeds, added)
                eps_u, eps_c = eps_pair.chunk(2, dim=0)
                eps = eps_u + guidance_scale * (eps_c - eps_u)
                if guidance_rescale > 0.0:
                    eps = rescale_noise_cfg(eps, eps_c, guidance_rescale)
            else:
                added_cond = None
                if added is not None:
                    added_cond = SdxlCond(added.text_embeds[-1:], added.time_ids[-1:])
                eps, _ = self._unet(lat, t, prompt_embeds, added_cond)

            lat = SCH.ddim_step(self.sched, eps, t, lat)

            if do_clf:
                # Classifier guidance on the POST-step latents, gradient
                # normalized (reference :126-142). Uncond row of the embeds.
                uncond = prompt_embeds[0:1] if do_cfg else prompt_embeds
                if uncond_embeds_per_step is not None and do_cfg:
                    uncond = uncond_embeds_per_step[i][None].to(prompt_embeds.dtype)
                with torch.enable_grad():
                    lat_in = lat.detach().requires_grad_(True)
                    _, mid = self._unet(lat_in, t, uncond, added_uncond)
                    (grad,) = torch.autograd.grad(clf.score(mid), lat_in)
                if log is not None:
                    log.clf_grad_norms.append(torch.linalg.vector_norm(grad))
                if self.normalize_gradient:
                    grad = grad / (torch.linalg.vector_norm(grad) + 1e-10)
                lat = lat - guidance_clf_scale * grad
        return lat, dpm_state

    # -- null-text optimization ----------------------------------------------

    def null_optimization(self, pivot_latents: torch.Tensor, cond_embeds: torch.Tensor,
                          uncond_embeds: torch.Tensor, guidance_scale: float,
                          added_cond: Optional[SdxlCond] = None,
                          added_uncond: Optional[SdxlCond] = None,
                          num_inner_steps: int = 10, epsilon: float = 1e-5,
                          log: Optional[RunLog] = None) -> torch.Tensor:
        """Per-timestep Adam on the uncond embeddings so CFG sampling follows
        the inversion pivots (reference: _null_optimization, pipeline.py:124-219).
        pivot_latents: (S+1, 1, h, w, 4) from reverse_sample. Returns
        (S, L, D) optimized uncond embeddings.

        Per the reference: outer step i uses pivot pair (x_cur from the top,
        x_prev one below), lr = base_lr * (1 - i/100), inner early stop at
        loss < epsilon + i * 2e-5.
        """
        s = self.sched.num_inference_steps
        lat0 = pivot_latents[-1]
        # Step i consumes the pair (carried lat_cur, pivot_latents[s-i-1]);
        # the index is clipped, so a truncated inversion (end_iteration < S)
        # repeats its last pivot instead of failing.
        idx = torch.clamp(s - 1 - torch.arange(s), 0, pivot_latents.shape[0] - 1)
        pivots_rev = pivot_latents[idx.to(pivot_latents.device)]
        _, _, uncond_list = self.null_optimization_steps(
            lat0, uncond_embeds, pivots_rev, cond_embeds, torch.arange(s), guidance_scale,
            added_cond=added_cond, added_uncond=added_uncond, num_inner_steps=num_inner_steps,
            epsilon=epsilon, log=log)
        return uncond_list.squeeze(1) if uncond_list.ndim == 4 else uncond_list

    def null_inner_loss_and_grad(self, uncond: torch.Tensor, lat_cur: torch.Tensor, t: int,
                                 eps_cond: torch.Tensor, lat_prev: torch.Tensor,
                                 guidance_scale: float, added_uncond: Optional[SdxlCond] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The null-text inner objective and its gradient with respect to the
        uncond embeddings: the mean squared distance between the CFG DDIM step
        from ``lat_cur`` and the inversion pivot ``lat_prev``."""
        with torch.enable_grad():
            u = uncond.detach().requires_grad_(True)
            eps_u, _ = self._unet(lat_cur, t, u, added_uncond)
            eps = eps_u + guidance_scale * (eps_cond - eps_u)
            rec = SCH.ddim_step(self.sched, eps, t, lat_cur)
            loss = torch.mean((rec - lat_prev) ** 2)
            (grad,) = torch.autograd.grad(loss, u)
        return loss.detach(), grad

    @torch.no_grad()
    def null_optimization_steps(self, lat_cur: torch.Tensor, uncond: torch.Tensor,
                                pivots_rev: torch.Tensor, cond_embeds: torch.Tensor,
                                i_vals: torch.Tensor, guidance_scale: float,
                                added_cond: Optional[SdxlCond] = None,
                                added_uncond: Optional[SdxlCond] = None,
                                num_inner_steps: int = 10, epsilon: float = 1e-5,
                                log: Optional[RunLog] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """NTO over an explicit outer-step window. ``i_vals`` are GLOBAL outer
        indices (the lr ramp and the early-stop threshold depend on them);
        ``pivots_rev[k]`` is the prev-pivot for step ``i_vals[k]`` (i.e.
        pivot_latents[s - i - 1]). Returns (lat_cur, uncond, uncond_list
        (K, ...))."""
        ts = self.sched.timesteps.tolist()
        base_lr = 1e-1 if self.is_xl else 1e-2
        b1, b2, adam_eps = 0.9, 0.999, 1e-8

        uncond_list = []
        for k, i in enumerate(i_vals.tolist()):
            t, lat_prev = ts[i], pivots_rev[k]
            eps_cond, _ = self._unet(lat_cur, t, cond_embeds, added_cond)
            lr = base_lr * (1.0 - i / 100.0)
            thresh = epsilon + i * 2e-5

            # The reference's hand-written Adam with the early stop: the loop
            # runs while the loss of the PREVIOUS evaluation is at or above
            # the threshold, starting from infinity.
            u = uncond
            m, v = torch.zeros_like(u), torch.zeros_like(u)
            j, loss = 0, math.inf
            while j < num_inner_steps and loss >= thresh:
                loss_t, g = self.null_inner_loss_and_grad(u, lat_cur, t, eps_cond, lat_prev,
                                                          guidance_scale, added_uncond)
                m = b1 * m + (1 - b1) * g
                v = b2 * v + (1 - b2) * g * g
                mh = m / -math.expm1((j + 1) * math.log(b1))
                vh = v / -math.expm1((j + 1) * math.log(b2))
                u = u - lr * mh / (torch.sqrt(vh) + adam_eps)
                j, loss = j + 1, float(loss_t)
            if log is not None:
                log.nto_inner_steps.append(j)
            uncond = u

            # Final CFG step with the optimized embeddings (reference :209-216).
            added = None
            if self.is_xl and added_cond is not None:
                added = SdxlCond(
                    torch.cat([added_uncond.text_embeds, added_cond.text_embeds], dim=0),
                    torch.cat([added_uncond.time_ids, added_cond.time_ids], dim=0))
            eps_pair, _ = self._unet(torch.cat([lat_cur, lat_cur], dim=0), t,
                                     torch.cat([uncond, cond_embeds], dim=0), added)
            eps_u, eps_c = eps_pair.chunk(2, dim=0)
            eps = eps_u + guidance_scale * (eps_c - eps_u)
            lat_cur = SCH.ddim_step(self.sched, eps, t, lat_cur)
            uncond_list.append(uncond)
        return lat_cur, uncond, torch.stack(uncond_list)


def rescale_noise_cfg(noise_cfg: torch.Tensor, noise_pred_text: torch.Tensor,
                      guidance_rescale: float = 0.0) -> torch.Tensor:
    """Guidance rescale (reference: rescale_noise_cfg, pipeline.py:240-252;
    arXiv:2305.08891 section 3.4). Population standard deviations, as
    ``jnp.std`` computes them."""
    axes = tuple(range(1, noise_pred_text.ndim))
    std_text = torch.std(noise_pred_text, dim=axes, keepdim=True, correction=0)
    std_cfg = torch.std(noise_cfg, dim=axes, keepdim=True, correction=0)
    rescaled = noise_cfg * (std_text / std_cfg)
    return guidance_rescale * rescaled + (1 - guidance_rescale) * noise_cfg
