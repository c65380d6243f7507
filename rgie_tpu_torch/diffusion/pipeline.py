"""Inversion-resampling diffusion pipeline: invert a real image, run
null-text optimization, resample with classifier-free + classifier guidance.
Port of ``rgie_tpu/diffusion/pipeline.py`` (reference pipeline family:
``src/pipelines/InversionResamplingDiffusionPipeline.py``,
``InversionResamplingStableDiffusionPipeline.py``, ``...XLPipeline.py``).

  * inversion (reverse_sample:26-49): a loop over ascending DDIM or
    DPM-Solver++ steps (over the alphas table, or over the karras/lu sigma
    table, whose dedup can make it shorter); the pivot latents are returned
    per call;
  * sampling (sample:51-145): the CFG pair batched through the UNet, a DDIM
    or DPM-Solver++ step, then classifier guidance as the gradient of the midu
    score with respect to the POST-step latents (the reference's
    autograd.grad at :126-142), gradient-normalized;
  * null-text optimization (_null_optimization:124-219): an outer loop over
    timesteps, an inner loop with the reference's early stop
    ``loss < eps + i*2e-5`` and per-step Adam on the uncond embeddings
    (lr = base_lr * (1 - i/100)); it keeps the DDIM step and timesteps
    whatever the scheduler, as the reference does;
  * the VAE transport, whole or tiled (``vae_tile``).

The JAX package scans these loops into XLA programs and passes the weights as
a ``PipelineParams`` pytree; here the loops are Python, the pipeline holds
the modules, and everything runs under ``torch.no_grad()`` except the two
places where a gradient is taken.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from rgie_tpu_torch.diffusion import schedulers as SCH
from rgie_tpu_torch.diffusion.schedulers import DiffusionSchedule
from rgie_tpu_torch.diffusion.unet import UNet2DCondition
from rgie_tpu_torch.diffusion.vae import AutoencoderKL, decode_tiled, encode_tiled
from rgie_tpu_torch.models.midu import ValenceArousalMidu
from rgie_tpu_torch.parallel.model_axis import model_axis_of


class SdxlCond(NamedTuple):
    """SDXL added conditioning, rows aligned with the embeds batch."""

    text_embeds: torch.Tensor  # (B, 1280) pooled
    time_ids: torch.Tensor     # (B, 6)


@dataclasses.dataclass
class RunLog:
    """What one edit did, for callers that check or time it: the inner Adam
    steps each null-text outer step ran (for a batch, the loop's iterations:
    the most any image ran), each image's own count per outer step, the norms
    of each classifier-guidance gradient (one per image, left on their
    device), the seconds per phase and the intermediate tensors of the last
    edit (among them the Adam moments of the last null-text outer step,
    ``nto_adam_m`` and ``nto_adam_v``)."""

    nto_inner_steps: List[int] = dataclasses.field(default_factory=list)
    nto_image_steps: List[List[int]] = dataclasses.field(default_factory=list)
    clf_grad_norms: List[torch.Tensor] = dataclasses.field(default_factory=list)
    seconds: Dict[str, float] = dataclasses.field(default_factory=dict)
    tensors: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)


class PhaseClock:
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
    # Tiled VAE transport (vae.decode_tiled / encode_tiled): the latent tile
    # size, or None for the whole-image VAE. The stride defaults to 3/4 of
    # the tile (25% crossfaded overlap), diffusers' overlap_factor.
    vae_tile: Optional[int] = None
    vae_tile_stride: Optional[int] = None
    # Sigma-space DPM tables (karras sigmas / lu lambdas, the reference's SDXL
    # DPM configuration, ...XLPipeline.py:29-32). When set (and
    # scheduler_type == "dpm"), sampling steps over ``sigma_sched`` and
    # inversion over ``sigma_sched_inv``, whose rounded-timestep dedup can
    # make it SHORTER than num_inference_steps. Build both with
    # schedulers.make_dpm_sigma_schedule.
    sigma_sched: Optional[SCH.DpmSigmaSchedule] = None
    sigma_sched_inv: Optional[SCH.DpmSigmaSchedule] = None

    def __post_init__(self):
        if self.scheduler_type not in ("ddim", "dpm"):
            raise ValueError(f"unknown scheduler_type {self.scheduler_type!r}: 'ddim' or 'dpm'")

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
        math runs in float32 whatever the VAE's working type). The reference
        preprocesses to [-1,1] via the diffusers image processor
        (...StableDiffusionPipeline.py:147-150)."""
        x = image * 2.0 - 1.0
        if self.vae_tile is not None:
            lat = encode_tiled(self.vae, x, generator, tile=self.vae_tile,
                               stride=self._vae_stride())
        else:
            lat = self.vae.encode(x, generator)
        return lat.float()

    @torch.no_grad()
    def score(self, images: torch.Tensor, empty_embeds: torch.Tensor,
              added_empty: Optional[SdxlCond] = None) -> torch.Tensor:
        """The midu's VA of ``images`` (B, H, W, 3) in [0, 1]: VAE-encode, the
        UNet's mid block at the last timestep under the empty-prompt
        embeddings (one row, shared by the batch), the midu (reference:
        src/adapt_images/scoring.py:7-24). Returns (B, num_outputs)."""
        b = images.shape[0]
        added = None
        if added_empty is not None:
            added = SdxlCond(*(x.expand(b, -1) for x in added_empty))
        _, mid = self._unet(self.encode_image(images), int(self.sched.timesteps[-1]),
                            empty_embeds.expand(b, -1, -1), added)
        return ValenceArousalMidu(model=self.midu_model).predict(mid)

    def _vae_stride(self) -> int:
        return self.vae_tile_stride or max((self.vae_tile * 3) // 4, 1)

    @torch.no_grad()
    def decode_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """latents -> images in [0,1] (diff_utils.decode_latents:109-119)."""
        if self.vae_tile is not None:
            img = decode_tiled(self.vae, latents, tile=self.vae_tile, stride=self._vae_stride())
        else:
            img = self.vae.decode(latents)
        return torch.clamp(img * 0.5 + 0.5, 0.0, 1.0)

    # -- inversion ----------------------------------------------------------

    def _use_sigma(self, table: Optional[SCH.DpmSigmaSchedule]) -> bool:
        return self.scheduler_type == "dpm" and table is not None

    def invert_tables(self, end_iteration: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Inversion step tables ``(ts, src_ts, i_vals)``, aligned per step.
        ``src_ts`` is only meaningful for table-DPM, ``i_vals`` (global step
        indices) for sigma-DPM; unused slots are zeros so the shapes are
        uniform."""
        if self._use_sigma(self.sigma_sched_inv):
            ts = self.sigma_sched_inv.timesteps
            if end_iteration is not None:
                ts = ts[:end_iteration]
            return ts, torch.zeros_like(ts), torch.arange(ts.shape[0])
        ts = SCH.inverse_timesteps(self.sched)
        if end_iteration is not None:
            ts = ts[:end_iteration]
        if self.scheduler_type == "dpm":
            dt = self.sched.num_train_timesteps // self.sched.num_inference_steps
            src_ts = torch.cat([ts[:1] - dt, ts[:-1]])
        else:
            src_ts = torch.zeros_like(ts)
        return ts, src_ts, torch.arange(ts.shape[0])

    @torch.no_grad()
    def invert_steps(self, latents: torch.Tensor, state: SCH.DpmState, embeds: torch.Tensor,
                     added: Optional[SdxlCond], ts: torch.Tensor, src_ts: torch.Tensor,
                     i_vals: torch.Tensor) -> Tuple[torch.Tensor, SCH.DpmState, torch.Tensor]:
        """Inversion over an explicit step window (a slice of
        ``invert_tables``). Carries the DPM state across windows (DDIM passes
        it through). Returns (final_latents, state, pivots (K, ...))."""
        use_sigma = self._use_sigma(self.sigma_sched_inv)
        pivots = []
        for t, t_src, i in zip(ts.tolist(), src_ts.tolist(), i_vals.tolist()):
            if use_sigma:
                # Sigma-space (karras/lu) inversion: step i moves sigmas[i]
                # -> sigmas[i+1]; the UNet conditions on the table's rounded
                # timesteps (the diffusers inverse-scheduler loop convention).
                eps, _ = self._unet(latents, t, embeds, added)
                latents, state = SCH.dpm_sigma_step(self.sigma_sched_inv, eps, i, latents, state)
            elif self.scheduler_type == "dpm":
                eps, _ = self._unet(latents, t_src, embeds, added)
                latents, state = SCH.dpm_step(self.sched, eps, t_src, t, latents, state)
            else:
                eps, _ = self._unet(latents, t, embeds, added)
                latents = SCH.ddim_inverse_step(self.sched, eps, t, latents)
            pivots.append(latents)
        return latents, state, torch.stack(pivots)

    def reverse_sample(self, latents: torch.Tensor, embeds: torch.Tensor,
                       added: Optional[SdxlCond] = None, end_iteration: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Inversion (reference: reverse_sample,
        ...StableDiffusionPipeline.py:26-49). Returns (noisy_latents,
        pivot_latents (K+1, ...)); pivots[0] is the clean latent."""
        ts, src_ts, i_vals = self.invert_tables(end_iteration)
        state = SCH.dpm_init_state(latents.shape, latents.dtype, latents.device)
        final, _, pivots = self.invert_steps(latents, state, embeds, added, ts, src_ts, i_vals)
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
        embeddings (:108-109). For a batch of B latents, ``prompt_embeds`` is
        (2B, L, D), B uncond rows then B cond rows, and
        ``uncond_embeds_per_step`` (S, B, L, D)."""
        ts, next_ts, steps = self.sample_tables(start_iteration)
        lat, _ = self.sample_steps(
            latents, SCH.dpm_init_state(latents.shape, latents.dtype, latents.device),
            prompt_embeds, added, ts, next_ts, steps,
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
        if self._use_sigma(self.sigma_sched):
            ts = self.sigma_sched.timesteps[start_iteration:]
        else:
            ts = self.sched.timesteps[start_iteration:]
        dt = self.sched.num_train_timesteps // self.sched.num_inference_steps
        next_ts = torch.cat([ts[1:], ts[-1:] - dt])
        steps = torch.arange(start_iteration, start_iteration + ts.shape[0])
        return ts, next_ts, steps

    @torch.no_grad()
    def sample_steps(self, latents: torch.Tensor, dpm_state: SCH.DpmState,
                     prompt_embeds: torch.Tensor,
                     added: Optional[SdxlCond], ts: torch.Tensor, next_ts: torch.Tensor,
                     i_vals: torch.Tensor, guidance_scale: float = 7.5,
                     guidance_clf_scale: float = 0.0, guidance_rescale: float = 0.0,
                     uncond_embeds_per_step: Optional[torch.Tensor] = None,
                     midu_is_minimized: bool = True,
                     midu_reference_value: Optional[torch.Tensor] = None,
                     log: Optional[RunLog] = None):
        """Guided sampling over an explicit step window (a slice of
        ``sample_tables``); ``i_vals`` are GLOBAL step indices (they index
        ``uncond_embeds_per_step`` and the sigma tables). Returns (latents,
        dpm_state) so a caller can chain windows. Each of the B latents is
        guided by its own rows: the CFG pair is [latents; latents] against
        ``prompt_embeds``' B uncond and B cond rows, and the classifier
        gradient is normalized per image."""
        use_sigma = self._use_sigma(self.sigma_sched)
        do_cfg = guidance_scale > 1.0
        do_clf = self.midu_model is not None and guidance_clf_scale > 0.0
        model_axis = model_axis_of(self.unet)
        lat = latents
        b = lat.shape[0]

        # Classifier guidance runs single-latent UNet passes with the UNCOND
        # conditioning rows (the reference uses prompt_embeds[0],
        # ...StableDiffusionPipeline.py:130).
        added_uncond = None
        if added is not None:
            added_uncond = SdxlCond(added.text_embeds[:b], added.time_ids[:b])
        clf = None
        if do_clf:
            clf = ValenceArousalMidu(model=self.midu_model, is_minimized=midu_is_minimized,
                                     reference_value=midu_reference_value)

        for t, t_next, i in zip(ts.tolist(), next_ts.tolist(), i_vals.tolist()):
            if do_cfg:
                embeds = prompt_embeds
                if uncond_embeds_per_step is not None:
                    embeds = torch.cat([_step_rows(uncond_embeds_per_step, i), embeds[b:]], dim=0)
                eps_pair, _ = self._unet(torch.cat([lat, lat], dim=0), t, embeds, added)
                eps_u, eps_c = eps_pair.chunk(2, dim=0)
                eps = eps_u + guidance_scale * (eps_c - eps_u)
                if guidance_rescale > 0.0:
                    eps = rescale_noise_cfg(eps, eps_c, guidance_rescale)
            else:
                added_cond = None
                if added is not None:
                    added_cond = SdxlCond(added.text_embeds[-b:], added.time_ids[-b:])
                eps, _ = self._unet(lat, t, prompt_embeds, added_cond)

            if use_sigma:
                lat, dpm_state = SCH.dpm_sigma_step(self.sigma_sched, eps, i, lat, dpm_state)
            elif self.scheduler_type == "dpm":
                lat, dpm_state = SCH.dpm_step(self.sched, eps, t, t_next, lat, dpm_state)
            else:
                lat = SCH.ddim_step(self.sched, eps, t, lat)

            if do_clf:
                # Classifier guidance on the POST-step latents, gradient
                # normalized (reference :126-142). Uncond row of the embeds.
                uncond = prompt_embeds[:b] if do_cfg else prompt_embeds
                if uncond_embeds_per_step is not None and do_cfg:
                    uncond = _step_rows(uncond_embeds_per_step, i)
                with torch.enable_grad():
                    lat_in = lat.detach().requires_grad_(True)
                    _, mid = self._unet(lat_in, t, uncond, added_uncond)
                    # The score sums over the images, so each image's
                    # gradient is its own.
                    (grad,) = torch.autograd.grad(clf.score(mid), lat_in)
                if model_axis is not None:
                    model_axis.mean_(grad)
                norms = torch.linalg.vector_norm(grad, dim=tuple(range(1, grad.ndim)),
                                                 keepdim=True)
                if log is not None:
                    log.clf_grad_norms.append(norms.reshape(b))
                if self.normalize_gradient:
                    grad = grad / (norms + 1e-10)
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
        (S, L, D) optimized uncond embeddings ((S, B, L, D) for B images).

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
        from ``lat_cur`` and the inversion pivot ``lat_prev``, one loss per
        image (B,). Their sum is differentiated, so each image's embeddings
        get the gradient of their own loss.

        Under a sharded UNet (``parallel.shard_model``) the ranks of its model
        group take the largest of their losses and the mean of their
        gradients, so that the early stop and the state it optimizes are the
        same on every rank whatever order a backward summed in: a rank that
        stopped alone would wait forever in a collective the others never
        enter. The guidance gradient of ``sample_steps`` is averaged too."""
        with torch.enable_grad():
            u = uncond.detach().requires_grad_(True)
            eps_u, _ = self._unet(lat_cur, t, u, added_uncond)
            eps = eps_u + guidance_scale * (eps_cond - eps_u)
            rec = SCH.ddim_step(self.sched, eps, t, lat_cur)
            loss = torch.mean((rec - lat_prev) ** 2, dim=tuple(range(1, rec.ndim)))
            (grad,) = torch.autograd.grad(loss.sum(), u)
        loss = loss.detach()
        model_axis = model_axis_of(self.unet)
        if model_axis is not None:
            model_axis.max_(loss)
            model_axis.mean_(grad)
        return loss, grad

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
        pivot_latents[s - i - 1]). The embeddings and Adam's moments keep the
        type of ``uncond`` (float32 from the CLI's text tower, whatever the
        UNet's type: the UNet casts its context on entry and the gradient
        comes back in float32). Returns (lat_cur, uncond, uncond_list
        (K, ...)).

        For B images (``lat_cur`` (B, h, w, c), ``uncond`` and
        ``cond_embeds`` (B, L, D), the added conds B rows each) every image
        keeps its own early stop: the inner loop runs while any image's
        condition holds, and an image that has stopped keeps its embeddings
        and Adam moments (the JAX package's vmapped ``while_loop``). An image
        still running has run every iteration, so Adam's step count is the
        loop's."""
        ts = self.sched.timesteps.tolist()
        base_lr = 1e-1 if self.is_xl else 1e-2
        b1, b2, adam_eps = 0.9, 0.999, 1e-8

        uncond_list = []
        for k, i in enumerate(i_vals.tolist()):
            t, lat_prev = ts[i], pivots_rev[k]
            eps_cond, _ = self._unet(lat_cur, t, cond_embeds, added_cond)
            lr = base_lr * (1.0 - i / 100.0)
            thresh = epsilon + i * 2e-5

            # The reference's hand-written Adam with the early stop: an image
            # runs while the loss of its PREVIOUS evaluation is at or above
            # the threshold, starting from infinity.
            u = uncond
            m, v = torch.zeros_like(u), torch.zeros_like(u)
            running = [True] * u.shape[0]
            image_steps = [0] * u.shape[0]
            j = 0
            while j < num_inner_steps and any(running):
                loss_t, g = self.null_inner_loss_and_grad(u, lat_cur, t, eps_cond, lat_prev,
                                                          guidance_scale, added_uncond)
                m_new = b1 * m + (1 - b1) * g
                v_new = b2 * v + (1 - b2) * g * g
                mh = m_new / -math.expm1((j + 1) * math.log(b1))
                vh = v_new / -math.expm1((j + 1) * math.log(b2))
                u_new = u - lr * mh / (torch.sqrt(vh) + adam_eps)
                if all(running):
                    u, m, v = u_new, m_new, v_new
                else:
                    keep = torch.tensor(running, device=u.device).view(-1, *[1] * (u.ndim - 1))
                    u, m, v = (torch.where(keep, new, old) for new, old in
                               ((u_new, u), (m_new, m), (v_new, v)))
                j += 1
                for row, loss in enumerate(loss_t.tolist()):
                    if running[row]:
                        image_steps[row] = j
                        running[row] = loss >= thresh
            if log is not None:
                log.nto_inner_steps.append(j)
                log.nto_image_steps.append(image_steps)
                log.tensors.update(nto_adam_m=m, nto_adam_v=v)
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


def _step_rows(uncond_embeds_per_step: torch.Tensor, i: int) -> torch.Tensor:
    """Step ``i``'s null-text embeddings as (B, L, D) rows: from (S, L, D)
    (one image) or (S, B, L, D)."""
    rows = uncond_embeds_per_step[i]
    return rows[None] if rows.ndim == 2 else rows


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
