"""The batched diffusion edit: ``diffusion/batched.make_batched_edit`` of
``rgie_tpu_torch`` over whole batches of random images, back to back.

Set-up makes every weight on the device from the seed, builds the pipeline
the CLI builds (``cli/adapt_images.build_models``: bfloat16 UNet and VAE,
float32 midu and embeddings) and warms every shape up with a one-step edit of
one full batch. The window then edits batches until ``--seconds`` have
passed, ending at a batch boundary. The check edits a few rows of one batch
of the window again with the plain float32 reference, from the same inputs
and weights, and compares every stage.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional

import torch

from benchmark import common, flops
from benchmark.reference import edit as ref_edit
from benchmark.reference import nets
from benchmark.reference.precision import FLOAT32, FP8, TF32, set_precision

EXACT = {"unet_vae": FLOAT32, "midu": FLOAT32}
LOWERED = {"unet_vae": FP8, "midu": TF32}

#: The window keeps the inputs and outputs of one of its first batches for
#: the check, drawn from the seed among this many.
CHECKED_BATCH_CHOICES = 4
#: The rows of that batch the check edits again, one drawn from each of as
#: many equal parts of the batch.
CHECKED_ROWS = 2
#: The flash-attention (K2) launchers of ``ops/kernels/flash_attention.py``
#: by kernel, and the launch counter of each.
K2_LAUNCHERS = {"fwd": "_launch_fwd", "bwd_dkv": "_launch_bwd_dkv", "bwd_dq": "_launch_bwd_dq"}
K2_COUNTERS = {"fwd": "LAUNCHES_FWD", "bwd_dkv": "LAUNCHES_BWD_DKV",
               "bwd_dq": "LAUNCHES_BWD_DQ"}


def _tuple(v):
    return tuple(v) if isinstance(v, list) else v


def unet_config(cfg: dict):
    """The port's ``UNetConfig`` from the configuration file's ``unet``."""
    from rgie_tpu_torch.diffusion.unet import UNetConfig

    u = cfg["unet"]
    fields = {f.name for f in dataclasses.fields(UNetConfig)}
    kwargs = {k: _tuple(v) for k, v in u.items() if k in fields}
    if u.get("addition_embed_type") == "text_time":
        kwargs["addition_pooled_dim"] = (u["projection_class_embeddings_input_dim"]
                                         - 6 * u["addition_time_embed_dim"])
    return UNetConfig(**kwargs)


def vae_config(cfg: dict):
    from rgie_tpu_torch.diffusion.vae import VaeConfig

    v = cfg["vae"]
    return VaeConfig(in_channels=v["in_channels"], latent_channels=v["latent_channels"],
                     block_out_channels=tuple(v["block_out_channels"]),
                     layers_per_block=v["layers_per_block"],
                     norm_num_groups=v["norm_num_groups"], scaling_factor=v["scaling_factor"])


def is_xl(cfg: dict) -> bool:
    return cfg["unet"].get("addition_embed_type") == "text_time"


class Inputs:
    """One batch's inputs, drawn on the device: images in [0, 1], a caption
    embedding per image (unit normal, as a layer-normed text tower gives),
    the CFG pair [empty; caption] and, for SDXL, the pooled embeddings and
    the micro-conditioning time ids."""

    def __init__(self, cell: "EditCell", gen: torch.Generator, batch: int):
        c, dev = cell.config, cell.device
        px, L, D = c["resolution"], c["text_len"], c["unet"]["cross_attention_dim"]
        self.images = torch.rand((batch, px, px, 3), generator=gen, device=dev)
        cond = torch.randn((batch, L, D), generator=gen, device=dev)
        self.cond_embeds = cond[:, None].contiguous()
        self.cfg_embeds = torch.stack([cell.empty.expand(batch, -1, -1), cond], dim=1)
        self.pooled = None
        if cell.xl:
            self.pooled = torch.randn((batch, cell.pooled_empty.shape[1]), generator=gen,
                                      device=dev)

    def rows(self, idx: List[int]) -> dict:
        return {"images": self.images[idx], "cfg_embeds": self.cfg_embeds[idx],
                "cond_embeds": self.cond_embeds[idx],
                "pooled": None if self.pooled is None else self.pooled[idx]}


class EditCell:
    name = "edit"

    def __init__(self, cell: dict, config: dict, traffic: dict, seed: int,
                 device: torch.device):
        self.cell, self.config, self.traffic, self.seed = cell, config, traffic, seed
        self.device = device
        self.batch = traffic["batch"]
        self.nto = traffic["nto"]
        self.follow = cell.get("follow_program", False)
        self.nto_calls: Optional[List[dict]] = None
        self.xl = is_xl(config)
        self.steps = config["num_inference_steps"]

    # -- set-up --------------------------------------------------------------

    def _pipeline(self, steps: int):
        from rgie_tpu_torch.diffusion import schedulers as SCH
        from rgie_tpu_torch.diffusion.pipeline import InversionResamplingPipeline

        sigma = {}
        if self.xl:
            sigma = {name: SCH.make_dpm_sigma_schedule(steps, use_karras_sigmas=True,
                                                       use_lu_lambdas=True, inverse=inverse)
                     for name, inverse in (("sigma_sched", False), ("sigma_sched_inv", True))}
        return InversionResamplingPipeline(
            unet=self.unet, vae=self.vae, sched=SCH.make_schedule(steps), midu_model=self.midu,
            is_xl=self.xl, scheduler_type="dpm" if self.xl else "ddim", **sigma)

    def _program(self, pipe, num_inner: int):
        from rgie_tpu_torch.diffusion.batched import make_batched_edit

        c = self.config
        return make_batched_edit(pipe, guidance_scale=c["guidance_scale"],
                                 guidance_clf_scale=c["clf_scale"], use_nto=self.nto,
                                 num_inner_steps=num_inner, nto_epsilon=c["nto_epsilon"])

    def setup(self) -> None:
        from rgie_tpu_torch.diffusion.unet import UNet2DCondition
        from rgie_tpu_torch.diffusion.vae import AutoencoderKL
        from rgie_tpu_torch.models.midu import MiduSD, MiduSDXL

        c, dev, seed = self.config, self.device, self.seed
        t0 = time.perf_counter()
        served = getattr(torch, c["dtype"]["unet_vae"])
        with torch.device(dev):
            unet = UNet2DCondition(unet_config(c))
            vae = AutoencoderKL(vae_config(c))
            midu = (MiduSDXL if self.xl else MiduSD)(2, c["unet"]["block_out_channels"][-1])
        for module, salt in ((unet, "unet"), (vae, "vae"), (midu, "midu")):
            common.fill_weights_(module, seed, salt)
            module.eval().requires_grad_(False)
        self.unet, self.vae, self.midu = unet.to(served), vae.to(served), midu
        self.pipe = self._pipeline(self.steps)
        if self.follow and self.nto:
            self._record_null_text(self.pipe)
        self.program = self._program(self.pipe, c["num_inner_steps"])
        self.empty_inputs()
        t1 = time.perf_counter()
        # Every shape of the window, once: a one-step edit of a full batch
        # with one inner step, on its own draws.
        warm = self._program(self._pipeline(1), 1)
        self.run_batch(warm, Inputs(self, torch.Generator(device=dev).manual_seed(
            common.derive_seed(seed, "warm")), self.batch))
        self.setup_parts = {"models_s": t1 - t0, "warm_up_s": time.perf_counter() - t1}

    def _record_null_text(self, pipe) -> None:
        """While ``self.nto_calls`` is a list, append to it the state and the
        results of the first null-text inner step at each timestep: the
        embeddings, latents and pivot it starts from, and its gradient to
        the embeddings. The program's own call runs unchanged;
        the record keeps references to what it was given and returned."""
        real = pipe.null_inner_loss_and_grad

        def recorded(uncond, lat_cur, t, eps_cond, lat_prev, *args, **kwargs):
            loss, grad = real(uncond, lat_cur, t, eps_cond, lat_prev, *args, **kwargs)
            calls = self.nto_calls
            if calls is not None and all(c["t"] != t for c in calls):
                calls.append({"t": t, "uncond": uncond, "lat": lat_cur, "target": lat_prev,
                              "grad": grad})
            return loss, grad

        object.__setattr__(pipe, "null_inner_loss_and_grad", recorded)

    def empty_inputs(self) -> None:
        """The inputs every batch shares, drawn from the seed: the empty
        prompt's embeddings and, for SDXL, its pooled embeddings and the
        time ids."""
        c, dev = self.config, self.device
        gen = torch.Generator(device=dev).manual_seed(common.derive_seed(self.seed, "fixed"))
        L, D = c["text_len"], c["unet"]["cross_attention_dim"]
        self.empty = torch.randn((1, L, D), generator=gen, device=dev)
        self.pooled_empty = self.time_ids = None
        if self.xl:
            pooled = c["unet"]["projection_class_embeddings_input_dim"] - 6 * c["unet"][
                "addition_time_embed_dim"]
            self.pooled_empty = torch.randn((1, pooled), generator=gen, device=dev)
            px = c["resolution"]
            self.time_ids = torch.tensor([[px, px, 0, 0, px, px]], dtype=torch.float32,
                                         device=dev)

    # -- the program's calls ---------------------------------------------------

    def _call_args(self, inp: Inputs):
        from rgie_tpu_torch.diffusion.batched import BatchedConds
        from rgie_tpu_torch.diffusion.pipeline import SdxlCond

        b = inp.images.shape[0]
        alphas = torch.zeros((b, 2), device=self.device)
        if not self.xl:
            return (inp.images, self.empty, BatchedConds(inp.cfg_embeds, inp.cond_embeds),
                    alphas, None)
        pe = self.pooled_empty.expand(b, -1)
        tid = self.time_ids.expand(b, -1)

        def added(*pooled):
            return SdxlCond(torch.stack(pooled, dim=1),
                            torch.stack([tid] * len(pooled), dim=1))

        conds = BatchedConds(inp.cfg_embeds, inp.cond_embeds, added_cfg=added(pe, inp.pooled),
                             added_cond=added(inp.pooled), added_uncond=added(pe))
        return inp.images, self.empty, conds, alphas, SdxlCond(self.pooled_empty, self.time_ids)

    def run_batch(self, program, inp: Inputs):
        from rgie_tpu_torch.diffusion.pipeline import RunLog

        log = RunLog()
        out = program(*self._call_args(inp), log=log)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out, log

    # -- the window ------------------------------------------------------------

    def window(self, seconds: float) -> dict:
        """Whole batches until ``seconds`` have passed. Returns the wall
        seconds, the images, and what each batch's ``RunLog`` said."""
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(common.derive_seed(self.seed, "window"))
        checked = common.derive_seed(self.seed, "checked batch") % CHECKED_BATCH_CHOICES
        logs, ends, self.kept = [], [], None
        t0 = time.perf_counter()
        while True:
            inp = Inputs(self, gen, self.batch)
            keep = len(logs) <= checked
            self.nto_calls = [] if keep and self.follow else None
            out, log = self.run_batch(self.program, inp)
            if keep:
                if self.kept is not None:
                    self.kept[2].tensors.clear()
                self.kept = (inp, out, log, self.nto_calls)
            else:
                log.tensors.clear()
            logs.append(log)
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= seconds:
                break
        self.nto_calls = None
        return {"wall_s": ends[-1], "images": self.batch * len(logs), "batches": len(logs),
                "batch_s": [b - a for a, b in zip([0.0] + ends, ends)], "logs": logs}

    def e2e(self, win: dict) -> Dict[str, float]:
        """Seconds per image, under each name a cell may report it by: SDXL's
        cells report ``s_per_image.xl``, whose bound is its own."""
        s = win["wall_s"] / win["images"]
        return {"s_per_image": s, "s_per_image.xl": s}

    # -- the traced run ----------------------------------------------------------

    def trace_context(self, win: dict) -> dict:
        """Everything the per-layer readers may read: the untraced window's
        FLOPs and phase seconds, then one more batch under the profiler."""
        from rgie_tpu_torch.ops.kernels import flash_attention as fa

        from benchmark.trace import recorded_launches, traced

        kinds = flops.edit_kinds(self.config)
        inv = len(self.pipe.invert_tables()[0])
        smp = len(self.pipe.sample_tables()[0])
        total = sum(flops.edit_flops(kinds, self.batch, inv, smp, log.nto_inner_steps, self.nto)
                    for log in win["logs"])
        inner = sum(sum(log.nto_inner_steps) for log in win["logs"])
        ctx = {
            "kind": "edit", "wall_s": win["wall_s"], "flops": total,
            "nto_s": sum(log.seconds.get("nto", 0.0) for log in win["logs"]),
            "nto_inner": inner,
            "sample_s": sum(log.seconds.get("sample", 0.0) for log in win["logs"]),
            "sample_steps": smp * win["batches"],
        }
        gen = torch.Generator(device=self.device).manual_seed(
            common.derive_seed(self.seed, "traced"))
        inp = Inputs(self, gen, self.batch)
        before = {k: getattr(fa, n) for k, n in K2_COUNTERS.items()}
        box = {}
        with recorded_launches(fa, K2_LAUNCHERS) as calls:
            tr = traced(lambda: box.update(log=self.run_batch(self.program, inp)[1]))
        launches = {k: getattr(fa, n) - before[k] for k, n in K2_COUNTERS.items()}
        log = box["log"]
        shapes = collections.Counter(calls)
        ctx.update(trace=tr, launches=launches,
                   k2_shapes=[[k, list(s), w, n] for (k, s, w), n in sorted(shapes.items())],
                   fwd_equivalents=self.batch * flops.unet_forward_equivalents(
                       inv, smp, log.nto_inner_steps, self.nto),
                   k2_least_s=k2_least_seconds(calls, launches),
                   inner_per_outer=list(log.nto_inner_steps))
        return ctx

    # -- the check -----------------------------------------------------------------

    def free_program(self) -> None:
        for name in ("program", "pipe", "unet", "vae", "midu"):
            if hasattr(self, name):
                delattr(self, name)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_models(self, precision: Dict[str, str]) -> ref_edit.Models:
        """The plain networks on the device with the program's weights: the
        same draws, rounded once to the served type where the program serves
        in it."""
        c, dev = self.config, self.device
        served = getattr(torch, c["dtype"]["unet_vae"])
        with torch.device(dev):
            unet = nets.frozen(nets.UNet(common.plain_unet_config(c)))
            vae = nets.frozen(nets.Vae(c["vae"]))
            midu = nets.frozen(nets.Midu(self.xl, c["unet"]["block_out_channels"][-1]))
        for module, salt in ((unet, "unet"), (vae, "vae"), (midu, "midu")):
            common.fill_weights_(module, self.seed, salt)
        with torch.no_grad():
            for module in (unet, vae):
                for p in module.parameters():
                    p.copy_(p.to(served).float())
        set_precision(unet, precision["unet_vae"])
        set_precision(vae, precision["unet_vae"])
        set_precision(midu, precision["midu"])
        cfg = dict(c, nto=self.nto)
        return ref_edit.Models(unet, vae, midu, cfg)

    checked_count = CHECKED_ROWS

    def checked_rows(self) -> List[int]:
        """``CHECKED_ROWS`` rows drawn from the seed, one from each of as many
        equal parts of the batch, so that two rows cover both halves."""
        gen = torch.Generator().manual_seed(common.derive_seed(self.seed, "checked rows"))
        parts = CHECKED_ROWS
        bounds = [self.batch * i // parts for i in range(parts + 1)]
        return [int(torch.randint(lo, hi, (1,), generator=gen)) for lo, hi in
                zip(bounds[:-1], bounds[1:])]

    def reference(self, rows: dict, precision: Dict[str, str],
                  rescore: Optional[torch.Tensor] = None,
                  state: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """The reference edit of ``rows`` in ``precision``; with ``rescore``,
        also the reference's VA of those (the other side's) edited images;
        with ``state`` (the other side's stages), only what ``follow``
        computes from it."""
        m = self.reference_models(precision)
        added = None
        if self.xl:
            b = rows["images"].shape[0]
            pe, tid = self.pooled_empty.expand(b, -1), self.time_ids.expand(b, -1)
            added = {"empty": (self.pooled_empty, self.time_ids),
                     "cfg": (torch.stack([pe, rows["pooled"]], 1), torch.stack([tid, tid], 1)),
                     "cond": (rows["pooled"][:, None], tid[:, None]),
                     "uncond": (pe[:, None], tid[:, None])}
        with torch.no_grad():
            if state is not None:
                out = ref_edit.follow(m, rows["images"], self.empty, rows["cfg_embeds"], state,
                                      added)
            else:
                out = ref_edit.edit(m, rows["images"], self.empty, rows["cfg_embeds"],
                                    rows["cond_embeds"], added)
            if rescore is not None:
                out["rescored"] = ref_edit.score(m, rescore, self.empty,
                                                 added and added["empty"])
        del m
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return out

    def program_stages(self, idx: List[int]) -> Dict[str, torch.Tensor]:
        _, out, log, calls = self.kept
        t = log.tensors
        stages = {"latents": t["latents"][idx], "noisy": t["noisy"][idx],
                  "out_latents": t["out_latents"][idx], "edited": out.edited[idx],
                  "orig_score": out.orig_score[idx], "adapted_score": out.adapted_score[idx]}
        if self.nto:
            stages["nto_embeds"] = t["nto_embeds"][:, idx]
        if calls:
            stages["nto_t"] = torch.tensor([c["t"] for c in calls])
            for key in ref_edit.NTO_STEP_KEYS:
                stages[f"nto_{key}"] = torch.stack([c[key][idx] for c in calls])
        return stages

    def numbers(self, got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]
                ) -> Dict[str, float]:
        """Each stage's gap, the largest over the checked rows: the relative
        L2 gap of the latents after the encode, after the inversion and after
        sampling, of the null-text embeddings' movement from the empty
        prompt's, and of the edited images; of the VA scores of the input and
        of the other side's edited images (the reference scoring those), each
        image's two scores as one vector. Followed from the other side's
        state: of the first null-text gradient at each timestep (``nto_grad``,
        the largest over timesteps and rows)."""
        n = {"encode": common.rows_gap(got["latents"], ref["latents"]),
             "invert": common.rows_gap(got["noisy"], ref["noisy"])}
        if "sample" in ref:     # followed from the other side's state
            n["sample"] = common.rows_gap(got["out_latents"], ref["sample"])
            n["decode"] = common.rows_gap(got["edited"], ref["decode"])
            if "nto_grad" in ref:
                n["nto_grad"] = max(common.rows_gap(g, r) for g, r in
                                    zip(got["nto_grad"], ref["nto_grad"]))
            return n
        n["sample"] = common.rows_gap(got["out_latents"], ref["out_latents"])
        n["decode"] = common.rows_gap(got["edited"], ref["edited"])
        if "nto_embeds" in ref:
            e = self.empty[None].double()
            n["nto"] = common.rows_gap((got["nto_embeds"].double() - e).transpose(0, 1),
                                       (ref["nto_embeds"].double() - e).transpose(0, 1))
        if "rescored" in ref:
            n["score"] = max(common.rows_gap(got["orig_score"], ref["orig_score"]),
                             common.rows_gap(got["adapted_score"], ref["rescored"]))
        return n

    def check(self) -> Dict[str, float]:
        """The program's stages for the checked rows against the float32
        reference, once the program is freed. Where the reference follows
        the program (``follow_program`` cells), it also works out the first
        null-text inner step at each timestep from the program's state there,
        and its gradient to the embeddings is compared."""
        idx = self.checked_rows()
        inp = self.kept[0]
        got = {k: v.detach().clone() for k, v in self.program_stages(idx).items()}
        rows = inp.rows(idx)
        self.kept = None
        self.free_program()
        return self.numbers(got, self.reference(rows, EXACT, **self._judge(got)))

    def _judge(self, got: Dict[str, torch.Tensor]) -> dict:
        """How the float32 reference judges ``got``: following its state
        (``follow_program`` cells), or on its own and rescoring its edits."""
        if self.follow:
            return {"state": got}
        return {"rescore": got["edited"]} if "score" in self.cell.get("limits", {}) else {}

    def control(self, inp: Inputs) -> Dict[str, float]:
        """The control: the reference one step below each part's type (float8
        for the bfloat16 UNet and VAE, TF32 for the float32 midu) in the
        program's place, on the checked rows of ``inp``, one row at a time;
        the largest of each number over the rows."""
        worst: Dict[str, float] = {}
        for row in self.checked_rows():
            rows = inp.rows([row])
            lowered = self.reference(rows, LOWERED)
            numbers = self.numbers(lowered, self.reference(rows, EXACT, **self._judge(lowered)))
            worst = {k: max(v, worst.get(k, 0.0)) for k, v in numbers.items()}
        return worst


def k2_least_seconds(calls: List[tuple], launches: Dict[str, int]) -> Optional[float]:
    """The least time of the K2 launches recorded, each at its own shape;
    None where none ran, or where the record and the launch counters
    disagree."""
    seen = {k: sum(1 for c in calls if c[0] == k) for k in launches}
    if not calls or seen != launches:
        return None
    return flops.launches_least_seconds(calls)


CELL = EditCell
