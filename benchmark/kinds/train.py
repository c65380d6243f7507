"""Midu training: ``cli/train_guidance_clf.features_and_labels`` followed by
``training/train_midu.make_train_step()`` of ``rgie_tpu_torch``, one fresh
batch of random images per step.

Set-up makes every weight on the device from the seed, builds the stack the
CLI builds (bfloat16 UNet and VAE, float32 teacher and midu) and drives the
training state through its first three steps, through the window's own call
and feed on rows that all differ; that is the warm-up too. The window goes on
training the same state. The check follows those three steps with the plain
float32 reference and compares the teacher's labels, the mid-block features,
each step's loss, the first gradient as Adam got it and each parameter's
change over the three steps.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from benchmark import common, flops
from benchmark.kinds.edit import is_xl, unet_config, vae_config
from benchmark.reference import nets
from benchmark.reference import train as ref_train
from benchmark.reference.precision import FLOAT32, FP8, TF32, set_precision

CHECKED_STEPS = 3
#: A leaf whose reference gradient is under this share of the median leaf's
#: moves under Adam by round-off alone and is left out of the change.
STILL_LEAF = 1e-3


class TrainCell:
    name = "train"

    def __init__(self, cell: dict, config: dict, traffic: dict, seed: int,
                 device: torch.device):
        self.cell, self.config, self.traffic, self.seed = cell, config, traffic, seed
        self.device = device
        self.batch = traffic["batch"]
        self.xl = is_xl(config)

    def setup(self) -> None:
        from rgie_tpu_torch.cli.train_guidance_clf import make_stack
        from rgie_tpu_torch.config import TrainGuidanceConfig
        from rgie_tpu_torch.diffusion.unet import UNet2DCondition
        from rgie_tpu_torch.diffusion.vae import AutoencoderKL
        from rgie_tpu_torch.losses.emotion_loss import ValenceArousalLoss
        from rgie_tpu_torch.models.emotion import EmotionRegressor
        from rgie_tpu_torch.models.midu import MiduSD, MiduSDXL
        from rgie_tpu_torch.models.resnet import resnet50
        from rgie_tpu_torch.training.clf_wrapper import ClfWrapper
        from rgie_tpu_torch.training.train_midu import create_train_state, make_train_step

        c, dev, seed = self.config, self.device, self.seed
        t0 = time.perf_counter()
        served = getattr(torch, c["dtype"]["unet_vae"])
        t = c["teacher"]
        with torch.device(dev):
            unet = UNet2DCondition(unet_config(c))
            vae = AutoencoderKL(vae_config(c))
            net = resnet50(t["num_classes"])
            midu = (MiduSDXL if self.xl else MiduSD)(2, c["unet"]["block_out_channels"][-1])
        for module, salt in ((unet, "unet"), (vae, "vae"), (net, "teacher"), (midu, "midu")):
            common.fill_weights_(module, seed, salt)
        for module in (unet, vae, net):
            module.eval().requires_grad_(False)
        regressor = EmotionRegressor(net, num_classes=t["num_classes"],
                                     input_size=t["input_size"], crop_size=t["crop_size"])
        teacher = ClfWrapper(loss=ValenceArousalLoss(regressor=regressor, loss_type="va"))
        self.stack = make_stack(unet.to(served), vae.to(served), teacher, c["resolution"])
        tc = TrainGuidanceConfig(batch_size=self.batch)
        self.state = create_train_state(midu, tc)
        self.step = make_train_step()
        self.noise_gen = torch.Generator(device=dev).manual_seed(
            common.derive_seed(seed, "noise"))
        self.image_gen = torch.Generator(device=dev).manual_seed(
            common.derive_seed(seed, "images"))

        # The first steps: the warm-up, and what the check follows.
        t1 = time.perf_counter()
        start = {n: p.detach().clone() for n, p in midu.named_parameters()}
        self.first = {"images": [], "features": [], "labels": [], "losses": []}
        for i in range(CHECKED_STEPS):
            images = self.images()
            feats, labels, loss = self.train_step(images)
            for key, value in (("images", images), ("features", feats), ("labels", labels),
                               ("losses", float(loss))):
                self.first[key].append(value)
            if i == 0:
                opt = self.state.optimizer
                b1 = opt.param_groups[0]["betas"][0]
                # Adam's first moment after one step is (1 - beta1) times the
                # gradient it took; no moment means it took none.
                self.first["first_grad"] = {
                    n: opt.state[p]["exp_avg"].detach() / (1 - b1) if "exp_avg" in opt.state[p]
                    else torch.zeros_like(p) for n, p in midu.named_parameters()}
        self.first["change"] = {n: p.detach() - start[n] for n, p in midu.named_parameters()}
        self.setup_parts = {"models_s": t1 - t0, "warm_up_s": time.perf_counter() - t1}

    def images(self) -> torch.Tensor:
        px = self.config["resolution"]
        return torch.rand((self.batch, px, px, 3), generator=self.image_gen, device=self.device)

    def train_step(self, images: torch.Tensor, spans: List[float] = None):
        from rgie_tpu_torch.cli.train_guidance_clf import features_and_labels

        if spans is not None:
            torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
        feats, labels = features_and_labels(self.stack, self.noise_gen, images)
        if spans is not None:
            torch.cuda.synchronize(self.device)
            spans.append(time.perf_counter() - t0)
        self.state, loss, _ = self.step(self.state, feats, labels)
        return feats, labels, loss

    def window(self, seconds: float, spans: List[float] = None) -> dict:
        steps = 0
        t0 = time.perf_counter()
        while True:
            _, _, loss = self.train_step(self.images(), spans)
            float(loss)      # the CLI reads every step's loss
            steps += 1
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        return {"wall_s": wall, "images": steps * self.batch, "steps": steps}

    def e2e(self, win: dict) -> Dict[str, float]:
        return {"train_img_per_s": win["images"] / win["wall_s"]}

    def trace_context(self, win: dict) -> dict:
        """The untraced window's FLOPs, a second window with a synchronised
        span around ``features_and_labels``, and a few steps under the
        profiler."""
        from benchmark.trace import traced

        spans: List[float] = []
        self.window(min(win["wall_s"], 10.0), spans)
        per_step = flops.train_step_flops(self.config, self.batch)
        ctx = {"kind": "train", "wall_s": win["wall_s"], "flops": per_step * win["steps"],
               "features_s": spans}
        tr = traced(lambda: self.window(3.0))
        ctx["trace"] = tr
        return ctx

    @property
    def checked_count(self) -> int:
        return CHECKED_STEPS * self.batch

    def free_program(self) -> None:
        for name in ("stack", "state", "step"):
            if hasattr(self, name):
                delattr(self, name)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: Dict[str, str], fault: str = "") -> dict:
        """The plain networks with the same weights follow the first steps:
        their images, the same timesteps and noise (replayed from the feed's
        generator seed), float32 throughout. ``fault`` plants one of the
        faults a limit is held against: ``half`` (the loss over half of each
        batch) or ``labels`` (the teacher's answers altered)."""
        c, dev = self.config, self.device
        served = getattr(torch, c["dtype"]["unet_vae"])
        t = c["teacher"]
        with torch.device(dev):
            unet = nets.frozen(nets.UNet(common.plain_unet_config(c)))
            vae = nets.frozen(nets.Vae(c["vae"]))
            teacher = nets.frozen(nets.Teacher(t["input_size"], t["crop_size"], t["num_classes"]))
            midu = nets.Midu(self.xl, c["unet"]["block_out_channels"][-1])
        for module, salt in ((unet, "unet"), (vae, "vae"), (teacher.net, "teacher"),
                             (midu, "midu")):
            common.fill_weights_(module, self.seed, salt)
        with torch.no_grad():
            for module in (unet, vae):
                for p in module.parameters():
                    p.copy_(p.to(served).float())
        set_precision(unet, precision["unet_vae"])
        set_precision(vae, precision["unet_vae"])
        set_precision(teacher, precision["float32"])
        set_precision(midu, precision["float32"])
        gen = torch.Generator(device=dev).manual_seed(common.derive_seed(self.seed, "noise"))
        hw = c["resolution"] // 2 ** (len(c["vae"]["block_out_channels"]) - 1)
        feats, labels = [], []
        for images in self.first["images"]:
            tt, noise = ref_train.draw_t_and_noise(gen, (images.shape[0], hw, hw,
                                                         c["vae"]["latent_channels"]))
            f, lab = ref_train.features_and_labels(teacher, vae, unet, images, tt, noise)
            feats.append(f)
            labels.append(lab)
        del unet, vae, teacher
        if fault == "labels":
            labels = [1.0 - lab for lab in labels]
        keep = slice(None, self.batch // 2 if fault == "half" else None)
        out = ref_train.train_steps(midu, [(f[keep], lab[keep]) for f, lab in zip(feats, labels)])
        out.update(features=feats, labels=labels)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return out

    def numbers(self, got: dict, ref: dict) -> Dict[str, float]:
        """The largest gaps over the checked steps: of the labels and of the
        features (relative L2, per image), of each step's loss (relative);
        the worst leaf's gap of norms of the first gradient, and of the
        change over the steps for the leaves that move."""
        grads = ref["first_grad"]
        norms = {n: float(g.double().norm()) for n, g in grads.items()}
        median = common.medianf(list(norms.values()))
        moving = [n for n, v in norms.items() if v >= STILL_LEAF * median]
        return {
            "labels": max(common.rows_gap(a, b) for a, b in zip(got["labels"], ref["labels"])),
            "features": max(common.rows_gap(a, b)
                            for a, b in zip(got["features"], ref["features"])),
            "loss": max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])),
            "grad": common.leaf_norm_gap(got["first_grad"], grads),
            "change": common.leaf_norm_gap(got["change"], ref["change"], moving),
        }

    def check(self) -> Dict[str, float]:
        got = self.first
        self.free_program()
        return self.numbers(got, self.reference({"unet_vae": FLOAT32, "float32": FLOAT32}))

    def fault(self, name: str) -> Dict[str, float]:
        """A fault planted in the float32 reference put in the program's
        place, against the float32 reference."""
        return self.numbers(self.reference({"unet_vae": FLOAT32, "float32": FLOAT32}, name),
                            self.reference({"unet_vae": FLOAT32, "float32": FLOAT32}))

    def control(self) -> Dict[str, float]:
        """The reference one step below each part's type (float8 for the
        bfloat16 UNet and VAE, TF32 for the float32 teacher and midu) in the
        program's place."""
        exact = self.reference({"unet_vae": FLOAT32, "float32": FLOAT32})
        lowered = self.reference({"unet_vae": FP8, "float32": TF32})
        return self.numbers(lowered, exact)


CELL = TrainCell
