"""The plain reference at a tiny size: it repeats itself, it carries the
program's parameter names, it agrees with the program run in float32 on the
CPU, and it loads nothing of the program, of JAX or of the JAX package."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import common, run
from benchmark.kinds.edit import EditCell, Inputs
from benchmark.reference import nets
from benchmark.reference.precision import FLOAT32
from benchmark.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
EDIT_LIMITS = {k: 1e-4 for k in ("encode", "invert", "nto", "sample", "decode", "score")}
FOLLOW_LIMITS = {k: 1e-4 for k in ("encode", "invert", "nto_grad", "sample", "decode")}
TRAIN_LIMITS = {k: 1e-4 for k in ("labels", "features", "loss", "grad", "change")}
TRAFFIC = {"edit": {"kind": "edit", "batch": 2, "nto": True},
           "guided": {"kind": "edit", "batch": 2, "nto": False},
           "xl": {"kind": "edit", "batch": 2, "nto": True},
           "train": {"kind": "train", "batch": 2}}
#: The tiny cells whose reference follows the program's state, as SDXL's.
FOLLOW = {"xl"}


def drive(traffic: str, seed: int = 2 ** 33 + 5, limits=None):
    """A whole run of a tiny cell on the CPU, the look for a card left out."""
    t = TRAFFIC[traffic]
    if limits is None:
        if traffic in FOLLOW:
            limits = dict(FOLLOW_LIMITS)
        else:
            limits = dict(TRAIN_LIMITS if t["kind"] == "train" else EDIT_LIMITS)
            if not t.get("nto", True):
                limits.pop("nto")
    spec = common.read_json(ROOT / "BENCHMARK.json")
    return run.run_cell(spec, "tiny", tiny.cell("tiny", limits, traffic in FOLLOW),
                        tiny.config(traffic == "xl"), t, seed, 0.0, False, torch.device("cpu"),
                        0.0)


@pytest.mark.parametrize("traffic", sorted(TRAFFIC))
def test_program_agrees_with_reference_in_float32(traffic):
    result = drive(traffic)
    assert result["correct"], result["checks"]
    assert result["attempted"] == 2
    assert list(result)[-1] == "checks"


def test_reference_repeats_itself():
    cell = EditCell(tiny.cell("t", {}), tiny.config(False), TRAFFIC["edit"], 9,
                    torch.device("cpu"))
    cell.empty_inputs()
    inp = Inputs(cell, torch.Generator().manual_seed(3), 2)
    rows = inp.rows([0, 1])
    precision = {"unet_vae": FLOAT32, "midu": FLOAT32}
    a, b = cell.reference(rows, precision), cell.reference(rows, precision)
    assert set(a) == {"orig_score", "latents", "noisy", "nto_embeds", "out_latents", "edited",
                      "adapted_score", "nto_t", "nto_uncond", "nto_lat", "nto_target",
                      "nto_grad"}
    for key in a:
        assert torch.equal(a[key], b[key]), key
    # A row's result does not depend on the other rows. Batches of 1 and 2
    # sum in other orders on the CPU; the guidance step's unit-normalized
    # gradient of the tiny random midu turns that into ~1e-3 after sampling.
    single = cell.reference(inp.rows([1]), precision)
    for key, atol in (("noisy", 1e-5), ("edited", 1e-2)):
        assert torch.allclose(single[key][0], a[key][1], atol=atol), key
    assert torch.allclose(single["nto_embeds"][:, 0], a["nto_embeds"][:, 1], atol=1e-5)


@pytest.mark.parametrize("xl", [False, True])
def test_reference_carries_the_program_names(xl):
    from benchmark.kinds.edit import unet_config, vae_config
    from rgie_tpu_torch.diffusion.unet import UNet2DCondition
    from rgie_tpu_torch.diffusion.vae import AutoencoderKL

    cfg = tiny.config(xl)
    pairs = [(UNet2DCondition(unet_config(cfg)), nets.UNet(common.plain_unet_config(cfg))),
             (AutoencoderKL(vae_config(cfg)), nets.Vae(cfg["vae"]))]
    for program, reference in pairs:
        shapes = {n: tuple(p.shape) for n, p in program.named_parameters()}
        assert shapes == {n: tuple(p.shape) for n, p in reference.named_parameters()}


def _loaded(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded("import sys, json; import benchmark.reference.edit, "
                     "benchmark.reference.train, benchmark.reference.nets; "
                     "print(json.dumps(sorted(sys.modules)))")
    assert common.forbidden_modules(loaded, common.FORBIDDEN_IN_REFERENCE) == []


def test_harness_loads_no_jax():
    loaded = _loaded("import sys, json; import benchmark.run, benchmark.calibrate; "
                     "import benchmark.kinds.edit, benchmark.kinds.train; "
                     "import rgie_tpu_torch.diffusion.batched, "
                     "rgie_tpu_torch.cli.train_guidance_clf, rgie_tpu_torch.training.train_midu; "
                     "print(json.dumps(sorted(sys.modules)))")
    assert "rgie_tpu_torch" in loaded
    assert common.forbidden_modules(loaded) == []


def test_forbidden_names_compare_the_whole_top_level_name():
    names = ["rgie_tpu_torch.diffusion", "jaxtyping", "jax.numpy", "rgie_tpu", "flaxen", "flax"]
    assert common.forbidden_modules(names) == ["flax", "jax.numpy", "rgie_tpu"]
    assert common.forbidden_modules(names, common.FORBIDDEN_IN_REFERENCE) == [
        "flax", "jax.numpy", "rgie_tpu", "rgie_tpu_torch.diffusion"]


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "sd21-512-nto-b8",
                          "--seed", str(2 ** 31 + 11), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr
