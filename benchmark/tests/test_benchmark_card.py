"""On the card, at each cell's own size: the control (the reference one step
below each part's type, in the program's place) comes out not correct under
the cell's limits. Run there with

    python3 -m pytest benchmark/tests/test_benchmark_card.py -m cuda -p no:cacheprovider

Each case takes one to two minutes (two reference edits, or three reference
training steps, at full width)."""

from __future__ import annotations

import pytest
import torch

from benchmark import common, run

SEED = 2 ** 32 + 2024


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cells' full sizes")
    return run.require_device(1)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["sd21-512-nto-b8", "sdxl-1024-nto-b2", "sd21-512-train-b8",
                                      "sd21-512-guided-b8"])
def test_control_is_not_correct(workload):
    device = card()
    cell, config, traffic = common.cell_files(workload)
    runner = run.cell_class(traffic["kind"])(cell, config, traffic, SEED, device)
    if traffic["kind"] == "train":
        runner.setup()
        runner.free_program()
        numbers = runner.control()
    else:
        from benchmark.kinds.edit import Inputs

        runner.empty_inputs()
        gen = torch.Generator(device=device).manual_seed(common.derive_seed(SEED, "window"))
        numbers = runner.control(Inputs(runner, gen, runner.batch))
    limits = cell["limits"]
    assert any(numbers[k] > limits[k] for k in limits), numbers
