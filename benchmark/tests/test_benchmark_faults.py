"""A whole run of a tiny cell on the CPU (the look for a card left out),
with the timed path broken underneath, comes out not correct under the
cells' own limits: a step that returns its state unchanged, half of the
batch left out, an answer altered where it is produced. (The cells run on
one card and exchange nothing between cards, so there is no exchange to
leave out.)"""

from __future__ import annotations

import pytest
import torch

from benchmark import common
from benchmark.tests.test_benchmark_reference import drive


def limits(workload: str) -> dict:
    return common.cell_files(workload)[0]["limits"]


def _unchanged_sampling(monkeypatch):
    from rgie_tpu_torch.diffusion.pipeline import InversionResamplingPipeline

    monkeypatch.setattr(InversionResamplingPipeline, "sample_steps",
                        lambda self, latents, state, *a, **k: (latents, state))


def _unchanged_null_text(monkeypatch):
    from rgie_tpu_torch.diffusion.pipeline import InversionResamplingPipeline

    real = InversionResamplingPipeline.null_inner_loss_and_grad

    def no_step(self, *args, **kwargs):
        loss, grad = real(self, *args, **kwargs)
        return loss, torch.zeros_like(grad)

    monkeypatch.setattr(InversionResamplingPipeline, "null_inner_loss_and_grad", no_step)


def _half_batch(monkeypatch):
    from rgie_tpu_torch.diffusion.pipeline import InversionResamplingPipeline

    real = InversionResamplingPipeline.encode_image

    def half(self, image, generator=None):
        b = image.shape[0]
        lat = real(self, image[:b // 2], generator)
        return lat.repeat(2, 1, 1, 1)[:b]

    monkeypatch.setattr(InversionResamplingPipeline, "encode_image", half)


def _altered_answer(monkeypatch):
    from rgie_tpu_torch.diffusion.pipeline import InversionResamplingPipeline

    real = InversionResamplingPipeline.decode_latents

    def altered(self, latents):
        img = real(self, latents)
        return torch.cat([1.0 - img[..., :1], img[..., 1:]], dim=-1)

    monkeypatch.setattr(InversionResamplingPipeline, "decode_latents", altered)


EDIT_FAULTS = {"sampling unchanged": _unchanged_sampling,
               "null-text unchanged": _unchanged_null_text,
               "half the batch": _half_batch, "altered answer": _altered_answer}


@pytest.mark.parametrize("traffic,workload", [("edit", "sd21-512-nto-b8"),
                                              ("xl", "sdxl-1024-nto-b2"),
                                              ("guided", "sd21-512-guided-b8"),
                                              ("train", "sd21-512-train-b8")])
def test_unbroken_runs_are_correct_under_the_cells_limits(traffic, workload):
    assert drive(traffic, limits=limits(workload))["correct"]


#: (tiny traffic, the cell whose limits judge it). In the SDXL cell the
#: reference follows the program's null-text state, and its first inner
#: step's gradient catches a null-text step that moves nothing.
EDIT_CELLS = {"edit": "sd21-512-nto-b8", "xl": "sdxl-1024-nto-b2"}


@pytest.mark.parametrize("traffic,fault", [(t, f) for t in sorted(EDIT_CELLS)
                                           for f in sorted(EDIT_FAULTS)])
def test_edit_fault_is_not_correct(monkeypatch, traffic, fault):
    EDIT_FAULTS[fault](monkeypatch)
    result = drive(traffic, limits=limits(EDIT_CELLS[traffic]))
    assert not result["correct"], result["checks"]
    assert result["failed"] > 0


class _StillAdam(torch.optim.Adam):
    def step(self, closure=None):
        return None


def _train_unchanged(monkeypatch):
    from rgie_tpu_torch.training import train_midu

    monkeypatch.setattr(train_midu, "make_optimizer",
                        lambda params, cfg: _StillAdam(params, lr=cfg.learning_rate))


def _train_half(monkeypatch):
    from rgie_tpu_torch.training import train_midu

    monkeypatch.setattr(train_midu, "_mse",
                        lambda out, labels: torch.mean((out[: out.shape[0] // 2]
                                                        - labels[: out.shape[0] // 2]) ** 2))


def _train_altered_labels(monkeypatch):
    from rgie_tpu_torch.training.clf_wrapper import ClfWrapper

    real = ClfWrapper.get_label
    monkeypatch.setattr(ClfWrapper, "get_label", lambda self, images: 1.0 - real(self, images))


TRAIN_FAULTS = {"state unchanged": _train_unchanged, "half the batch": _train_half,
                "altered labels": _train_altered_labels}


@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
def test_train_fault_is_not_correct(monkeypatch, fault):
    TRAIN_FAULTS[fault](monkeypatch)
    result = drive("train", limits=limits("sd21-512-train-b8"))
    assert not result["correct"], result["checks"]
