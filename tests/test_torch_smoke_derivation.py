"""``chip_smoke.py``'s K2 launch derivations on the CPU.

The sites the gate admits in the full-width configurations equal the numbers
the smoke pins (a change of the gate has to change them on purpose), and
``derived_unet_launches`` (the count of forward and backward launches each
UNet call implies) equals the calls the flash-attention route makes in the
tiny SD and SDXL batched edits, null-text optimization and guidance on, with
the gate's threshold lowered to the tiny latents and the heads 8 wide.
"""

import dataclasses

import pytest

import chip_smoke as CS
from rgie_tpu_torch.diffusion import unet as U
from rgie_tpu_torch.ops.kernels import flash_attention as FA
from test_torch_spans import tiny_edit


def test_the_gates_sites_equal_the_pinned_numbers():
    CS.check_flash_sites()


@pytest.mark.parametrize("xl", [False, True], ids=["sd", "sdxl"])
def test_derived_unet_launches_equal_the_flash_routes_calls(monkeypatch, xl):
    tiny = U.UNetConfig.tiny
    monkeypatch.setattr(U.UNetConfig, "tiny", staticmethod(
        lambda cross_dim=32: dataclasses.replace(tiny(cross_dim), attention_head_dim=(1, 2))))
    monkeypatch.setattr(FA, "MIN_FLASH_SEQ_LEN", 16)
    pipe, run = tiny_edit(xl)[:2]
    counted = {"fwd": 0, "dkv": 0}
    fwd, bwd = FA.reference_flash_attention, FA.reference_flash_attention_bwd

    def counting(name, fn):
        def call(q, *args, **kwargs):
            if q.shape[-1] == 8:        # the UNet's heads; the VAE's one head is 16 wide
                counted[name] += 1
            return fn(q, *args, **kwargs)
        return call

    monkeypatch.setattr(FA, "reference_flash_attention", counting("fwd", fwd))
    monkeypatch.setattr(FA, "reference_flash_attention_bwd", counting("dkv", bwd))
    with CS.derived_unet_launches() as derived:
        log = run()
    assert CS.flash_sites(pipe.unet.cfg, 16) == (4, 2, 1)
    assert sum(log.nto_inner_steps) > 0 and derived["calls"] > 0
    assert (derived["fwd"], derived["dkv"]) == (counted["fwd"], counted["dkv"])
    assert counted["dkv"] > 0
