"""ControlNet of the port against ``rgie_tpu`` on the CPU, tiny configs (SD's
block structure and SDXL's with its added conds): a fresh ControlNet is the
identity on the UNet's output, a perturbed one changes it, it emits one
residual per UNet skip plus the mid block's, and ``controlled_unet_apply``'s
output, mid features and gradients (to the latents and to the control image)
equal JAX's. Weights: a JAX ControlNet with its zero convolutions drawn at
random goes to the port through ``from_jax.controlnet_state_dict``
(``strict=True``); the UNet goes port -> ``torch_convert`` -> JAX.

Tolerances: float32 on both sides, one forward (and its backward) of a UNet
and a ControlNet: 2e-5 relative to the largest entry, as the UNet's own
parity test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgie_tpu.utils import torch_convert as TC
from rgie_tpu_torch.diffusion.controlnet import (ControlNet, controlled_unet_apply,
                                                 create_controlnet)
from rgie_tpu_torch.diffusion.unet import UNetConfig, create_unet
from rgie_tpu_torch.utils.from_jax import controlnet_state_dict

torch.set_num_threads(2)

HW, L, TOL = 8, 6, 2e-5
CONFIGS = {"sd": UNetConfig.tiny, "sdxl": UNetConfig.tiny_xl}


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    arr = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    out = dict(lat=arr(2, HW, HW, 4), ctx=arr(2, L, cfg.cross_attention_dim),
               cond=rng.uniform(0, 1, (2, 8 * HW, 8 * HW, 3)).astype(np.float32),
               w=arr(2, HW, HW, 4), t=np.array([10, 700], np.int32))
    if cfg.addition_embed_type == "text_time":
        out.update(added_text_embeds=arr(2, cfg.addition_pooled_dim),
                   added_time_ids=np.tile(np.array([[64, 64, 0, 0, 64, 64]], np.float32),
                                          (2, 1)))
    return out


def _added(x, as_array):
    return {k: as_array(x[k]) for k in ("added_text_embeds", "added_time_ids") if k in x}


def test_fresh_controlnet_is_the_identity_and_a_perturbed_one_is_not():
    cfg = UNetConfig.tiny()
    g = torch.Generator().manual_seed(0)
    unet, cn = create_unet(g, cfg), create_controlnet(g, cfg)
    x = {k: torch.from_numpy(v) for k, v in _inputs(cfg).items()}
    eps, mid = unet(x["lat"], x["t"], x["ctx"])
    eps_c, mid_c = controlled_unet_apply(unet, cn, x["lat"], x["t"], x["ctx"], x["cond"])
    assert torch.equal(eps_c, eps) and torch.equal(mid_c, mid)
    with torch.no_grad():
        cn.controlnet_mid_block.bias.fill_(0.1)
    eps_p, mid_p = controlled_unet_apply(unet, cn, x["lat"], x["t"], x["ctx"], x["cond"])
    assert float((eps_p - eps).abs().max()) > 1e-3
    assert torch.allclose(mid_p, mid + 0.1)        # the mid residual lands on the tap


@pytest.mark.parametrize("name", list(CONFIGS))
def test_one_residual_per_unet_skip(name):
    cfg = CONFIGS[name]()
    cn = create_controlnet(torch.Generator().manual_seed(0), cfg, conditioning_scale=0.5)
    x = {k: torch.from_numpy(v) for k, v in _inputs(cfg).items()}
    down, mid = cn(x["lat"], x["t"], x["ctx"], x["cond"], **_added(x, lambda a: a))
    n = len(cfg.block_out_channels)
    assert len(down) == 1 + n * cfg.layers_per_block + (n - 1)
    # the skips' shapes, NHWC: the input level, each block's outputs, the downsamples
    assert down[0].shape == (2, HW, HW, cfg.block_out_channels[0])
    assert down[-1].shape == (2, HW // 2 ** (n - 1), HW // 2 ** (n - 1), cfg.block_out_channels[-1])
    assert mid.shape == down[-1].shape
    assert all(float(r.abs().max()) == 0.0 for r in down + [mid])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_controlled_unet_matches_jax(name):
    from rgie_tpu.diffusion import controlnet as C_j
    from rgie_tpu.diffusion import unet as U_j

    cfg = CONFIGS[name]()
    cfg_j = getattr(U_j.UNetConfig, "tiny" if name == "sd" else "tiny_xl")()
    g = torch.Generator().manual_seed(1)
    unet = create_unet(g, cfg)
    unet_vars = jax.tree.map(jnp.asarray, TC.convert_unet_diffusers(
        {k: v.numpy() for k, v in unet.state_dict().items()}, cfg_j))
    model_j, cn_vars = C_j.create_controlnet(jax.random.PRNGKey(2), cfg_j, sample_hw=HW,
                                             context_len=L, conditioning_scale=0.5)
    # Zero convolutions drawn away from zero, so that the residuals carry weight.
    rng = np.random.default_rng(3)
    cn_vars = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(rng.standard_normal(a.shape).astype(np.float32) * 0.1)
        if any("zero_conv" in str(p) or "conv_out" in str(p) for p in path) else a, cn_vars)
    cn = ControlNet(cfg, conditioning_scale=0.5)
    cn.load_state_dict(controlnet_state_dict(jax.tree.map(np.asarray, cn_vars), cfg),
                       strict=True)

    x = _inputs(cfg, seed=4)
    unet_j = U_j.UNet2DCondition(cfg_j)

    def loss_j(lat, cond):
        eps, mid = C_j.controlled_unet_apply(unet_j, unet_vars, model_j, cn_vars, lat,
                                             jnp.asarray(x["t"]), jnp.asarray(x["ctx"]), cond,
                                             **_added(x, jnp.asarray))
        return jnp.sum(eps * x["w"]) + jnp.sum(mid), (eps, mid)

    (_, (eps_j, mid_j)), (g_lat_j, g_cond_j) = jax.jit(jax.value_and_grad(
        loss_j, argnums=(0, 1), has_aux=True))(jnp.asarray(x["lat"]), jnp.asarray(x["cond"]))

    lat = torch.from_numpy(x["lat"]).requires_grad_(True)
    cond = torch.from_numpy(x["cond"]).requires_grad_(True)
    eps, mid = controlled_unet_apply(unet, cn, lat, torch.from_numpy(x["t"]),
                                     torch.from_numpy(x["ctx"]), cond,
                                     **_added(x, torch.from_numpy))
    (torch.sum(eps * torch.from_numpy(x["w"])) + torch.sum(mid)).backward()

    for got, expect in ((eps, eps_j), (mid, mid_j), (lat.grad, g_lat_j), (cond.grad, g_cond_j)):
        expect = np.asarray(expect)
        scale = np.abs(expect).max()
        assert scale > 0
        np.testing.assert_allclose(got.detach().numpy() / scale, expect / scale, atol=TOL)
