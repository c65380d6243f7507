"""Three places where the port behaved differently from ``rgie_tpu``, each held
to the JAX package on the CPU:

1. The bfloat16 diffusion edit keeps its text tower, its prompt embeddings,
   the null-text embeddings and their Adam moments in float32 (the JAX
   package's "bf16 UNet + fp32 embedding masters",
   ``rgie_tpu/diffusion/pipeline.py:18-19``): the tiny edit built by the
   CLI's ``build_models`` with ``--dtype bfloat16`` against ``rgie_tpu``'s
   bfloat16 UNet and VAE and float32 text tower with the same weights.
2. ``RGIE_FLASH_ATTN=0`` sends the attention modules to the matmul route
   (``rgie_tpu/diffusion/unet.py:159-164``).
3. A merges file that does not load falls back to the hash tokenizer
   (``rgie_tpu/diffusion/text_encoder.py:153-160``).

Tolerances of (1): the two packages run the same bfloat16 UNet and round its
activations to 8 significant bits at different places (normalisations, the
softmax, the convolutions' sums), so single results differ in the order of
bfloat16's step: the loss (a mean over every latent) to 2e-3 relative, its
gradient to 5e-2 of the largest entry (one bfloat16 step, 2^-8, compounded
through the backward). Adam divides by the gradient's root mean square, so an
entry whose small gradient changes sign under that rounding moves the other
way: after a null-text optimization the embeddings differ by at most two
steps of the learning rate per inner step taken, and by a tenth of one step
on average.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgie_tpu.utils import torch_convert as TC
from rgie_tpu_torch.diffusion.pipeline import RunLog
from rgie_tpu_torch.ops.kernels import flash_attention as FA

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, INNER, LR = 2, 2, 1e-2   # DDIM steps, null-text inner steps, SD's base rate


def _np_state(module):
    return {k: v.detach().float().numpy() for k, v in module.state_dict().items()}


@pytest.fixture(scope="module")
def bf16_stacks():
    """The CLI's tiny stack in bfloat16 and ``rgie_tpu``'s, the same weights."""
    from rgie_tpu.diffusion import pipeline as P_j
    from rgie_tpu.diffusion import schedulers as S_j
    from rgie_tpu.diffusion import text_encoder as TE_j
    from rgie_tpu.diffusion import unet as U_j
    from rgie_tpu.diffusion import vae as V_j
    from rgie_tpu.models import midu as M_j
    from rgie_tpu_torch.cli import adapt_images as cli

    args = cli.build_parser().parse_args(["--scale", "tiny", "--dtype", "bfloat16",
                                          "--num-steps", str(STEPS), "--device", "cpu"])
    stack = cli.build_models(args, torch.Generator().manual_seed(0), torch.device("cpu"))
    pipe, enc = stack.pipe, stack.prompt_encoder

    as_jax = lambda tree: jax.tree.map(jnp.asarray, tree)
    params_j = P_j.PipelineParams(
        unet=as_jax(TC.convert_unet_diffusers(_np_state(pipe.unet), U_j.UNetConfig.tiny())),
        vae=as_jax(TC.convert_vae_diffusers(_np_state(pipe.vae), V_j.VaeConfig.tiny())),
        midu=as_jax(TC.convert_midu(_np_state(pipe.midu_model), False)))
    pipe_j = P_j.InversionResamplingPipeline(
        unet=U_j.UNet2DCondition(U_j.UNetConfig.tiny(), dtype=jnp.bfloat16),
        vae=V_j.AutoencoderKL(V_j.VaeConfig.tiny(), jnp.bfloat16),
        sched=S_j.make_schedule(STEPS), midu_model=M_j.MiduSD(2))
    enc_j = TE_j.PromptEncoder(
        tower1=TE_j.TextEncoderHidden(**TE_j.TextTowerConfig.tiny()),
        variables1=as_jax(TC.convert_clip_text_hf(_np_state(enc.tower1), heads=2)))

    pivots = np.random.default_rng(3).standard_normal((STEPS + 1, 1, 16, 16, 4))
    pivots = pivots.astype(np.float32)
    return dict(pipe=pipe, enc=enc, pipe_j=pipe_j, params_j=params_j, enc_j=enc_j,
                pivots=torch.from_numpy(pivots), pivots_j=jnp.asarray(pivots),
                cond=enc.encode_sd("a photo", "", do_cfg=False),
                uncond=enc.encode_sd("", "", do_cfg=False),
                cond_j=enc_j.encode_sd("a photo", "", do_cfg=False),
                uncond_j=enc_j.encode_sd("", "", do_cfg=False))


def test_bf16_edit_keeps_the_text_tower_and_embeddings_float32(bf16_stacks):
    s = bf16_stacks
    assert next(s["pipe"].unet.parameters()).dtype == torch.bfloat16
    assert next(s["pipe"].vae.parameters()).dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in s["enc"].tower1.parameters())
    for name in ("cond", "uncond"):
        assert s[name].dtype == torch.float32
        np.testing.assert_allclose(s[name].numpy(), np.asarray(s[name + "_j"]), atol=1e-5)
    both = s["enc"].encode_sd("a photo", "blurry", do_cfg=True)
    assert both.dtype == torch.float32 and both.shape == (2, 77, 32)


def test_bf16_null_inner_step_matches_jax(bf16_stacks):
    from rgie_tpu.diffusion import schedulers as S_j

    s = bf16_stacks
    pipe, pipe_j, params_j = s["pipe"], s["pipe_j"], s["params_j"]
    t = int(pipe.sched.timesteps[0])
    lat, lat_prev = s["pivots"][-1], s["pivots"][-2]
    with torch.no_grad():
        eps_cond, _ = pipe._unet(lat, t, s["cond"], None)
    loss, grad = pipe.null_inner_loss_and_grad(s["uncond"], lat, t, eps_cond, lat_prev, 2.0)
    assert grad.dtype == torch.float32   # through the UNet's cast of its context

    def loss_j(u):
        lat_j, prev_j = s["pivots_j"][-1], s["pivots_j"][-2]
        eps_c, _ = pipe_j._unet(params_j.unet, lat_j, jnp.asarray(t), s["cond_j"], None)
        eps_u, _ = pipe_j._unet(params_j.unet, lat_j, jnp.asarray(t), u, None)
        rec = S_j.ddim_step(pipe_j.sched, eps_u + 2.0 * (eps_c - eps_u), jnp.asarray(t), lat_j)
        return jnp.mean((rec - prev_j) ** 2)

    expect_loss, expect_grad = jax.jit(jax.value_and_grad(loss_j))(s["uncond_j"])
    assert expect_grad.dtype == jnp.float32
    np.testing.assert_allclose(float(loss), float(expect_loss), rtol=2e-3)
    scale = np.abs(np.asarray(expect_grad)).max()
    np.testing.assert_allclose(grad.numpy() / scale, np.asarray(expect_grad) / scale, atol=5e-2)


def test_bf16_null_optimization_keeps_float32_and_matches_jax(bf16_stacks):
    s = bf16_stacks
    log = RunLog()
    got = s["pipe"].null_optimization(s["pivots"], s["cond"], s["uncond"], 2.0,
                                      num_inner_steps=INNER, epsilon=-1.0, log=log)
    expect = np.asarray(jax.jit(s["pipe_j"].null_optimization, static_argnames=(
        "guidance_scale", "num_inner_steps", "epsilon"))(
        s["params_j"], s["pivots_j"], s["cond_j"], s["uncond_j"], guidance_scale=2.0,
        num_inner_steps=INNER, epsilon=-1.0))
    assert log.nto_inner_steps == [INNER] * STEPS
    assert got.dtype == torch.float32 and got.shape == (STEPS, 77, 32)
    assert log.tensors["nto_adam_m"].dtype == torch.float32
    assert log.tensors["nto_adam_v"].dtype == torch.float32
    # Adam moved every entry by about the learning rate a step: in bfloat16 an
    # entry of size 1 would have moved by a multiple of 2^-8 or not at all.
    moved = (got - s["uncond"]).abs()
    assert float(moved.max()) > LR and float(moved.mean()) > LR / 2
    diff = np.abs(got.numpy() - expect)
    for k in range(STEPS):
        assert diff[k].max() <= 2 * LR * INNER * (k + 1)
    assert diff.mean() <= LR / 10


# ---------------------------------------------------------------------------
# RGIE_FLASH_ATTN
# ---------------------------------------------------------------------------


def test_flash_attn_switch_is_read_from_the_environment():
    """``RGIE_FLASH_ATTN`` is read once, when the module is imported; unset,
    it is ``"auto"`` and the gate stands."""
    code = ("from rgie_tpu_torch.ops.kernels import flash_attention as FA; "
            "print(FA.FLASH_ATTN, FA.flash_self_attention_ok(16384, 16384, 64))")
    env = dict(os.environ, RGIE_FLASH_ATTN="0")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True,
                         capture_output=True, text=True, timeout=120).stdout.split()
    assert out == ["0", "False"]
    if "RGIE_FLASH_ATTN" not in os.environ:
        assert FA.FLASH_ATTN == "auto" and FA.flash_self_attention_ok(16384, 16384, 64)


def test_flash_attn_0_sends_the_modules_to_the_matmul_route(monkeypatch):
    """With the gate's threshold lowered to the test's 96 positions the
    modules call the wrapper; with ``RGIE_FLASH_ATTN=0`` they do not, and
    give the matmul route's result."""
    from rgie_tpu_torch.diffusion import unet as U
    from rgie_tpu_torch.diffusion import vae as V

    calls = []
    real = FA.flash_attention

    def counting(q, k, v, **kw):
        calls.append(tuple(q.shape))
        return real(q, k, v, **kw)

    g = torch.Generator().manual_seed(0)
    attn = U.CrossAttention(16, 16, heads=2, dim_head=8)
    vattn = V.VaeAttention(8, groups=2)
    x = torch.randn(1, 96, 16, generator=g)
    xv = torch.randn(1, 8, 12, 8, generator=g)
    monkeypatch.setattr(U, "flash_attention", counting)
    monkeypatch.setattr(V, "flash_attention", counting)
    with torch.no_grad():
        expect, expect_v = attn(x), vattn(xv)                 # below the gate: matmul
        monkeypatch.setattr(FA, "MIN_FLASH_SEQ_LEN", 96)
        attn(x), vattn(xv)
        assert calls == [(1, 2, 96, 8), (1, 1, 96, 8)]
        monkeypatch.setattr(FA, "FLASH_ATTN", "0")
        assert not FA.flash_self_attention_ok(16384, 16384, 64)
        got, got_v = attn(x), vattn(xv)
    assert len(calls) == 2
    np.testing.assert_array_equal(got.numpy(), expect.numpy())
    np.testing.assert_array_equal(got_v.numpy(), expect_v.numpy())


# ---------------------------------------------------------------------------
# A merges file that does not load
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("content", [b"not a gzip stream", b"\x1f\x8b\x08\x00truncated"])
def test_broken_merges_file_falls_back_to_the_hash_tokenizer(tmp_path, monkeypatch, content):
    from rgie_tpu.diffusion import text_encoder as TE_j
    from rgie_tpu_torch.diffusion import text_encoder as TE

    texts = ["a photo of a dog", ""]
    monkeypatch.delenv("RGIE_CLIP_BPE_PATH", raising=False)
    for module in (TE, TE_j):
        monkeypatch.setattr(module, "_BPE", None)
    hashed = TE.tokenize(texts).numpy()
    assert TE._BPE is False or not os.path.exists(TE.VENDORED_BPE_PATH)

    broken = tmp_path / "bpe_simple_vocab_16e6.txt.gz"
    broken.write_bytes(content)
    monkeypatch.setenv("RGIE_CLIP_BPE_PATH", str(broken))
    for module in (TE, TE_j):
        monkeypatch.setattr(module, "_BPE", None)
    got = TE.tokenize(texts).numpy()
    assert TE._BPE is False and TE_j._load_bpe() is None and TE_j._BPE is False
    np.testing.assert_array_equal(got, np.asarray(TE_j.tokenize(texts)))
    if not os.path.exists(TE.VENDORED_BPE_PATH):
        np.testing.assert_array_equal(got, hashed)
