"""Midu training of the port (slice D) against ``rgie_tpu`` on the CPU: the
noisy latents, the frozen feature pass (teacher labels, VAE encode, noise,
the UNet's mid block; SD's and SDXL's conditioning), three train steps of
the L2-regularized Adam and the eval step against JAX's ``make_train_step``
and ``make_eval_step``, the prediction statistics, the teacher wrapper, and
the training CLI at ``--scale tiny`` and ``tiny-xl`` with its best
checkpoint read back by the diffusion CLI's ``--midu-ckpt`` (``strict=True``).

Tolerances: float32 on both sides. One pass of the frozen models: 2e-5 of
the largest entry (the UNet's parity test's); the noisy latents 1e-6; the
train steps' and the eval step's losses and parameters 1e-4 relative
(``STEP_RTOL``, below; parameters also 1e-2 of an Adam step absolute: 1.6e-3
seen where a gradient entry is small), predictions 1e-4 of the largest; the
statistics are the same numpy code: equal.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgie_tpu.utils import torch_convert as TC
from rgie_tpu_torch.cli import train_guidance_clf as T
from rgie_tpu_torch.config import TrainGuidanceConfig
from rgie_tpu_torch.diffusion import schedulers as S
from rgie_tpu_torch.training import (create_train_state, get_noisy_latents, make_eval_step,
                                     make_train_step, noisy_latents)

torch.set_num_threads(2)

# Three Adam steps take the random midu's loss from 0.02 to 0.5: a steep
# landscape, where float32 rounding of the forward and backward (1e-7) comes
# back 1e-5 relative in the loss (1.4e-5 seen at the third step).
STEP_RTOL = 1e-4


def _np_state(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def test_noisy_latents_match_jax():
    from rgie_tpu.training.train_midu import get_noisy_latents as get_j

    acp = S.make_schedule(50).alphas_cumprod
    rng = np.random.default_rng(0)
    latents = rng.standard_normal((3, 4, 4, 4)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    noisy_j, t_j = get_j(key, jnp.asarray(latents), jnp.asarray(acp.numpy()))
    # the draws JAX's get_noisy_latents makes from its key
    kt, kn = jax.random.split(key)
    noise = np.asarray(jax.random.normal(kn, latents.shape, jnp.float32))
    got = noisy_latents(torch.from_numpy(latents), torch.from_numpy(np.asarray(t_j)),
                        torch.from_numpy(noise), acp)
    np.testing.assert_allclose(got.numpy(), np.asarray(noisy_j), atol=1e-6)

    # the port's draws: reproducible from the generator, in range
    a = get_noisy_latents(torch.Generator().manual_seed(3), torch.from_numpy(latents), acp)
    b = get_noisy_latents(torch.Generator().manual_seed(3), torch.from_numpy(latents), acp)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert a[1].dtype == torch.int64 and int(a[1].min()) >= 0 and int(a[1].max()) < 1000
    g = torch.Generator().manual_seed(3)
    t = torch.randint(0, 1000, (3,), generator=g)
    noise = torch.randn(latents.shape, generator=g)
    assert torch.equal(a[0], noisy_latents(torch.from_numpy(latents), t, noise, acp))


@pytest.mark.parametrize("scale,size", [("tiny", 64), ("tiny-xl", 128)])
def test_features_and_labels_match_jax(scale, size):
    """JAX's features_and_labels (scripts/train_guidance_clf.py:144-168) with
    the same weights and the port's timesteps and noise."""
    from rgie_tpu.diffusion import unet as U_j
    from rgie_tpu.diffusion import vae as V_j
    from rgie_tpu.losses.emotion_loss import ValenceArousalLoss as VAL_j
    from rgie_tpu.models.emotion import EmotionRegressor as ER_j

    args = T.build_parser().parse_args(["--scale", scale, "--image-size", str(size),
                                        "--device", "cpu", "--batch-size", "2"])
    stack, _ = T.build_models(args, torch.Generator().manual_seed(0), torch.device("cpu"))
    images = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (2, size, size, 3))
                              .astype(np.float32))
    feats, labels = T.features_and_labels(stack, torch.Generator().manual_seed(7), images)
    g = torch.Generator().manual_seed(7)          # the draws features_and_labels made
    lat_hw = size // 2
    t = torch.randint(0, 1000, (2,), generator=g)
    noise = torch.randn((2, lat_hw, lat_hw, 4), generator=g)

    unet_cfg_j = getattr(U_j.UNetConfig, scale.replace("-", "_"))()
    unet_j = U_j.UNet2DCondition(unet_cfg_j)
    unet_vars = jax.tree.map(jnp.asarray, TC.convert_unet_diffusers(_np_state(stack.unet),
                                                                    unet_cfg_j))
    vae_j = V_j.AutoencoderKL(V_j.VaeConfig.tiny())
    vae_vars = jax.tree.map(jnp.asarray, TC.convert_vae_diffusers(_np_state(stack.vae),
                                                                  V_j.VaeConfig.tiny()))
    reg = stack.teacher.loss.regressor
    teacher_j = VAL_j(regressor=ER_j(
        variables=jax.tree.map(jnp.asarray, TC.convert_resnet50(reg.net.state_dict())),
        input_size=reg.input_size, crop_size=reg.crop_size), loss_type="va")

    def features_and_labels_j(images):
        labels = teacher_j.predict_loss_metric(images)
        latents = vae_j.apply(vae_vars, images * 2 - 1, method=V_j.AutoencoderKL.encode)
        a = jnp.asarray(stack.sched.alphas_cumprod.numpy())[t.numpy()].reshape(2, 1, 1, 1)
        noisy = jnp.sqrt(a) * latents + jnp.sqrt(1.0 - a) * noise.numpy()
        ctx = jnp.zeros((2, 8, unet_cfg_j.cross_attention_dim))
        kwargs = {}
        if scale == "tiny-xl":
            kwargs = dict(added_text_embeds=jnp.zeros((2, unet_cfg_j.addition_pooled_dim)),
                          added_time_ids=jnp.tile(jnp.asarray(
                              [[size, size, 0, 0, size, size]], jnp.float32), (2, 1)))
        _, mid = unet_j.apply(unet_vars, noisy, jnp.asarray(t.numpy()), ctx, **kwargs)
        return mid, labels

    feats_j, labels_j = jax.jit(features_and_labels_j)(jnp.asarray(images.numpy()))
    assert feats.shape == (2, size // 4, size // 4, 16) and labels.shape == (2, 2)
    for got, expect in ((feats, feats_j), (labels, labels_j)):
        expect = np.asarray(expect)
        scale_ = np.abs(expect).max()
        np.testing.assert_allclose(got.numpy() / scale_, expect / scale_, atol=2e-5)


def test_teacher_is_float32_at_dtype_bfloat16_and_its_labels_match_jax():
    """At ``--dtype bfloat16`` the UNet and VAE are bfloat16 and the teacher
    is float32, as the reference builds it (scripts/train_guidance_clf.py:
    85-101 casts the UNet and VAE only): its labels equal JAX's float32
    teacher's on the same weights within 1e-5 of the largest entry."""
    from rgie_tpu.losses.emotion_loss import ValenceArousalLoss as VAL_j
    from rgie_tpu.models.emotion import EmotionRegressor as ER_j

    args = T.build_parser().parse_args(["--scale", "tiny", "--dtype", "bfloat16",
                                        "--device", "cpu", "--batch-size", "2"])
    stack, _ = T.build_models(args, torch.Generator().manual_seed(0), torch.device("cpu"))
    assert next(stack.unet.parameters()).dtype == torch.bfloat16
    assert next(stack.vae.parameters()).dtype == torch.bfloat16
    assert {p.dtype for p in stack.teacher.loss.parameters()} == {torch.float32}
    reg = stack.teacher.loss.regressor
    assert reg.net.compute_dtype == torch.float32
    images = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 3))
                              .astype(np.float32))
    _, labels = T.features_and_labels(stack, torch.Generator().manual_seed(7),
                                      images.to(torch.bfloat16))
    assert labels.dtype == torch.float32
    teacher_j = VAL_j(regressor=ER_j(
        variables=jax.tree.map(jnp.asarray, TC.convert_resnet50(reg.net.state_dict())),
        input_size=reg.input_size, crop_size=reg.crop_size), loss_type="va")
    # the teacher reads the images the CLI hands it, cast to float32
    expect = np.asarray(jax.jit(teacher_j.predict_loss_metric)(
        jnp.asarray(images.to(torch.bfloat16).float().numpy())))
    scale_ = np.abs(expect).max()
    np.testing.assert_allclose(labels.numpy() / scale_, expect / scale_, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def midu_pair():
    from rgie_tpu.models.midu import MiduSD as MiduSD_j

    from rgie_tpu_torch.models.midu import create_midu

    midu = create_midu(torch.Generator().manual_seed(0), in_channels=16)
    with torch.no_grad():
        for p in midu.parameters():
            if p.ndim == 1:
                p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(1)) * 0.1)
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((3, 4, 8, 8, 16)).astype(np.float32)
    labels = rng.uniform(0, 1, (3, 4, 2)).astype(np.float32)
    return midu, MiduSD_j(2), feats, labels


def test_three_train_steps_and_the_eval_step_match_jax(midu_pair):
    """A learning rate and weight decay large enough for three steps to move
    the weights and for the L2 term to count; AdamW's decoupled decay would
    land elsewhere."""
    from rgie_tpu.config import TrainGuidanceConfig as TGC_j
    from rgie_tpu.training import train_midu as TM_j

    midu, midu_j, feats, labels = midu_pair
    cfg = TrainGuidanceConfig(learning_rate=1e-3, weight_decay=0.5)
    cfg_j = TGC_j(learning_rate=1e-3, weight_decay=0.5)
    state_j = TM_j.create_train_state(
        jax.tree.map(jnp.asarray, TC.convert_midu(_np_state(midu), False)), cfg_j)
    step_j = jax.jit(TM_j.make_train_step(lambda p, f: midu_j.apply(p, f), cfg_j))
    eval_j = jax.jit(TM_j.make_eval_step(lambda p, f: midu_j.apply(p, f)))

    state = create_train_state(copy.deepcopy(midu), cfg)
    adamw = copy.deepcopy(midu).float().requires_grad_(True)
    opt_w = torch.optim.AdamW(adamw.parameters(), lr=1e-3, weight_decay=0.5)
    step = make_train_step()
    for k in range(3):
        state, loss, out = step(state, torch.from_numpy(feats[k]), torch.from_numpy(labels[k]))
        state_j, loss_j, out_j = step_j(state_j, jnp.asarray(feats[k]), jnp.asarray(labels[k]))
        np.testing.assert_allclose(float(loss), float(loss_j), rtol=STEP_RTOL)
        out_j = np.asarray(out_j)
        np.testing.assert_allclose(out.numpy(), out_j, atol=STEP_RTOL * np.abs(out_j).max())
        opt_w.zero_grad()
        f, y = torch.from_numpy(feats[k]), torch.from_numpy(labels[k])
        torch.mean((adamw(f) - y) ** 2).backward()
        opt_w.step()
    assert state.step == int(state_j.step) == 3
    got = TC.convert_midu(_np_state(state.model), False)["params"]
    moved = 0.0
    for name, layer in got.items():
        for leaf, value in layer.items():
            expect = np.asarray(state_j.params["params"][name][leaf])
            np.testing.assert_allclose(value, expect, rtol=STEP_RTOL, atol=1e-2 * cfg.learning_rate)
            moved = max(moved, float(np.abs(expect - np.asarray(
                TC.convert_midu(_np_state(midu), False)["params"][name][leaf])).max()))
    assert moved > 2 * cfg.learning_rate
    w_adamw = dict(adamw.named_parameters())["0.weight"].detach()
    assert float((w_adamw - dict(state.model.named_parameters())["0.weight"]).abs().max()) > 1e-4

    loss, out = make_eval_step()(state.model, torch.from_numpy(feats[0]),
                                 torch.from_numpy(labels[0]))
    loss_j, out_j = eval_j(state_j.params, jnp.asarray(feats[0]), jnp.asarray(labels[0]))
    assert not out.requires_grad
    out_j = np.asarray(out_j)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=STEP_RTOL)
    np.testing.assert_allclose(out.numpy(), out_j, atol=STEP_RTOL * np.abs(out_j).max())


def test_prediction_stats_equal_the_jax_package(tmp_path):
    from rgie_tpu.training import prediction_stats as PS_j

    from rgie_tpu_torch.training import prediction_stats as PS

    rng = np.random.default_rng(0)
    t = rng.integers(0, 1000, 50)
    pred, lab = rng.uniform(0, 1, (50, 2)), rng.uniform(0, 1, (50, 2))
    got, expect = PS.prediction_stats_by_timestep(t, pred, lab), \
        PS_j.prediction_stats_by_timestep(t, pred, lab)
    assert sorted(got) == sorted(expect)
    for k in got:
        np.testing.assert_array_equal(got[k], expect[k])
    assert int(got["count"].sum()) == 50
    path = PS.plot_prediction_stats(got, str(tmp_path / "stats.png"))
    assert os.path.getsize(path) > 0


def test_clf_wrapper():
    from rgie_tpu_torch.training.clf_wrapper import create_teacher

    g = torch.Generator().manual_seed(0)
    teacher = create_teacher(g, input_size=40, crop_size=32)
    images = torch.rand((2, 40, 40, 3), generator=g).requires_grad_(True)
    labels = teacher.get_label(images)
    assert labels.shape == (2, 2) and not labels.requires_grad and teacher.num_outputs == 2
    assert torch.equal(labels, teacher.loss.predict_loss_metric(images).detach())
    valence = create_teacher(g, loss_type="valence", input_size=40, crop_size=32)
    assert valence.num_outputs == 1 and valence.get_label(images).shape == (2, 1)


def _feed(root, n):
    from PIL import Image

    os.makedirs(root / "images")
    os.makedirs(root / "annotations")
    rng = np.random.default_rng(0)
    for i in range(n):
        Image.fromarray((rng.uniform(0, 1, (48, 40, 3)) * 255).astype(np.uint8)).save(
            root / "images" / f"{i + 1:012d}.jpg")
    with open(root / "annotations" / "captions.json", "w") as f:
        json.dump({str(i + 1): f"a photo {i}" for i in range(n)}, f)


def test_cli_tiny_trains_and_the_edit_reads_its_checkpoint(tmp_path, capsys):
    """--scale tiny on a feed (full batches only): per-epoch losses, the best
    checkpoint, then the diffusion CLI edits with it (--midu-ckpt)."""
    from rgie_tpu_torch.cli import adapt_images
    from rgie_tpu_torch.utils.checkpoint import load_torch_state_dict

    _feed(tmp_path / "feed", 3)
    T.main(["--scale", "tiny", "--device", "cpu", "--epochs", "2", "--num-batches", "1",
            "--val-batches", "1", "--batch-size", "2", "--data-dir", str(tmp_path / "feed"),
            "--out-dir", str(tmp_path / "ckpt")])
    printed = capsys.readouterr().out
    assert printed.count("epoch ") == 2 and "(best saved)" in printed
    meta = json.loads((tmp_path / "ckpt" / "best_meta.json").read_text())
    assert meta["step"] in (1, 2) and np.isfinite(meta["val_loss"])
    state = load_torch_state_dict(str(tmp_path / "ckpt" / "best.pt"))
    assert sorted(state) == sorted(f"{i}.{p}" for i in (0, 3, 7, 9) for p in ("weight", "bias"))

    adapt_images.main(["--scale", "tiny", "--device", "cpu", "--data-dir",
                       str(tmp_path / "feed"), "--num-steps", "2", "--limit", "1",
                       "--input-size", "32", "--midu-ckpt", str(tmp_path / "ckpt" / "best.pt"),
                       "--out-dir", str(tmp_path / "edit")])
    printed = capsys.readouterr().out
    assert "loaded midu classifier from" in printed and "Score adapted:" in printed


def test_cli_tiny_xl_checkpoint_loads_into_the_sdxl_edit(tmp_path):
    """--scale tiny-xl (MiduSDXL at 128 px: the port's MiduSDXL reads 32 x 32
    mid features) on random images; the SDXL edit stack of a tiny diffusers
    snapshot loads the checkpoint with strict=True."""
    from rgie_tpu_torch.cli import adapt_images
    from test_torch_diffusion_load import write_snapshot

    with pytest.raises(ValueError, match="32 x 32"):
        T.main(["--scale", "tiny-xl", "--device", "cpu", "--out-dir", str(tmp_path / "no")])
    T.main(["--scale", "tiny-xl", "--image-size", "128", "--device", "cpu", "--epochs", "1",
            "--num-batches", "1", "--val-batches", "1", "--batch-size", "2",
            "--out-dir", str(tmp_path / "ckpt")])
    write_snapshot(tmp_path / "snap", is_xl=True)
    args = adapt_images.build_parser().parse_args([
        "--scale", "sdxl", "--diffusers-dir", str(tmp_path / "snap"), "--input-size", "128",
        "--device", "cpu", "--midu-ckpt", str(tmp_path / "ckpt" / "best.pt")])
    stack = adapt_images.build_models(args, torch.Generator().manual_seed(0),
                                      torch.device("cpu"))
    saved = torch.load(tmp_path / "ckpt" / "best.pt")
    got = stack.pipe.midu_model.state_dict()
    assert sorted(saved) == sorted(got)
    assert all(torch.equal(saved[k], got[k]) for k in saved)


def test_cli_refuses_a_multi_process_launch(tmp_path, monkeypatch):
    """Midu training runs on one device until slice F: WORLD_SIZE=2 is
    refused before any model is built or any checkpoint written."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="multi-process runs of midu training.*slice F"):
        T.main(["--scale", "tiny", "--device", "cpu", "--out-dir", str(tmp_path / "ckpt")])
    assert not os.path.exists(tmp_path / "ckpt")
