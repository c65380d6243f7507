"""The whole slice on the CPU: the port's parametric edit (filter chain ->
ten-crop ResNet-50 VA loss -> CLIP recon -> Adam with the cosine ramp and
best-x tracking) against the JAX package's, with shared weights; the CLI;
and the port's rules (explicit device, no JAX)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgie_tpu.config import OptimizeConfig, ParamEditConfig
from rgie_tpu.utils import torch_convert as TC
from rgie_tpu_torch.engine import optimize as O
from rgie_tpu_torch.engine import parametric as P
from rgie_tpu_torch.ops import chain as CH

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, VA_CROP, STEPS = 64, 56, 4
CLIP_SMALL = dict(width=64, layers=2, heads=2, patch_size=16, input_resolution=SIZE, output_dim=32)


def test_lr_ramp_schedule_matches_jax():
    from rgie_tpu.engine.optimize import lr_ramp_schedule as lr_j

    got = np.asarray([O.lr_ramp_schedule(0.05, 300)(k) for k in range(300)])
    expect = np.asarray(jax.vmap(lr_j(0.05, 300))(jnp.arange(300)))
    np.testing.assert_allclose(got, expect, rtol=0, atol=1e-7)
    assert got[0] == 0.0


@pytest.fixture(scope="module")
def stacks():
    """B = 2 images, the full ResNet-50 regressor at 64/56 and a narrow CLIP,
    in both packages with the same weights (through torch_convert)."""
    from rgie_tpu.engine import parametric as P_j
    from rgie_tpu.losses.emotion_loss import ValenceArousalLoss as VAJ
    from rgie_tpu.models.clip import ClipImageEncoder, VisionTransformer
    from rgie_tpu.models.emotion import EmotionRegressor
    from rgie_tpu_torch.losses.emotion_loss import ValenceArousalLoss
    from rgie_tpu_torch.models.clip import create_clip_image_encoder
    from rgie_tpu_torch.models.emotion import create_regressor

    g = torch.Generator().manual_seed(0)
    reg = create_regressor(g, input_size=SIZE, crop_size=VA_CROP)
    with torch.no_grad():
        for m in reg.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g) * 0.05)
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) * 0.4 + 0.8)
    enc = create_clip_image_encoder(g, **CLIP_SMALL)
    models = P.EditModels(va_loss=ValenceArousalLoss(reg), clip=enc)

    va_j = VAJ(regressor=EmotionRegressor(
        variables=jax.tree.map(jnp.asarray, TC.convert_resnet50(reg.net.state_dict())),
        input_size=SIZE, crop_size=VA_CROP))
    clip_j = ClipImageEncoder(
        variables=jax.tree.map(jnp.asarray, TC.convert_clip_visual(
            {k: v.numpy() for k, v in enc.model.state_dict().items()}, layers=2, heads=2,
            width=64)),
        model=VisionTransformer(**CLIP_SMALL))
    cfg = ParamEditConfig(optimize=OptimizeConfig(num_steps=STEPS, learning_rate=0.05),
                          input_size=SIZE, crop_size=SIZE)
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    alphas = np.asarray([[0.2, 0.2], [-0.1, 0.1]], np.float32)
    return dict(models=models, cfg=cfg, va_j=va_j, clip_j=clip_j, P_j=P_j,
                models_j=P_j.models_of(va_j, clip_j), images=images, alphas=alphas)


def _perturbed_x0(rng):
    """The kink-free start of tests/test_fullstack_parity.py:66-73."""
    x0 = np.asarray(CH.pack_params(CH.init_params()), np.float32).copy()
    x0[0], x0[1], x0[34], x0[35], x0[36] = 0.08, 0.93, 1.07, 0.25, 0.4
    x0[2:34] += rng.uniform(-0.05, 0.05, 32).astype(np.float32)
    x0[37:41] = [1.07, 1.12, 29.0, 35.0]
    return x0


def test_edit_trajectory_matches_jax(rng, stacks):
    """Per-image loss trajectories against JAX's optimize from a perturbed x0
    (tolerances of tests/test_fullstack_parity.py:105-107), then the
    compare_emotions oracles on each package's own edit."""
    from rgie_tpu.engine.optimize import optimize as optimize_j
    from rgie_tpu.ops import chain as CH_j

    s = stacks
    P_j, cfg = s["P_j"], s["cfg"]
    x0 = np.stack([_perturbed_x0(rng), _perturbed_x0(rng)])
    objective_j = P_j.make_objective(s["va_j"], s["clip_j"], cfg)

    def edit_one(models, image, alpha, x):
        image = image[None]
        va0 = s["va_j"].predict_loss_metric(image)
        feats = s["clip_j"].embed_normalized(image)
        ctx = P_j.EditContext(image=image, target=jnp.clip(va0 + alpha, 0.0, 1.0),
                              clip_features=feats)
        return optimize_j(lambda v: objective_j(v, ctx, models), x, cfg.optimize)

    res_j = jax.jit(jax.vmap(edit_one, in_axes=(None, 0, 0, 0)))(
        s["models_j"], jnp.asarray(s["images"]), jnp.asarray(s["alphas"]), jnp.asarray(x0))

    images, alphas = torch.from_numpy(s["images"]), torch.from_numpy(s["alphas"])
    ctx = P.make_context(s["models"], cfg, images, alphas)
    objective = P.make_objective(s["models"], cfg)
    res = O.optimize(lambda v: objective(v, ctx), torch.from_numpy(x0), cfg.optimize)

    losses_j = np.asarray(res_j.losses)
    losses = res.losses.numpy()
    assert losses.shape == (2, STEPS)
    np.testing.assert_allclose(losses[:, 0], losses_j[:, 0], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(losses, losses_j, rtol=0.02, atol=2e-3)
    np.testing.assert_array_equal(res.first_loss.numpy(), losses[:, 0])
    assert np.all(res.best_loss.numpy() == losses.min(axis=1))

    evaluate_j = P_j.make_evaluate(s["va_j"])
    with torch.no_grad():
        edited = CH.edit_image(images, res.best_x, input_size=SIZE)
    ev = P.make_evaluate(s["models"].va_loss)(images, edited)
    for b in range(2):
        image_b = jnp.asarray(s["images"][b:b + 1])
        edited_j = CH_j.edit_image(image_b, res_j.best_x[b], input_size=SIZE)
        ev_j = evaluate_j(s["models_j"], image_b, edited_j)
        np.testing.assert_allclose(ev["va_delta"][b].numpy(), np.asarray(ev_j["va_delta"])[0],
                                   atol=5e-3)
        np.testing.assert_allclose(float(ev["rec_error"][b]), float(ev_j["rec_error"]), atol=2e-3)


def test_batched_edit_matches_jax(stacks):
    """The batched entry point from the identity init against
    make_batched_edit: the originals' VA and the first loss, per image."""
    s = stacks
    P_j = s["P_j"]
    cfg = ParamEditConfig(optimize=OptimizeConfig(num_steps=1, learning_rate=0.05),
                          input_size=SIZE, crop_size=SIZE)
    res_j, _ = jax.jit(P_j.make_batched_edit(s["va_j"], s["clip_j"], cfg))(
        s["models_j"], jnp.asarray(s["images"]), jnp.asarray(s["alphas"]))
    images = torch.from_numpy(s["images"])
    res, edited = P.make_batched_edit(s["models"], cfg)(images, torch.from_numpy(s["alphas"]))
    np.testing.assert_allclose(res.first_loss.numpy(), np.asarray(res_j.first_loss),
                               rtol=1e-4, atol=1e-5)
    va0 = P.make_evaluate(s["models"].va_loss)(images, edited)["va_original"].numpy()
    va0_j = np.asarray(s["va_j"].predict_loss_metric(jnp.asarray(s["images"])))
    np.testing.assert_allclose(va0, va0_j, rtol=0, atol=1e-5)
    assert res.best_x.shape == (2, CH.NUM_PARAMS)


# ---------------------------------------------------------------------------
# The CLI and the port's rules
# ---------------------------------------------------------------------------


def _feed(tmp_path, rng, n=2):
    import json

    from PIL import Image

    os.makedirs(tmp_path / "annotations")
    os.makedirs(tmp_path / "images")
    captions = {}
    for i in range(n):
        arr = (rng.uniform(0, 1, (80, 72, 3)) * 255).astype(np.uint8)
        Image.fromarray(arr).save(tmp_path / "images" / f"{i + 1:012d}.jpg")
        captions[str(i + 1)] = f"image {i}"
    with open(tmp_path / "annotations" / "captions.json", "w") as f:
        json.dump(captions, f)
    return tmp_path


def _cli_args(data, out):
    return ["--data-dir", str(data), "--out-dir", str(out), "--num-steps", "2",
            "--input-size", "64", "--crop-size", "64", "--va-input-size", "64",
            "--va-crop-size", "56", "--output-size", "96", "--batch", "2",
            "--adaptations", "pos:0.1", "--va-model", str(out / "missing_va_pred_all")]


def test_cli_runs_on_cpu(tmp_path, rng, capsys):
    from rgie_tpu_torch.cli.optimize_image_param import main

    data = _feed(tmp_path / "data", rng)
    out = tmp_path / "out"
    main(_cli_args(data, out) + ["--device", "cpu"])
    written = sorted(os.listdir(out))
    assert written == ["000000000001_pos.jpg", "000000000002_pos.jpg"]
    from PIL import Image

    assert Image.open(out / written[0]).size == (96, 96)
    assert "batch of 2 edited" in capsys.readouterr().out


def test_cli_device_cuda_raises_without_cuda(tmp_path, rng, monkeypatch):
    from rgie_tpu_torch.cli.optimize_image_param import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(_cli_args(tmp_path, tmp_path / "out") + ["--device", "cuda"])
    assert not os.path.exists(tmp_path / "out")


def test_port_never_imports_jax():
    code = ("import sys\n"
            "import rgie_tpu_torch.cli.optimize_image_param, rgie_tpu_torch.utils.from_jax\n"
            "import rgie_tpu_torch.models.loader, rgie_tpu_torch.device\n"
            "import rgie_tpu_torch.ops.kernels.pointwise_chain\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', 'orbax')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=300)
