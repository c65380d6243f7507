"""EmoNet of the port (``rgie_tpu_torch/models/emonet.py``) against the JAX
package's on the CPU: the classic ten-crop, the whole pipeline with the same
weights (a torch state dict under the reference's names, read by JAX's
``convert_emonet_checkpoint`` and by the port's ``load_emonet``), the
``from_jax`` inverse, and the loader's EmoNet branch, which both pixel edits
reach through ``--va-model``.

Tolerances: the ten-crop is a copy of pixels, bit-equal; the pipeline, a
float32 ResNet-50 over ten crops after a resize, 1e-5 of the largest entry
(the resize agrees to a few 1e-6, the convolutions sum in other orders).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgie_tpu.models import emonet as EJ
from rgie_tpu.utils import torch_convert as TC
from rgie_tpu_torch.models import emonet as E
from rgie_tpu_torch.models.loader import load_va_loss
from rgie_tpu_torch.utils import from_jax as FJ

torch.set_num_threads(2)

PIPELINE_RTOL = 1e-5


@torch.no_grad()
def _randomize_bn(module, seed=1):
    """Random running statistics and affine parameters, so eval-mode parity
    exercises them."""
    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g) * 0.05)
            m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) * 0.4 + 0.8)
            m.weight.copy_(torch.rand(m.weight.shape, generator=g) * 0.4 + 0.8)
            m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.05)
    return module


@pytest.fixture(scope="module")
def emonet_pair():
    """A random port EmoNet, its checkpoint under the reference's names, and
    the JAX variables converted from that checkpoint."""
    net = E.create_emonet(torch.Generator().manual_seed(0))
    _randomize_bn(net.net)
    checkpoint = E.to_reference_keys(net.net.state_dict())
    variables = jax.tree.map(jnp.asarray, EJ.convert_emonet_checkpoint(
        {k: v.numpy() for k, v in checkpoint.items()}))
    return net, checkpoint, variables


@jax.jit
def _emonet_j(variables, images):
    return EJ.EmoNet(variables=variables, normalize_input=False)(images)


@pytest.mark.parametrize("shape,crop", [((2, 256, 256, 3), 224), ((1, 40, 40, 2), 32)])
def test_classic_ten_crop_is_bit_equal(shape, crop):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    got = E.classic_ten_crop(torch.from_numpy(x), crop)
    expect = np.asarray(EJ.classic_ten_crop(jnp.asarray(x), crop))
    assert got.shape == (shape[0] * 10, crop, crop, shape[-1])
    np.testing.assert_array_equal(got.numpy(), expect)


def test_emonet_matches_jax(emonet_pair, rng):
    """Non-square [-1, 1] images, resized up to 256: the port's EmoNet against
    JAX's built by convert_emonet_checkpoint from the same state dict."""
    net, _, variables = emonet_pair
    x = rng.uniform(-1, 1, (2, 72, 60, 3)).astype(np.float32)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    expect = np.asarray(_emonet_j(variables, jnp.asarray(x)))
    assert got.shape == expect.shape == (2, 2)
    assert np.all(got[:, 1] == 0.0) and np.all(expect[:, 1] == 0.0)
    scale = np.abs(expect).max()
    np.testing.assert_allclose(got / scale, expect / scale, rtol=0, atol=PIPELINE_RTOL)

    # [0, 1] input through normalize_input is the same function of 2x - 1.
    y = (x + 1) / 2
    norm = E.EmoNet(net.net, normalize_input=True)
    with torch.no_grad():
        np.testing.assert_allclose(norm(torch.from_numpy(y)).numpy(), got, rtol=0, atol=1e-6)


def test_from_jax_inverse_and_checkpoint_keys(emonet_pair):
    """``emonet_state_dict`` gives back the checkpoint JAX was converted from,
    under the same names; ``from_reference_keys`` undoes ``to_reference_keys``."""
    net, checkpoint, variables = emonet_pair
    got = FJ.emonet_state_dict(jax.tree.map(np.asarray, variables))
    assert set(got) == set(checkpoint)
    assert "module.model.last_linear.weight" in got and "module.model.conv1.weight" in got
    for k, v in checkpoint.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], v.float()), k
    back = E.from_reference_keys(checkpoint)
    assert set(back) == set(net.net.state_dict())
    # JAX's converter reads the same names
    assert set(TC.convert_resnet50({k: v.numpy() for k, v in back.items()})["params"]) == set(
        variables["params"])


def test_loader_emonet_branch(emonet_pair, tmp_path, rng):
    """A path naming EmoNet gives a valence loss over EmoNet: from the file
    when it exists (equal to the model it was written from), random weights
    from the generator otherwise (JAX: tests/test_models_misc.py:139-160)."""
    net, checkpoint, variables = emonet_pair
    path = tmp_path / "EmoNet_valence.pt"
    torch.save(checkpoint, path)
    x = rng.uniform(0, 1, (1, 48, 48, 3)).astype(np.float32)
    va = load_va_loss(str(path), torch.Generator().manual_seed(3), is_input_range_0_1=True)
    assert isinstance(va.regressor, E.EmoNet) and va.loss_type == "valence"
    assert va.regressor.normalize_input and not va.regressor.training
    assert not any(p.requires_grad for p in va.parameters())
    with torch.no_grad():
        out = va.regressor(torch.from_numpy(x))
        expect = net(torch.from_numpy(x * 2 - 1))
        assert torch.equal(out, expect)
        pred = va.predict_loss_metric(torch.from_numpy(x))
    assert pred.shape == (1, 1) and torch.equal(pred, out[:, :1])
    np.testing.assert_allclose(pred.numpy(), np.asarray(_emonet_j(
        variables, jnp.asarray(x * 2 - 1)))[:, :1], rtol=0, atol=PIPELINE_RTOL * 10)

    missing = load_va_loss(str(tmp_path / "no" / "EmoNet_valence.pth.tar"),
                           torch.Generator().manual_seed(3), is_input_range_0_1=False)
    assert isinstance(missing.regressor, E.EmoNet) and missing.loss_type == "valence"
    assert not missing.regressor.normalize_input
    with torch.no_grad():
        out = missing.regressor(torch.from_numpy(x * 2 - 1))
    assert out.shape == (1, 2) and float(out[0, 1]) == 0.0 and torch.isfinite(out).all()
    again = load_va_loss("EmoNet", torch.Generator().manual_seed(3))
    assert all(torch.equal(a, b) for a, b in zip(again.parameters(), missing.parameters()))


def _feed(root, n, size=40):
    from PIL import Image

    os.makedirs(root / "images")
    os.makedirs(root / "annotations")
    rng = np.random.default_rng(0)
    for i in range(n):
        Image.fromarray((rng.uniform(0, 1, (size, size + 4, 3)) * 255).astype(np.uint8)).save(
            root / "images" / f"{i + 1:012d}.jpg")
    with open(root / "annotations" / "captions.json", "w") as f:
        json.dump({str(i + 1): f"a photo {i}" for i in range(n)}, f)


def test_both_pixel_edits_run_with_an_emonet_va_model(emonet_pair, tmp_path, capsys):
    """``--va-model <...EmoNet...>`` in the parametric CLI (one image, two
    steps) and in the GAN CLI's models (one objective step and its gradient,
    on [-1, 1] images)."""
    from rgie_tpu_torch.cli import optimize_image_imaginaire as GC
    from rgie_tpu_torch.cli import optimize_image_param as PC
    from rgie_tpu_torch.engine import gan as GE

    _, checkpoint, _ = emonet_pair
    path = tmp_path / "EmoNet_valence.pt"
    torch.save(checkpoint, path)
    _feed(tmp_path / "feed", 1)
    PC.main(["--device", "cpu", "--data-dir", str(tmp_path / "feed"), "--out-dir",
             str(tmp_path / "out"), "--va-model", str(path), "--num-steps", "2",
             "--input-size", "32", "--crop-size", "32", "--output-size", "0",
             "--weight-recon", "0", "--adaptations", "pos:0.1"])
    printed = capsys.readouterr().out
    assert "Score 000000000001.jpg pos: valence" in printed and "arousal 0.0000" in printed
    assert os.path.exists(tmp_path / "out" / "000000000001_pos.jpg")

    args = GC.build_parser().parse_args(["--device", "cpu", "--va-model", str(path),
                                         "--munit-model", str(tmp_path / "none.pt"),
                                         "--input-size", "32"])
    models = GC.build_models(args, torch.Generator().manual_seed(0), torch.device("cpu"))
    assert isinstance(models.va_loss.regressor, E.EmoNet)
    assert not models.va_loss.regressor.normalize_input
    images = torch.rand((1, 32, 32, 3), generator=torch.Generator().manual_seed(1)) * 2 - 1
    ctx, style0 = GE.make_context(models, images, torch.tensor([[0.1, 0.1]]))
    style = style0.clone().requires_grad_(True)
    loss = GE.make_objective(models, GC.make_config(args))(style, ctx)
    loss.sum().backward()
    assert loss.shape == (1,) and torch.isfinite(loss).all()
    assert torch.isfinite(style.grad).all() and float(style.grad.abs().max()) > 0
