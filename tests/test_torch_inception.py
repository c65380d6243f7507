"""Inception-v3 of the port (``rgie_tpu_torch/models/inception.py``) against
the JAX package's on the CPU: both variants (pytorch-fid's and torchvision's)
with the same weights, moved into JAX by ``convert_inception_v3``, at
``num_classes=16`` on 83 px inputs (the smallest size every valid-padded
stage takes is 75); ``preprocess``; the feature extractor's batching; and a
torchvision-keyed checkpoint with its auxiliary head.

Tolerances: features and logits 1e-4 of their largest entry (94 float32
convolutions summed in other orders; the JAX package's own twin test holds
1e-4); probabilities the same; ``preprocess`` 5e-5 (both are the antialiased
bilinear resize, whose float32 weights differ from one package to the other:
2.3e-5 seen after 2x - 1 when 320 px is resized to 299, 1e-6 when upsizing).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgie_tpu.models import inception as IJ
from rgie_tpu.utils.torch_convert import convert_inception_v3
from rgie_tpu_torch.models import inception as I

torch.set_num_threads(2)

FEATURE_RTOL, PREPROCESS_ATOL = 1e-4, 5e-5


@torch.no_grad()
def _randomized(fid_variant, num_classes=16, seed=0):
    """Random weights and BatchNorm statistics (the JAX package's twin test's
    draws), so the parity exercises every affine term."""
    model = I.create_inception(torch.Generator().manual_seed(seed), num_classes, fid_variant)
    g = torch.Generator().manual_seed(seed + 1)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g) * 0.05)
            m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) * 0.4 + 0.8)
            m.weight.copy_(torch.rand(m.weight.shape, generator=g) * 0.4 + 0.8)
            m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.05)
    return model


def _rel(got, expect):
    return float(np.abs(got - expect).max() / np.abs(expect).max())


@pytest.mark.parametrize("fid_variant", [True, False])
def test_inception_matches_jax(fid_variant, rng):
    model = _randomized(fid_variant)
    variables = jax.tree.map(jnp.asarray, convert_inception_v3(
        {k: v.numpy() for k, v in model.state_dict().items()}))
    model_j = IJ.InceptionV3(num_classes=16, fid_variant=fid_variant)
    x = rng.uniform(-1, 1, (2, 83, 83, 3)).astype(np.float32)
    with torch.no_grad():
        feats, logits = model(torch.from_numpy(x))
    feats_j, logits_j = jax.jit(model_j.apply)(variables, jnp.asarray(x))
    assert feats.shape == (2, 2048) and logits.shape == (2, 16)
    assert feats.dtype == logits.dtype == torch.float32
    assert _rel(feats.numpy(), np.asarray(feats_j)) <= FEATURE_RTOL
    assert _rel(logits.numpy(), np.asarray(logits_j)) <= FEATURE_RTOL
    probs, probs_j = torch.softmax(logits, -1).numpy(), np.asarray(jax.nn.softmax(logits_j, -1))
    assert _rel(probs, probs_j) <= FEATURE_RTOL
    # the two variants are different functions of the same weights
    other = I.InceptionV3(16, not fid_variant)
    other.load_state_dict(model.state_dict())
    with torch.no_grad():
        assert not torch.allclose(other.eval()(torch.from_numpy(x))[0], feats, rtol=0,
                                  atol=1e-3 * float(feats.abs().max()))


@pytest.mark.parametrize("shape", [(2, 64, 48, 3), (1, 320, 310, 3), (1, 299, 299, 3)])
def test_preprocess_matches_jax(shape, rng):
    x = rng.uniform(0, 1, shape).astype(np.float32)
    got = I.preprocess(torch.from_numpy(x)).numpy()
    expect = np.asarray(IJ.preprocess(jnp.asarray(x)))
    assert got.shape == expect.shape == (shape[0], 299, 299, 3)
    np.testing.assert_allclose(got, expect, rtol=0, atol=PREPROCESS_ATOL)


def test_feature_extractor_batches_and_checkpoint_loading(tmp_path, rng):
    """The extractor's batches equal one pass of preprocess + model +
    softmax; a torchvision state dict (with AuxLogits) loads strictly and
    sets the class count; create_inception draws reproducibly."""
    model = _randomized(True, num_classes=10, seed=3)
    images = rng.uniform(0, 1, (3, 40, 40, 3)).astype(np.float32)
    feats, probs = I.make_feature_extractor(model, batch_size=2)(images)
    with torch.no_grad():
        f, logits = model(I.preprocess(torch.from_numpy(images)))
    assert feats.shape == (3, 2048) and probs.shape == (3, 10) and feats.dtype == np.float32
    np.testing.assert_allclose(feats, f.numpy(), rtol=0, atol=1e-6 * np.abs(feats).max())
    np.testing.assert_allclose(probs, torch.softmax(logits, -1).numpy(), rtol=0, atol=1e-7)
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-6)

    state = dict(model.state_dict())
    state["AuxLogits.fc.weight"] = torch.zeros(10, 768)
    state["AuxLogits.conv0.conv.weight"] = torch.zeros(128, 768, 1, 1)
    loaded = I.load_inception(state)
    assert loaded.num_classes == 10 and loaded.fid_variant and not loaded.training
    assert all(torch.equal(a, b) for a, b in zip(loaded.state_dict().values(),
                                                 model.state_dict().values()))
    a = I.create_inception(torch.Generator().manual_seed(0), 8)
    b = I.create_inception(torch.Generator().manual_seed(0), 8)
    assert torch.equal(a.Mixed_7c.branch_pool.conv.weight, b.Mixed_7c.branch_pool.conv.weight)
    assert a.fc.out_features == 8 and not any(p.requires_grad for p in a.parameters())
