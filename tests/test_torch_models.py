"""CPU parity of the port's models (rgie_tpu_torch.models, losses) against the
JAX package's, with weights moved through the JAX package's converters
(port -> torch_convert -> JAX) and through the port's inverses (JAX ->
utils.from_jax -> port). Inputs are made with numpy from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgie_tpu.utils import torch_convert as TC
from rgie_tpu_torch.models import clip as CL
from rgie_tpu_torch.models import discriminators as D
from rgie_tpu_torch.models import emotion as E
from rgie_tpu_torch.models import resnet as R
from rgie_tpu_torch.models.init import freeze_, random_init_
from rgie_tpu_torch.utils import from_jax as FJ

torch.set_num_threads(2)

NARROW = dict(stage_sizes=(1, 1, 1, 1), num_classes=4, num_filters=8)
CLIP_SMALL = dict(width=64, layers=2, heads=2, patch_size=16, input_resolution=64, output_dim=32)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


@torch.no_grad()
def _randomize_bn(module, seed=1):
    """Random running statistics (tests/test_fullstack_parity.py:37-41), so
    eval-mode parity exercises them."""
    g = _gen(seed)
    for m in module.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g) * 0.05)
            m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) * 0.4 + 0.8)
            m.weight.copy_(torch.rand(m.weight.shape, generator=g) * 0.4 + 0.8)
            m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.05)
    return module


def _numpy_sd(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


def _assert_sd_equal(got, expect):
    assert set(got) == set(expect)
    for k in expect:
        assert torch.equal(got[k].to(expect[k].dtype), expect[k]), k


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


# ---------------------------------------------------------------------------
# ResNet and the regressor
# ---------------------------------------------------------------------------


def test_narrow_resnet_matches_jax(rng):
    from rgie_tpu.models.resnet import ResNet as ResNetJ

    net = freeze_(_randomize_bn(random_init_(R.ResNet(**NARROW), _gen())))
    variables = _jax_tree(TC.convert_resnet50(net.state_dict(), stage_sizes=(1, 1, 1, 1)))
    x = rng.uniform(-1, 1, (2, 40, 40, 3)).astype(np.float32)
    expect = ResNetJ(**NARROW).apply(variables, jnp.asarray(x), train=False)
    got = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=1e-4, atol=1e-5)


def test_resnet_weights_both_ways(rng):
    """JAX variables -> from_jax -> port (strict) -> torch_convert gives the
    JAX variables back; port state_dict -> torch_convert -> from_jax gives the
    same tensors. With the converter's forward parity above, both directions
    carry the model."""
    from rgie_tpu.models.resnet import ResNet as ResNetJ

    variables = jax.jit(ResNetJ(**NARROW).init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    stats = jax.tree.map(lambda a: rng.uniform(0.8, 1.2, a.shape).astype(np.float32),
                         variables["batch_stats"])
    variables = {"params": jax.tree.map(np.asarray, variables["params"]), "batch_stats": stats}
    net = R.ResNet(**NARROW)
    net.load_state_dict(FJ.resnet_state_dict(variables, stage_sizes=(1, 1, 1, 1)), strict=True)
    again = TC.convert_resnet50(net.state_dict(), stage_sizes=(1, 1, 1, 1))
    jax.tree.map(np.testing.assert_array_equal, again, variables)

    sd = _randomize_bn(random_init_(R.ResNet(**NARROW), _gen(2))).state_dict()
    back = FJ.resnet_state_dict(TC.convert_resnet50(sd, stage_sizes=(1, 1, 1, 1)),
                                stage_sizes=(1, 1, 1, 1))
    _assert_sd_equal(back, sd)


@pytest.fixture(scope="module")
def regressors():
    """The full ResNet-50 regressor at 64/56 in both packages, shared weights."""
    from rgie_tpu.models.emotion import EmotionRegressor as EmotionRegressorJ

    reg = E.create_regressor(_gen(), input_size=64, crop_size=56)
    _randomize_bn(reg)
    variables = _jax_tree(TC.convert_resnet50(reg.net.state_dict()))
    return reg, EmotionRegressorJ(variables=variables, input_size=64, crop_size=56)


def test_emotion_regressor_matches_jax(rng, regressors):
    reg, reg_j = regressors
    x = rng.uniform(0, 1, (2, 72, 80, 3)).astype(np.float32)   # resized to 64, ten 56-crops
    np.testing.assert_allclose(reg(torch.from_numpy(x)).numpy(),
                               np.asarray(reg_j(jnp.asarray(x))), rtol=0, atol=1e-5)


class _FixedPredictions(torch.nn.Module):
    """A regressor stand-in that returns set predictions, so the loss math is
    compared without running ResNet-50 again."""

    def __init__(self, preds):
        super().__init__()
        self.preds = preds

    def forward(self, images, generator=None):
        return torch.from_numpy(self.preds[:images.shape[0]])

    def jax(self, images, key=None):
        return jnp.asarray(self.preds[:images.shape[0]])


def test_va_loss_matches_jax(rng):
    from rgie_tpu.losses import emotion_loss as EL_j
    from rgie_tpu_torch.losses import emotion_loss as EL

    reg = _FixedPredictions(rng.uniform(0, 1, (2, 4)).astype(np.float32))
    x = np.zeros((2, 8, 8, 3), np.float32)
    target = rng.uniform(0, 1, (2, 2)).astype(np.float32)
    for loss_type, minimized in [("va", True), ("valence", False), ("arousal", True)]:
        loss = EL.ValenceArousalLoss(reg, weight=0.7, loss_type=loss_type, is_minimized=minimized)
        loss_j = EL_j.ValenceArousalLoss(reg.jax, weight=0.7, loss_type=loss_type,
                                         is_minimized=minimized)
        np.testing.assert_array_equal(EL.default_target(loss_type, minimized).numpy(),
                                      np.asarray(EL_j.default_target(loss_type, minimized)))
        np.testing.assert_allclose(float(loss(torch.from_numpy(x))),
                                   float(loss_j(jnp.asarray(x))), rtol=1e-6, atol=1e-7)
    loss = EL.ValenceArousalLoss(reg)
    loss_j = EL_j.ValenceArousalLoss(reg.jax)
    per = loss.per_image(torch.from_numpy(x), torch.from_numpy(target)).numpy()
    for b in range(2):
        expect = loss_j(jnp.asarray(x[:1]), jnp.asarray(target[b:b + 1]))
        reg.preds = np.roll(reg.preds, -1, axis=0)   # image b first
        np.testing.assert_allclose(per[b], float(expect), rtol=1e-6, atol=1e-7)
    cond = EL.condition_from_alpha(loss, torch.from_numpy(x), 0.3).numpy()
    np.testing.assert_allclose(cond, np.asarray(EL_j.condition_from_alpha(loss_j, jnp.asarray(x), 0.3)),
                               rtol=0, atol=1e-7)


def test_loader_dispatch_and_strict_load(rng, regressors, tmp_path):
    from rgie_tpu_torch.models.loader import load_va_loss

    reg, _ = regressors
    path = tmp_path / "va_pred_all.pt"
    torch.save(reg.net.state_dict(), path)
    loaded = load_va_loss(str(path), _gen(9), input_size=64, crop_size=56)
    x = torch.from_numpy(rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32))
    torch.testing.assert_close(loaded.regressor(x), reg(x), rtol=0, atol=0)
    assert not loaded.regressor.training
    assert not any(p.requires_grad for p in loaded.parameters())

    cases = {"no_sigmoid": (4, False), "va_mse": (2, False), "arousal_nll": (2, True), "": (4, True)}
    for name, (classes, sigmoid) in cases.items():
        va = load_va_loss(str(tmp_path / name) if name else None, _gen(), input_size=64, crop_size=56)
        assert (va.regressor.num_classes, va.regressor.use_sigmoid) == (classes, sigmoid), name
        assert va.regressor.net.fc.out_features == classes
    with pytest.raises(NotImplementedError, match="slice E"):
        load_va_loss(str(tmp_path / "EmoNet.pt"), _gen())


# ---------------------------------------------------------------------------
# CLIP
# ---------------------------------------------------------------------------


def _clip_j(variables):
    from rgie_tpu.models.clip import ClipImageEncoder, VisionTransformer

    return ClipImageEncoder(variables=variables, model=VisionTransformer(**CLIP_SMALL))


def test_clip_tower_matches_jax(rng):
    from rgie_tpu.models.clip import clip_loss as clip_loss_j

    enc = CL.create_clip_image_encoder(_gen(), **CLIP_SMALL)
    enc_j = _clip_j(_jax_tree(TC.convert_clip_visual(_numpy_sd(enc.model), layers=2, heads=2,
                                                     width=64)))
    x = rng.uniform(0, 1, (2, 80, 80, 3)).astype(np.float32)
    y = rng.uniform(0, 1, (2, 80, 80, 3)).astype(np.float32)
    np.testing.assert_allclose(enc(torch.from_numpy(x)).numpy(), np.asarray(enc_j(jnp.asarray(x))),
                               rtol=0, atol=1e-5)
    feats = enc.embed_normalized(torch.from_numpy(x))
    feats_j = enc_j.embed_normalized(jnp.asarray(x))
    np.testing.assert_allclose(feats.numpy(), np.asarray(feats_j), rtol=0, atol=1e-5)
    got = CL.clip_loss(enc, feats, torch.from_numpy(y)).numpy()
    assert got.shape == (2,)
    for b in range(2):
        expect = clip_loss_j(enc_j, feats_j[b:b + 1], jnp.asarray(y[b:b + 1]))
        np.testing.assert_allclose(got[b], float(expect), rtol=0, atol=1e-5)
    np.testing.assert_allclose(CL.quick_gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(x * jax.nn.sigmoid(1.702 * x)), rtol=0, atol=1e-6)


def test_clip_weights_both_ways(rng):
    from rgie_tpu.models.clip import VisionTransformer

    params = jax.jit(VisionTransformer(**CLIP_SMALL).init)(jax.random.PRNGKey(1),
                                                           jnp.zeros((1, 64, 64, 3)))
    model = CL.VisionTransformer(**CLIP_SMALL)
    model.load_state_dict(FJ.clip_visual_state_dict(jax.tree.map(np.asarray, params), 2, 2, 64),
                          strict=True)
    enc = freeze_(CL.ClipImageEncoder(model))
    x = rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    np.testing.assert_allclose(enc(torch.from_numpy(x)).numpy(),
                               np.asarray(_clip_j(params)(jnp.asarray(x))), rtol=0, atol=1e-5)
    sd = CL.create_clip_image_encoder(_gen(3), **CLIP_SMALL).model.state_dict()
    back = FJ.clip_visual_state_dict(TC.convert_clip_visual(sd, layers=2, heads=2, width=64),
                                     2, 2, 64)
    _assert_sd_equal(back, sd)


# ---------------------------------------------------------------------------
# Pixel discriminator
# ---------------------------------------------------------------------------


def test_pixel_discriminator_matches_jax_both_ways(rng):
    from rgie_tpu.models.discriminators import PixelDiscriminator as PixelDiscriminatorJ

    dis = freeze_(random_init_(D.PixelDiscriminator(num_features=8, size_w=120, size_h=120), _gen()))
    model_j = PixelDiscriminatorJ(num_features=8, size_w=120, size_h=120)
    variables = _jax_tree(TC.convert_pixel_discriminator(_numpy_sd(dis), size_w=120, size_h=120))
    x = rng.uniform(0, 1, (2, 120, 120, 3)).astype(np.float32)
    np.testing.assert_allclose(dis(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.jit(model_j.apply)(variables, jnp.asarray(x))),
                               rtol=1e-4, atol=1e-5)
    back = FJ.pixel_discriminator_state_dict(variables, size_w=120, size_h=120)
    _assert_sd_equal(back, dis.state_dict())
    # JAX variables -> from_jax -> port (strict) -> torch_convert: the same tree
    init = jax.jit(model_j.init)(jax.random.PRNGKey(2), jnp.zeros((1, 120, 120, 3)))
    init = jax.tree.map(np.asarray, init)
    dis2 = D.PixelDiscriminator(num_features=8, size_w=120, size_h=120)
    dis2.load_state_dict(FJ.pixel_discriminator_state_dict(init, 120, 120), strict=True)
    again = TC.convert_pixel_discriminator(_numpy_sd(dis2), size_w=120, size_h=120)
    jax.tree.map(np.testing.assert_array_equal, again, init)
