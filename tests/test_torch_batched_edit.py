"""The batched and segmented diffusion edits of the port (slice C2c) on the
CPU, tiny configs: the batch of 2 against ``rgie_tpu``'s vmapped
``make_batched_edit`` (null-text optimization, CFG, classifier guidance and a
reference value per image), each row against the single-image edit of its
image (also when one image stops null-text optimization early and the other
does not), the SDXL added conds over the sigma-space DPM tables, the
segmented edit bit for bit against the whole one, and the CLI's ``--batch``
and ``--segment``. Weights go port -> ``torch_convert`` -> JAX.

Tolerances: float32 on both sides. Against JAX as in
test_torch_diffusion_edit.py: scores 1e-4 (the midu's outputs, of order
0.5), decoded images 1e-3. A row of the batch against the single-image edit
of its image runs the same code on a batch of 2 instead of 1, where the
convolutions and matmuls may sum in another order, and null-text
optimization's normalized Adam steps and the normalized guidance gradient
carry that rounding through the loops: 1e-4 on images in [0, 1], scores and
null-text embeddings (3.9e-5 seen on images, a tenth of the tolerance
against JAX). ``--segment`` runs the same operations in
the same order: ``torch.equal``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgie_tpu.utils import torch_convert as TC
from rgie_tpu_torch.diffusion import schedulers as S
from rgie_tpu_torch.diffusion.batched import (BatchedConds, check_batch, make_batched_edit,
                                              max_batch, stack_conds)
from rgie_tpu_torch.diffusion.pipeline import InversionResamplingPipeline, RunLog, SdxlCond
from rgie_tpu_torch.diffusion.segmented import make_segmented_edit
from rgie_tpu_torch.diffusion.unet import UNetConfig, create_unet
from rgie_tpu_torch.diffusion.vae import VaeConfig, create_vae
from rgie_tpu_torch.models.midu import create_midu

torch.set_num_threads(2)

STEPS, INNER, SIZE, L, D = 2, 3, 32, 5, 32
KW = dict(guidance_scale=2.0, guidance_clf_scale=0.2, use_nto=True, use_reference=True,
          num_inner_steps=INNER)
ROW_TOL, EMBED_TOL = 1e-4, 1e-4


def _np_state(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def _randomize_biases(module, g, scale=0.1):
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=g) * scale)
    return module


def _pipe(unet_cfg=UNetConfig.tiny(), steps=STEPS, **kwargs):
    g = torch.Generator().manual_seed(0)
    unet = _randomize_biases(create_unet(g, unet_cfg), g, 0.02)
    vae = create_vae(g, VaeConfig.tiny())
    midu = _randomize_biases(create_midu(g, in_channels=16), g)
    return InversionResamplingPipeline(unet=unet, vae=vae, sched=S.make_schedule(steps),
                                       midu_model=midu, **kwargs)


def _inputs(seed=1, added_dim=None):
    """Two images, the shared empty embeddings, per-image conds and alphas,
    from one numpy seed (SDXL added conds when ``added_dim``)."""
    rng = np.random.default_rng(seed)
    arr = lambda *shape, s=1.0: torch.from_numpy((rng.standard_normal(shape) * s)
                                                 .astype(np.float32))
    images = torch.from_numpy(rng.uniform(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32))
    empty = arr(1, L, D, s=0.5)
    per_image = []
    for _ in range(2):
        added = {}
        if added_dim:
            ids = torch.tensor([[SIZE, SIZE, 0, 0, SIZE, SIZE]], dtype=torch.float32)
            added = dict(added_cfg=SdxlCond(arr(2, added_dim), ids.expand(2, 6)),
                         added_cond=SdxlCond(arr(1, added_dim), ids),
                         added_uncond=SdxlCond(arr(1, added_dim), ids))
        per_image.append(BatchedConds(cfg_embeds=arr(2, L, D, s=0.5),
                                      cond_embeds=arr(1, L, D, s=0.5), **added))
    alphas = torch.tensor([[0.1, 0.1], [-0.1, 0.2]])
    added_empty = None
    if added_dim:
        added_empty = SdxlCond(arr(1, added_dim),
                               torch.tensor([[SIZE, SIZE, 0, 0, SIZE, SIZE]], dtype=torch.float32))
    return images, empty, per_image, alphas, added_empty


def single_image_edit(pipe, image, empty, conds, alpha, added_empty=None, epsilon=1e-5,
                      log=None):
    """One image's edit through the pipeline's single-image functions, as
    ``ImageAdapter.revert_and_sample`` runs them (conds without the batch
    axis: cfg (2, L, D), cond (1, L, D))."""
    from rgie_tpu_torch.models.midu import ValenceArousalMidu

    t_last = int(pipe.sched.timesteps[-1])
    clf = ValenceArousalMidu(model=pipe.midu_model)

    def score(img):
        _, mid = pipe._unet(pipe.encode_image(img), t_last, empty, added_empty)
        return clf.predict(mid)

    with torch.no_grad():
        orig = score(image)
    latents = pipe.encode_image(image)
    noisy, pivots = pipe.reverse_sample(latents, empty, added=added_empty)
    nto = pipe.null_optimization(pivots, conds.cond_embeds, empty, 2.0,
                                 added_cond=conds.added_cond, added_uncond=conds.added_uncond,
                                 num_inner_steps=INNER, epsilon=epsilon, log=log)
    lat = pipe.sample(noisy, conds.cfg_embeds, added=conds.added_cfg, guidance_scale=2.0,
                      guidance_clf_scale=0.2, uncond_embeds_per_step=nto,
                      midu_reference_value=torch.clamp(orig + alpha, 0.0, 1.0))
    edited = pipe.decode_latents(lat)
    with torch.no_grad():
        return edited, orig, score(edited), nto


@pytest.fixture(scope="module")
def sd():
    pipe = _pipe()
    images, empty, per_image, alphas, _ = _inputs()
    log = RunLog()
    out = make_batched_edit(pipe, **KW)(images, empty, stack_conds(per_image), alphas, log=log)
    return dict(pipe=pipe, images=images, empty=empty, per_image=per_image, alphas=alphas,
                out=out, log=log)


def test_batched_edit_matches_jax(sd):
    from rgie_tpu.diffusion import batched as B_j
    from rgie_tpu.diffusion import pipeline as P_j
    from rgie_tpu.diffusion import schedulers as S_j
    from rgie_tpu.diffusion import unet as U_j
    from rgie_tpu.diffusion import vae as V_j
    from rgie_tpu.models import midu as M_j

    pipe, out = sd["pipe"], sd["out"]
    as_jax = lambda tree: jax.tree.map(jnp.asarray, tree)
    params_j = P_j.PipelineParams(
        unet=as_jax(TC.convert_unet_diffusers(_np_state(pipe.unet), U_j.UNetConfig.tiny())),
        vae=as_jax(TC.convert_vae_diffusers(_np_state(pipe.vae), V_j.VaeConfig.tiny())),
        midu=as_jax(TC.convert_midu(_np_state(pipe.midu_model), False)))
    pipe_j = P_j.InversionResamplingPipeline(
        unet=U_j.UNet2DCondition(U_j.UNetConfig.tiny()),
        vae=V_j.AutoencoderKL(V_j.VaeConfig.tiny()), sched=S_j.make_schedule(STEPS),
        midu_model=M_j.MiduSD(2))
    conds_j = B_j.stack_conds([B_j.BatchedConds(cfg_embeds=jnp.asarray(c.cfg_embeds.numpy()),
                                                cond_embeds=jnp.asarray(c.cond_embeds.numpy()))
                               for c in sd["per_image"]])
    expect = jax.jit(B_j.make_batched_edit(pipe_j, **KW))(
        params_j, jnp.asarray(sd["images"].numpy()), jnp.asarray(sd["empty"].numpy()), conds_j,
        jnp.asarray(sd["alphas"].numpy()))

    assert out.edited.shape == (2, SIZE, SIZE, 3) and out.orig_score.shape == (2, 2)
    assert sd["log"].nto_image_steps == [[INNER, INNER]] * STEPS   # no early stop here
    np.testing.assert_allclose(out.orig_score.numpy(), np.asarray(expect.orig_score), atol=1e-4)
    np.testing.assert_allclose(out.edited.numpy(), np.asarray(expect.edited), atol=1e-3)
    np.testing.assert_allclose(out.adapted_score.numpy(), np.asarray(expect.adapted_score),
                               atol=1e-4)
    # the edit moved the images and the two images got their own edits
    assert float((out.edited - sd["images"]).abs().mean()) > 1e-3
    assert not torch.allclose(out.adapted_score[0], out.adapted_score[1])


def test_each_row_equals_its_single_image_edit(sd):
    pipe, out, log = sd["pipe"], sd["out"], sd["log"]
    for b in range(2):
        conds = sd["per_image"][b]
        edited, orig, adapted, nto = single_image_edit(
            pipe, sd["images"][b:b + 1], sd["empty"], conds, sd["alphas"][b:b + 1])
        np.testing.assert_allclose(out.orig_score[b:b + 1].numpy(), orig.numpy(), atol=ROW_TOL)
        np.testing.assert_allclose(log.tensors["nto_embeds"][:, b].numpy(), nto.numpy(),
                                   atol=EMBED_TOL)
        np.testing.assert_allclose(out.edited[b:b + 1].numpy(), edited.numpy(), atol=ROW_TOL)
        np.testing.assert_allclose(out.adapted_score[b:b + 1].numpy(), adapted.numpy(),
                                   atol=ROW_TOL)
    # the guidance gradient was normalized per image: one norm per image a step
    assert len(log.clf_grad_norms) == STEPS
    assert all(n.shape == (2,) and bool((n > 0).all()) for n in log.clf_grad_norms)


def test_one_image_stops_null_text_optimization_early(sd):
    """``nto_epsilon`` between the two images' first inner losses: at the first
    outer step the image below it stops after one inner step, the other runs
    on; each row still equals its single-image edit with that epsilon."""
    pipe, images, empty, per_image = sd["pipe"], sd["images"], sd["empty"], sd["per_image"]
    # The first inner loss of each image: outer step 0, the embeddings at empty.
    lat = pipe.encode_image(images)
    _, pivots = pipe.reverse_sample(lat, empty.expand(2, -1, -1))
    t = int(pipe.sched.timesteps[0])
    cond = torch.cat([c.cond_embeds for c in per_image])
    with torch.no_grad():
        eps_cond, _ = pipe._unet(pivots[-1], t, cond, None)
    losses, _ = pipe.null_inner_loss_and_grad(empty.expand(2, -1, -1), pivots[-1], t, eps_cond,
                                              pivots[-2], 2.0)
    lo, hi = sorted(losses.tolist())
    assert hi > 1.05 * lo, losses     # a margin far above the rows' rounding
    epsilon = (lo * hi) ** 0.5

    log = RunLog()
    out = make_batched_edit(pipe, **KW, nto_epsilon=epsilon)(
        images, empty, stack_conds(per_image), sd["alphas"], log=log)
    first = log.nto_image_steps[0]
    assert first[int(np.argmin(losses.numpy()))] == 1
    assert first[int(np.argmax(losses.numpy()))] > 1
    assert log.nto_inner_steps[0] == max(first)
    for b in range(2):
        single_log = RunLog()
        edited, _, adapted, nto = single_image_edit(
            pipe, images[b:b + 1], empty, per_image[b], sd["alphas"][b:b + 1], epsilon=epsilon,
            log=single_log)
        assert single_log.nto_inner_steps == [steps[b] for steps in log.nto_image_steps]
        np.testing.assert_allclose(log.tensors["nto_embeds"][:, b].numpy(), nto.numpy(),
                                   atol=EMBED_TOL)
        np.testing.assert_allclose(out.edited[b:b + 1].numpy(), edited.numpy(), atol=ROW_TOL)
        np.testing.assert_allclose(out.adapted_score[b:b + 1].numpy(), adapted.numpy(),
                                   atol=ROW_TOL)


@pytest.mark.parametrize("chunk", [1, 2])
def test_segmented_edit_is_bit_equal_to_the_whole_edit(chunk):
    """3 steps: windows of 2 leave a ragged last window, windows of 1 are the
    per-step extreme."""
    pipe = _pipe(steps=3)
    images, empty, per_image, alphas, _ = _inputs(seed=2)
    conds = stack_conds(per_image)
    whole = make_batched_edit(pipe, **KW)(images, empty, conds, alphas)
    seg = make_segmented_edit(pipe, chunk_steps=chunk, **KW)(images, empty, conds, alphas)
    for name in ("edited", "orig_score", "adapted_score"):
        assert torch.equal(getattr(seg, name), getattr(whole, name)), name


def test_sdxl_added_conds_over_sigma_dpm_tables():
    """tiny-xl's added conds per image, karras sigma tables forward and
    inverse, null-text optimization on: windows of 3 over 4 steps carry the
    DPM state across a window boundary bit for bit, and each row equals the
    single-image edit of its image."""
    steps = 4
    sig = {name: S.make_dpm_sigma_schedule(steps, use_karras_sigmas=True, inverse=inverse)
           for name, inverse in (("sigma_sched", False), ("sigma_sched_inv", True))}
    pipe = _pipe(UNetConfig.tiny_xl(), steps=steps, is_xl=True, scheduler_type="dpm", **sig)
    images, empty, per_image, alphas, added_empty = _inputs(
        seed=3, added_dim=pipe.unet.cfg.addition_pooled_dim)
    conds = stack_conds(per_image)
    assert conds.added_cfg.text_embeds.shape == (2, 2, 16)
    whole = make_batched_edit(pipe, **KW)(images, empty, conds, alphas, added_empty)
    seg = make_segmented_edit(pipe, chunk_steps=3, **KW)(images, empty, conds, alphas,
                                                          added_empty)
    assert torch.equal(seg.edited, whole.edited)
    assert torch.equal(seg.adapted_score, whole.adapted_score)
    for b in range(2):
        edited, orig, adapted, _ = single_image_edit(pipe, images[b:b + 1], empty, per_image[b],
                                                     alphas[b:b + 1], added_empty)
        # latents of order 10 after the sigma-space inversion (test_torch_sdxl_edit.py)
        np.testing.assert_allclose(whole.edited[b:b + 1].numpy(), edited.numpy(), atol=1e-4)
        np.testing.assert_allclose(whole.adapted_score[b:b + 1].numpy(), adapted.numpy(),
                                   atol=1e-4)


def test_batch_limit_of_the_kernels():
    pipe = _pipe()
    largest = max_batch(pipe)
    assert largest == 65535 // (2 * max(pipe.unet.cfg.attention_head_dim))
    check_batch(pipe, largest)
    with pytest.raises(ValueError, match="65535"):
        check_batch(pipe, largest + 1)
    with pytest.raises(ValueError, match="65535"):
        make_batched_edit(pipe, **KW)(torch.zeros(1, 1, 1, 3).expand(largest + 1, -1, -1, -1),
                                      None, None, None)


def _write_feed(root, n, rng):
    from PIL import Image

    os.makedirs(root / "images")
    os.makedirs(root / "annotations")
    captions = {}
    for i in range(n):
        arr = (rng.uniform(0, 1, (40 + 4 * i, 48, 3)) * 255).astype(np.uint8)
        Image.fromarray(arr).save(root / "images" / f"{i + 1:012d}.jpg")
        captions[str(i + 1)] = f"a photo number {i}"
    with open(root / "annotations" / "captions.json", "w") as f:
        json.dump(captions, f)


def test_cli_batch_and_segment(tmp_path, capsys):
    """Three images at --batch 2 --segment 1: a batch of 2, then a batch of 1
    (not padded); per image the scores, the reconstruction error and a JPEG
    that equals the CLI's at --batch 1 (one image per edit) within JPEG
    rounding."""
    from PIL import Image

    from rgie_tpu_torch.cli.adapt_images import main

    _write_feed(tmp_path / "feed", 3, np.random.default_rng(4))
    common = ["--data-dir", str(tmp_path / "feed"), "--device", "cpu", "--scale", "tiny",
              "--num-steps", "2", "--reference-value", "0.1", "--input-size", "32"]
    main(common + ["--out-dir", str(tmp_path / "batched"), "--batch", "2", "--segment", "1"])
    printed = capsys.readouterr().out
    assert printed.count("Score original:") == 3 and printed.count("Score adapted:") == 3
    assert printed.count("Reconstruction error:") == 3
    assert "batch of 2 edited in" in printed and "batch of 1 edited in" in printed
    main(common + ["--out-dir", str(tmp_path / "single")])
    written = sorted(os.listdir(tmp_path / "batched" / "CG_CFG_2_0.2"))
    assert written == sorted(os.listdir(tmp_path / "single" / "CG_CFG_2_0.2"))
    assert len(written) == 3
    for name in written:
        a, b = (np.asarray(Image.open(tmp_path / d / "CG_CFG_2_0.2" / name), np.int16)
                for d in ("batched", "single"))
        assert a.shape == (32, 32, 3)
        assert np.abs(a - b).max() <= 2, name
