"""The diffusers-snapshot loader of the port against ``rgie_tpu`` on the CPU,
and the diffusion CLI on such snapshots. Each test writes a tiny SD or SDXL
snapshot itself (``unet/``, ``vae/``, ``text_encoder/``, ``text_encoder_2/``
with safetensors weights and config.json files), as
tests/test_diffusion_parity.py does; both packages load it and run the same
edit, held at the tolerances of test_torch_sdxl_edit.py.
"""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from rgie_tpu_torch.diffusion import load as L
from rgie_tpu_torch.diffusion import schedulers as S
from rgie_tpu_torch.diffusion import text_encoder as TE
from rgie_tpu_torch.diffusion import vae as V
from rgie_tpu_torch.diffusion.pipeline import InversionResamplingPipeline
from rgie_tpu_torch.diffusion.unet import UNetConfig, create_unet
from rgie_tpu_torch.models.midu import create_midu
from tests import test_torch_sdxl_edit as E

torch.set_num_threads(2)

STEPS = 2


def _unet_json(cfg: UNetConfig) -> dict:
    out = {"block_out_channels": list(cfg.block_out_channels),
           "down_block_types": list(cfg.down_block_types),
           "up_block_types": list(cfg.up_block_types), "layers_per_block": cfg.layers_per_block,
           "attention_head_dim": list(cfg.attention_head_dim),
           "transformer_layers_per_block": list(cfg.transformer_layers_per_block),
           "cross_attention_dim": cfg.cross_attention_dim, "norm_num_groups": cfg.norm_num_groups}
    if cfg.addition_embed_type:
        out.update(addition_embed_type=cfg.addition_embed_type,
                   addition_time_embed_dim=cfg.addition_time_embed_dim,
                   projection_class_embeddings_input_dim=(cfg.addition_pooled_dim
                                                          + 6 * cfg.addition_time_embed_dim))
    return out


def _vae_json(cfg: V.VaeConfig) -> dict:
    return {"block_out_channels": list(cfg.block_out_channels),
            "layers_per_block": cfg.layers_per_block, "norm_num_groups": cfg.norm_num_groups,
            "scaling_factor": cfg.scaling_factor}


def write_snapshot(root, is_xl: bool, seed: int = 0, legacy_vae: bool = False) -> dict:
    """A tiny diffusers snapshot of random-weight port modules (biases away
    from zero); returns the modules by subdirectory. ``legacy_vae`` writes
    the VAE's mid attention under its old names, with 1x1-conv weights."""
    from safetensors.torch import save_file

    g = torch.Generator().manual_seed(seed)
    if is_xl:
        unet_cfg = E.TINY_XL
        vae_cfg = V.VaeConfig(block_out_channels=(8, 16), layers_per_block=1, norm_num_groups=4,
                              scaling_factor=V.SDXL_SCALING)
        towers = {"text_encoder": (E.TOWER1, "quick_gelu"), "text_encoder_2": (E.TOWER2, "gelu")}
    else:
        unet_cfg, vae_cfg = UNetConfig.tiny(), V.VaeConfig.tiny()
        towers = {"text_encoder": (dict(width=32, layers=2, heads=1, act="gelu", skip_last=0),
                                   "gelu")}
    modules = {"unet": create_unet(g, unet_cfg), "vae": V.create_vae(g, vae_cfg)}
    configs = {"unet": _unet_json(unet_cfg), "vae": _vae_json(vae_cfg)}
    for sub, (cfg, act) in towers.items():
        modules[sub] = TE._random_tower(g, cfg, torch.float32)
        configs[sub] = {"hidden_act": act, "num_hidden_layers": cfg["layers"]}
    for sub, module in modules.items():
        E._randomize_biases(module, g, 0.02)
        state = {k: v.contiguous() for k, v in module.state_dict().items()}
        if sub.startswith("text_encoder"):   # HF checkpoints carry the position ids
            state["text_model.embeddings.position_ids"] = torch.arange(77)[None]
        if sub == "vae" and legacy_vae:
            for part in ("encoder", "decoder"):
                prefix = f"{part}.mid_block.attentions.0."
                for new, old in (("to_q", "query"), ("to_k", "key"), ("to_v", "value"),
                                 ("to_out.0", "proj_attn")):
                    w = state.pop(prefix + new + ".weight")
                    state[prefix + old + ".weight"] = w[:, :, None, None].contiguous()
                    state[prefix + old + ".bias"] = state.pop(prefix + new + ".bias")
        d = root / sub
        d.mkdir(parents=True)
        name = "model.safetensors" if sub.startswith("text") else \
            "diffusion_pytorch_model.safetensors"
        save_file(state, str(d / name))
        (d / "config.json").write_text(json.dumps(configs[sub]))
    return modules


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    root = tmp_path_factory.mktemp("snapshots")
    return {"sd": (root / "sd", write_snapshot(root / "sd", False, seed=1, legacy_vae=True)),
            "sdxl": (root / "sdxl", write_snapshot(root / "sdxl", True, seed=2))}


@pytest.mark.parametrize("kind", ["sd", "sdxl"])
def test_load_diffusers_checkpoint_reads_the_snapshot(snapshots, kind):
    """Configs as written (and as the JAX loader reads them), every tensor as
    written, the towers' activations from their config.json."""
    from rgie_tpu.diffusion.load import load_diffusers_checkpoint as load_j

    root, modules = snapshots[kind]
    ckpt, ckpt_j = L.load_diffusers_checkpoint(str(root)), load_j(str(root))
    assert ckpt.is_xl == ckpt_j.is_xl == (kind == "sdxl")
    # the written config.json holds the true input width of the added embedding
    # (the tiny config's field keeps SDXL's 2816, which the modules do not read)
    written = _unet_json(modules["unet"].cfg).get("projection_class_embeddings_input_dim")
    assert ckpt.unet_cfg == dataclasses.replace(
        modules["unet"].cfg, projection_class_embeddings_input_dim=written or 2816)
    assert ckpt.vae_cfg == modules["vae"].cfg
    got, expect = dataclasses.asdict(ckpt.unet_cfg), dataclasses.asdict(ckpt_j.unet_cfg)
    # the JAX modules infer the pooled width from their input; the port builds it
    got.pop("addition_pooled_dim"), expect.pop("addition_pooled_dim")
    assert got == expect
    assert dataclasses.asdict(ckpt.vae_cfg) == dataclasses.asdict(ckpt_j.vae_cfg)
    assert (ckpt.text_act, ckpt.text2_act) == (ckpt_j.text_act, ckpt_j.text2_act)
    assert ckpt.text_act == ("quick_gelu" if kind == "sdxl" else "gelu")
    assert (ckpt.text2_state is None) == (kind == "sd") and ckpt.merges_path is None
    for sub, state in (("unet", ckpt.unet_state), ("vae", ckpt.vae_state),
                       ("text_encoder", ckpt.text_state), ("text_encoder_2", ckpt.text2_state)):
        if sub not in modules:
            continue
        written = modules[sub].state_dict()
        assert set(state) == set(written), sub       # position ids dropped, legacy names mapped
        for k, v in written.items():
            np.testing.assert_array_equal(state[k].numpy(), v.numpy(), err_msg=k)


def test_load_casts_the_unet_and_vae_only(snapshots):
    ckpt = L.load_diffusers_checkpoint(str(snapshots["sdxl"][0]), dtype=torch.bfloat16)
    assert {v.dtype for v in ckpt.unet_state.values()} == {torch.bfloat16}
    assert {v.dtype for v in ckpt.vae_state.values()} == {torch.bfloat16}
    assert {v.dtype for v in ckpt.text_state.values()} == {torch.float32}
    assert {v.dtype for v in ckpt.text2_state.values()} == {torch.float32}


def test_load_state_dict_file_reads_bin(tmp_path):
    state = {"a.weight": torch.randn(3, 4), "b.bias": torch.randn(2)}
    torch.save({"state_dict": {**state, "step": 7}}, tmp_path / "pytorch_model.bin")
    got = L.load_state_dict_file(str(tmp_path / "pytorch_model.bin"))
    assert set(got) == set(state)
    for k in state:
        np.testing.assert_array_equal(got[k].numpy(), state[k].numpy())
    assert L._find_weights(str(tmp_path)) == str(tmp_path / "pytorch_model.bin")
    assert L._find_weights(str(tmp_path / "missing")) is None


def _stacks_from_checkpoints(root, is_xl):
    """The port's pipeline as the CLI builds it from the snapshot, and the JAX
    package's as scripts/adapt_images.py does, with one midu classifier."""
    from rgie_tpu.diffusion import pipeline as P_j
    from rgie_tpu.diffusion import schedulers as S_j
    from rgie_tpu.diffusion import text_encoder as TE_j
    from rgie_tpu.diffusion.load import load_diffusers_checkpoint as load_j
    from rgie_tpu.diffusion.unet import UNet2DCondition as UNet_j
    from rgie_tpu.diffusion.vae import AutoencoderKL as Vae_j
    from rgie_tpu.models import midu as M_j
    from rgie_tpu.utils import torch_convert as TC
    from rgie_tpu_torch.cli.adapt_images import _prompt_encoder
    from rgie_tpu_torch.diffusion.unet import UNet2DCondition

    ckpt, ckpt_j = L.load_diffusers_checkpoint(str(root)), load_j(str(root))
    g = torch.Generator().manual_seed(9)
    midu = E._randomize_biases(create_midu(g, is_sdxl=is_xl, in_channels=16), g)
    sigma = E.sigma_tables(STEPS) if is_xl else {}
    pipe = InversionResamplingPipeline(
        unet=L.module_from_state_dict(lambda: UNet2DCondition(ckpt.unet_cfg), ckpt.unet_state),
        vae=L.module_from_state_dict(lambda: V.AutoencoderKL(ckpt.vae_cfg), ckpt.vae_state),
        sched=S.make_schedule(STEPS), midu_model=midu, is_xl=is_xl, scheduler_type="dpm",
        **sigma)
    enc = _prompt_encoder(ckpt, is_xl, g, None, str(root))

    sigma_j = {name: S_j.make_dpm_sigma_schedule(STEPS, use_karras_sigmas=True,
                                                 use_lu_lambdas=True, inverse=inverse)
               for name, inverse in (("sigma_sched", False), ("sigma_sched_inv", True))
               } if is_xl else {}
    pipe_j = P_j.InversionResamplingPipeline(
        unet=UNet_j(ckpt_j.unet_cfg), vae=Vae_j(ckpt_j.vae_cfg),
        sched=S_j.make_schedule(STEPS), midu_model=M_j.MiduSDXL(2) if is_xl else M_j.MiduSD(2),
        is_xl=is_xl, scheduler_type="dpm", **sigma_j)
    params_j = P_j.PipelineParams(unet=ckpt_j.unet_vars, vae=ckpt_j.vae_vars,
                                  midu=E._as_jax(TC.convert_midu(E._np_state(midu), is_xl)))
    skip = 1 if is_xl else 0
    t1 = TE_j.TextEncoderHidden(**TE_j.tower_config_from_params(
        ckpt_j.text_vars["params"], skip_last=skip, act=ckpt_j.text_act))
    kw = {}
    if is_xl:
        kw = dict(tower2=TE_j.TextEncoderHidden(**TE_j.tower_config_from_params(
            ckpt_j.text2_vars["params"], skip_last=1, act=ckpt_j.text2_act)),
            variables2=ckpt_j.text2_vars)
    enc_j = TE_j.PromptEncoder(tower1=t1, variables1=ckpt_j.text_vars, **kw)
    return pipe, enc, (pipe_j, params_j, enc_j)


@pytest.mark.parametrize("kind,size", [("sd", 32), ("sdxl", E.SIZE)])
def test_edits_from_both_loaders_match(snapshots, kind, size):
    """One edit (DPM: the alphas table for SD, karras + lu for SDXL) with each
    package's models as its own loader reads them from the snapshot."""
    root, _ = snapshots[kind]
    pipe, enc, jax_side = _stacks_from_checkpoints(root, kind == "sdxl")
    assert pipe.unet.dtype == torch.float32 and not any(
        p.requires_grad for p in pipe.unet.parameters())
    image = np.random.default_rng(3).uniform(0, 1, (1, size, size, 3)).astype(np.float32)
    run = E.run_edit_pair(pipe, enc, image, jax_side=jax_side)
    outputs, log = run["port"]
    lat_j = run["pipe_j"].encode_image(run["params_j"], E.jnp.asarray(image))
    np.testing.assert_allclose(log.tensors["latents"].numpy(), np.asarray(lat_j), atol=2e-5)
    assert len(log.clf_grad_norms) == STEPS
    np.testing.assert_allclose(outputs["a"].numpy(), np.asarray(run["jax"]["a"]), atol=1e-3)


def test_sdxl_snapshot_without_second_tower_raises(snapshots, tmp_path):
    from rgie_tpu_torch.cli import adapt_images as cli

    root = tmp_path / "no_tower_2"
    shutil.copytree(snapshots["sdxl"][0], root, ignore=shutil.ignore_patterns("text_encoder_2"))
    args = cli.build_parser().parse_args(["--scale", "sdxl", "--diffusers-dir", str(root),
                                          "--input-size", str(E.SIZE), "--device", "cpu"])
    with pytest.raises(ValueError, match="text_encoder_2"):
        cli.build_models(args, torch.Generator().manual_seed(0), torch.device("cpu"))


def test_sdxl_snapshot_at_a_size_midu_cannot_read_raises(snapshots):
    from rgie_tpu_torch.cli import adapt_images as cli

    args = cli.build_parser().parse_args(["--diffusers-dir", str(snapshots["sdxl"][0]),
                                          "--input-size", "64", "--device", "cpu"])
    with pytest.raises(ValueError, match="32 x 32"):
        cli.build_models(args, torch.Generator().manual_seed(0), torch.device("cpu"))


# ---------------------------------------------------------------------------
# The CLI on the snapshots
# ---------------------------------------------------------------------------


def _feed(root, rng):
    from PIL import Image

    os.makedirs(root / "annotations")
    os.makedirs(root / "images")
    Image.fromarray((rng.uniform(0, 1, (140, 150, 3)) * 255).astype(np.uint8)).save(
        root / "images" / f"{1:012d}.jpg")
    with open(root / "annotations" / "captions.json", "w") as f:
        json.dump({"1": "a random image/a second caption"}, f)
    return root


@pytest.mark.parametrize("kind,flags", [
    ("sdxl", ["--scheduler", "dpm"]),
    ("sdxl", ["--scheduler", "dpm", "--vae-tile", "24"]),
    ("sdxl", ["--scheduler", "dpm", "--dpm-diffusers-exact", "--no-nto"]),
    ("sd", ["--scheduler", "dpm", "--input-size", "32"])])
def test_cli_edits_snapshot_on_cpu(snapshots, tmp_path, rng, capsys, kind, flags):
    """``--scale sdxl --diffusers-dir`` with ``--scheduler dpm`` (karras + lu,
    forward and inverse), then with ``--vae-tile``, then the diffusers-exact
    tables; the SD snapshot with table DPM."""
    from PIL import Image

    from rgie_tpu_torch.cli.adapt_images import main

    data, out = _feed(tmp_path / "data", rng), tmp_path / "out"
    size = 32 if kind == "sd" else E.SIZE
    scale = "tiny" if kind == "sd" else kind
    main(["--data-dir", str(data), "--out-dir", str(out), "--scale", scale,
          "--diffusers-dir", str(snapshots[kind][0]), "--num-steps", str(STEPS),
          "--device", "cpu"] + (["--input-size", str(size)] if kind == "sdxl" else []) + flags)
    written = os.listdir(out / "CG_CFG_2_0.2")
    assert written == [f"{1:012d}.jpg"]
    assert Image.open(out / "CG_CFG_2_0.2" / written[0]).size == (size, size)
    printed = capsys.readouterr().out
    assert f"(xl={kind == 'sdxl'}, bpe=fallback)" in printed
    assert printed.count("Score original:") == 1 and printed.count("Score adapted:") == 1
    assert printed.count("Reconstruction error:") == 1
