"""The port stands alone: importing every module of ``rgie_tpu_torch`` and
building both CLIs' parsers loads no ``jax``, no ``flax`` and nothing of
``rgie_tpu``; the copies it keeps of JAX-free parts of ``rgie_tpu`` (config
defaults, image preprocessing, run statistics, the BPE tokenizer) equal the
originals.
"""

import dataclasses
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest

import rgie_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _module_names():
    names = [m.name for m in pkgutil.walk_packages(rgie_tpu_torch.__path__, "rgie_tpu_torch.")]
    # the Triton kernel module imports triton, which only the card machine has
    return sorted(n for n in names if not n.endswith("pointwise_chain_triton"))


def test_every_module_imports_without_jax():
    names = _module_names()
    assert len(names) >= 40 and "rgie_tpu_torch.cli.adapt_images" in names
    assert {"rgie_tpu_torch.analysis.process_results", "rgie_tpu_torch.cli.run_eval_report",
            "rgie_tpu_torch.models.emonet", "rgie_tpu_torch.models.inception"} <= set(names)
    # slice F and the last modules
    assert {f"rgie_tpu_torch.{n}" for n in (
        "parallel.mesh", "parallel.distributed", "data.native_preprocess", "data.augmentor",
        "data.prefetch", "data.stores", "losses.compound", "models.layers",
        "utils.bench_history", "utils.misc", "utils.yaml_config",
        "cli.bench_preprocess")} <= set(names)
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "from rgie_tpu_torch.cli import adapt_images, optimize_image_param, run_img_trans\n"
        "from rgie_tpu_torch.cli import bench, bench_preprocess, optimize_image_imaginaire\n"
        "from rgie_tpu_torch.cli import train_guidance_clf\n"
        "adapt_images.build_parser(); optimize_image_param.build_parser()\n"
        "run_img_trans.build_parser(); bench.build_parser(); bench_preprocess.build_parser()\n"
        "optimize_image_imaginaire.build_parser(); train_guidance_clf.build_parser()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', "
        "'rgie_tpu', 'triton', 'pandas', 'matplotlib'))\n"
        "assert not bad, bad\n"
        "print('clean', len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    # -S -s: no site customisation preloads anything into the interpreter;
    # the packages' directories are then named explicitly.
    paths = os.pathsep.join([REPO] + [p for p in sys.path if p])
    out = subprocess.run([sys.executable, "-S", "-s", "-c", code], capture_output=True, text=True,
                         cwd=REPO, env={**env, "PYTHONPATH": paths}, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("clean")


def test_sources_name_no_jax_import():
    import re

    pattern = re.compile(r"^\s*(from|import)\s+(rgie_tpu[ .]|jax|flax)", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "rgie_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 40
    for path in files:
        with open(path) as f:
            assert not pattern.search(f.read()), path


def test_attention_library_call_is_only_the_smoke_yardstick():
    hits = []
    for root, _, names in os.walk(os.path.join(REPO, "rgie_tpu_torch")):
        for n in names:
            if n.endswith((".py", ".cu", ".cuh")):
                with open(os.path.join(root, n)) as f:
                    if "scaled_dot_product_attention" in f.read():
                        hits.append(n)
    assert hits == []


@pytest.mark.parametrize("name", ["OptimizeConfig", "ParamEditConfig", "AdaptConfig",
                                  "GuidanceConfig", "GanEditConfig", "MunitGenConfig",
                                  "MunitDisConfig", "TrainGuidanceConfig"])
def test_config_defaults_equal_the_jax_package(name):
    from rgie_tpu import config as C_j
    from rgie_tpu_torch import config as C

    ours, theirs = getattr(C, name)(), getattr(C_j, name)()
    fields = [f.name for f in dataclasses.fields(theirs)]
    assert [f.name for f in dataclasses.fields(ours)] == fields
    for field in fields:
        a, b = getattr(ours, field), getattr(theirs, field)
        if dataclasses.is_dataclass(a):
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, field
    if name == "ParamEditConfig":
        assert dict(ours.adaptations)["neg_02"] == -0.1
    if name == "AdaptConfig":
        assert ours.resolved_end_iteration() == theirs.resolved_end_iteration() == 50
    if name == "GuidanceConfig":
        assert ours.resolved_label() == theirs.resolved_label() == "CG_CFG_2_0.2"


@pytest.mark.parametrize("path", ["training/prediction_stats.py",
                                  "analysis/low_level_metrics.py"])
def test_copied_files_equal_the_originals_below_their_docstring(path):
    """JAX-free modules the port copies: everything after the module docstring
    is the original's, byte for byte."""
    def body(package):
        with open(os.path.join(REPO, package, path), "rb") as f:
            text = f.read()
        assert text.startswith(b'"""')
        return text.split(b'"""\n', 1)[1]

    assert body("rgie_tpu_torch") == body("rgie_tpu")


def test_paths_equal_the_jax_package():
    from rgie_tpu import config as C_j
    from rgie_tpu_torch import config as C

    for name in ("PROJECT_ROOT", "ARTIFACTS_DIR", "MODELS_DIR", "DATA_DIR", "OUT_DIR"):
        assert getattr(C, name) == getattr(C_j, name), name


@pytest.mark.parametrize("shape,size,crop,normalize", [((80, 72, 3), 64, 64, False),
                                                       ((50, 90, 3), 48, 40, True),
                                                       ((33, 33, 3), 64, 64, False)])
def test_preprocess_image_equals_the_jax_package(rng, shape, size, crop, normalize):
    from rgie_tpu.data import dataset as D_j
    from rgie_tpu_torch.data import dataset as D

    image = rng.uniform(0, 1, shape).astype(np.float32)
    got = D.preprocess_image(image, size, crop, normalize)
    assert got.shape == (1, crop, crop, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, D_j.preprocess_image(image, size, crop, normalize))


def test_dataset_feed_equals_the_jax_package(tmp_path, rng):
    import json

    from PIL import Image

    from rgie_tpu.data import dataset as D_j
    from rgie_tpu_torch.data import dataset as D

    os.makedirs(tmp_path / "annotations")
    os.makedirs(tmp_path / "images")
    captions = {}
    for i in range(3):
        arr = (rng.uniform(0, 1, (40 + i, 48, 3)) * 255).astype(np.uint8)
        Image.fromarray(arr).save(tmp_path / "images" / f"{i + 1:012d}.jpg")
        captions[str(i + 1)] = f"caption {i}/other"
    Image.fromarray(arr[:, :, 0]).save(tmp_path / "gray.png")
    with open(tmp_path / "annotations" / "captions.json", "w") as f:
        json.dump(captions, f)
    ours, theirs = D.CaptionFeedDataset(str(tmp_path)), D_j.CaptionFeedDataset(str(tmp_path))
    assert len(ours) == len(theirs) == 3
    for i in range(3):
        (img, meta), (img_j, meta_j) = ours[i], theirs[i]
        np.testing.assert_array_equal(img, img_j)
        assert meta == meta_j
    assert D.first_caption(ours[0][1][2]) == D_j.first_caption(theirs[0][1][2]) == "caption 0"
    np.testing.assert_array_equal(D.load_image_rgb(str(tmp_path / "gray.png")),
                                  D_j.load_image_rgb(str(tmp_path / "gray.png")))
    for (a, metas), (b, metas_j) in zip(D.iterate_batches(ours, 2, 32, 32, limit=3),
                                        D_j.iterate_batches(theirs, 2, 32, 32, limit=3)):
        np.testing.assert_array_equal(a, b)
        assert metas == metas_j


def test_stats_equal_the_jax_package(capsys):
    from rgie_tpu.utils import stats as S_j
    from rgie_tpu_torch.utils import stats as S

    va0, va1 = np.asarray([[0.4, 0.5]], np.float32), np.asarray([[0.45, 0.3]], np.float32)
    printed = []
    for mod in (S, S_j):
        stats = {}
        mod.check_init_stats_adapt(stats, "pos")
        mod.record_edit(stats["pos"], va0, va1, 0.25)
        mod.print_score(va1, "adapted", va0)
        mod.print_score(va0, "original")
        mod.print_stats(stats)
        printed.append((stats, capsys.readouterr().out))
    assert printed[0] == printed[1]
    assert S.STAT_KEYS == S_j.STAT_KEYS
    assert S.cohen_d([1, 2, 3, 4], [2, 3, 4, 6]) == S_j.cohen_d([1, 2, 3, 4], [2, 3, 4, 6])


def test_bpe_equals_the_jax_package(tmp_path):
    from rgie_tpu.diffusion import bpe as B_j
    from rgie_tpu_torch.diffusion import bpe as B

    merges = ["#version: 0.2", "t h", "th e</w>", "a n", "an d</w>", "c a", "ca t</w>"]
    path = tmp_path / "merges.txt"
    path.write_text("\n".join(merges) + "\n")
    ours, theirs = B.SimpleBPE(str(path)), B_j.SimpleBPE(str(path))
    for text in ["The cat and the hat", "it's   café &amp; naïve“quotes”", "１２３ ＡＢＣ"]:
        assert ours(text) == theirs(text), text
        assert B.word_split(text) == B_j.word_split(text)
        assert B._word_split_scan(text) == B_j._word_split_scan(text)


def test_load_torch_state_dict(tmp_path):
    import torch

    from rgie_tpu.utils.torch_convert import load_torch_state_dict as load_j
    from rgie_tpu_torch.utils.checkpoint import load_torch_state_dict

    state = {"a.weight": torch.arange(6.0).reshape(2, 3), "b": torch.tensor(3)}
    torch.save({"state_dict": state, "epoch": 3}, tmp_path / "wrapped.pt")
    torch.save({**state, "note": "text"}, tmp_path / "flat.pt")
    for name in ("wrapped.pt", "flat.pt"):
        got, expect = load_torch_state_dict(str(tmp_path / name)), load_j(str(tmp_path / name))
        assert set(got) == set(expect) == {"a.weight", "b"}
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), expect[k])


def test_diffusion_utils_equal_the_jax_package(tmp_path, capsys):
    import json

    from PIL import Image

    from rgie_tpu.diffusion import utils as U_j
    from rgie_tpu_torch.diffusion import utils as U

    imgs = [Image.new("RGB", (8, 6), (i * 40, 10, 0)) for i in range(6)]
    np.testing.assert_array_equal(np.asarray(U.image_grid(imgs, 2, 3)),
                                  np.asarray(U_j.image_grid(imgs, 2, 3)))
    t = np.linspace(0, 5, 30)
    y = U.exponential_func(t, 2.0, 0.5, 1.0) + np.random.default_rng(0).normal(0, 0.01, 30)
    (params, fitted), (params_j, fitted_j) = (
        mod.fit_time_distance(t, y, do_plot=False) for mod in (U, U_j))
    assert params == params_j and params is not None
    np.testing.assert_array_equal(fitted, fitted_j)
    assert capsys.readouterr().out.count("Exp Function") == 2
    feed = [{"relative_path": "a/b/c.jpg"}, {"relative_path": "d.jpg"}]
    (tmp_path / "feed.json").write_text(json.dumps(feed))
    (tmp_path / "fixed.json").write_text(json.dumps({"data": [{"image_url": "x.jpg"}]}))
    path = str(tmp_path / "feed.json")
    assert U.get_feed_exp_image_data(path, "/base", "/out") == U_j.get_feed_exp_image_data(
        path, "/base", "/out")
    path = str(tmp_path / "fixed.json")
    assert U.get_fixed_exp_image_data(path, "/b") == U_j.get_fixed_exp_image_data(path, "/b")
    assert len(U.create_timestamp_folder_name()) == len(U_j.create_timestamp_folder_name()) == 19
