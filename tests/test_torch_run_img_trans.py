"""The dataset transform run of the port (``rgie_tpu_torch/cli/run_img_trans.py``)
and the datasets it reads, against the JAX package on the CPU: the COCO and
image-directory datasets item for item, ``build_params`` per type (RANDOM's
draws in JAX's ranges), the CLI over a tiny COCO layout and a caption feed,
its batches against JAX's ``apply_filter_chain_fused`` on the same
parameters (on the CPU JAX runs the plain chain there, as its tests do), its
``--compare-emotions`` statistics against JAX's ``make_evaluate`` and
``utils/stats`` on the same regressor weights, and ``bench_fused_chain``.

Tolerances: images 2e-5 (K1's, tests/test_pallas.py); VA statistics 1e-5
(a float32 ResNet-50 on both sides); the deterministic parameter tables and
the datasets are equal.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgie_tpu.ops import chain as CH_j
from rgie_tpu_torch.cli import run_img_trans as R
from rgie_tpu_torch.data import dataset as D

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))

torch.set_num_threads(2)

IMAGE_TOL, STATS_TOL = 2e-5, 1e-5


def _coco(root, rng, n=3):
    """A COCO captions layout: n JPEGs under val2017/, two captions for the
    first image, and an annotation of an image that is not listed."""
    from PIL import Image

    os.makedirs(root / "val2017")
    os.makedirs(root / "annotations")
    images, annotations = [], []
    for i in range(n):
        name = f"{i * 7 + 3:012d}.jpg"
        arr = (rng.uniform(0, 1, (36 + 4 * i, 44, 3)) * 255).astype(np.uint8)
        Image.fromarray(arr).save(root / "val2017" / name)
        images.append({"id": i * 7 + 3, "file_name": name})
        annotations.append({"image_id": i * 7 + 3, "caption": f"a photo {i}"})
    annotations.append({"image_id": 3, "caption": "a second caption"})
    annotations.append({"image_id": 999, "caption": "not listed"})
    with open(root / "annotations" / "captions_val2017.json", "w") as f:
        json.dump({"images": images[::-1], "annotations": annotations}, f)


def _feed(root, rng, n=2):
    from PIL import Image

    os.makedirs(root / "images")
    os.makedirs(root / "annotations")
    for i in range(n):
        arr = (rng.uniform(0, 1, (40, 40, 3)) * 255).astype(np.uint8)
        Image.fromarray(arr).save(root / "images" / f"{i + 1:012d}.jpg")
    with open(root / "annotations" / "captions.json", "w") as f:
        json.dump({str(i + 1): f"a photo {i}" for i in range(n)}, f)


def test_coco_and_directory_datasets_equal_the_jax_package(tmp_path, rng):
    from PIL import Image

    from rgie_tpu.data import dataset as D_j

    _coco(tmp_path / "coco", rng)
    ours, theirs = D.CocoCaptionsDataset(str(tmp_path / "coco")), D_j.CocoCaptionsDataset(
        str(tmp_path / "coco"))
    assert ours.items == theirs.items and len(ours) == 3
    assert ours.items[0] == ("000000000003.jpg", "a photo 0/a second caption")
    for i in range(3):
        (img, meta), (img_j, meta_j) = ours[i], theirs[i]
        np.testing.assert_array_equal(img, img_j)
        assert meta == meta_j

    folder = tmp_path / "dir"
    os.makedirs(folder)
    for name in ("b.PNG", "a.jpg", "c.webp", "notes.txt", "d.jpeg"):
        if name.endswith(".txt"):
            (folder / name).write_text("x")
        else:
            Image.fromarray((rng.uniform(0, 1, (8, 8, 3)) * 255).astype(np.uint8)).save(
                folder / name)
    ours, theirs = D.ImageDirectoryDataset(str(folder)), D_j.ImageDirectoryDataset(str(folder))
    assert ours.files == theirs.files and len(ours) == 4
    assert ours.EXTENSIONS == theirs.EXTENSIONS
    for i in range(4):
        (img, meta), (img_j, meta_j) = ours[i], theirs[i]
        np.testing.assert_array_equal(img, img_j)
        assert meta == meta_j


@pytest.mark.parametrize("name", ["SAME", "CUSTOM", "MIN", "MAX"])
def test_fixed_parameter_tables_equal_the_jax_package(name):
    from run_img_trans import TransformationType as T_j
    from run_img_trans import build_params as build_j

    got = R.build_params(R.TransformationType[name], torch.Generator().manual_seed(0))
    expect = build_j(T_j[name], jax.random.PRNGKey(0), jnp.float32)
    for field in ("exposure", "saturation", "tone", "color", "contrast", "sharp", "blur",
                  "scale"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(expect, field)), err_msg=field)


def test_random_draws_lie_in_the_jax_ranges():
    from run_img_trans import TransformationType as T_j
    from run_img_trans import build_params as build_j

    ranges = {"exposure": (-0.5, 0.5), "saturation": (0.2, 2.5), "contrast": (0.4, 2.0),
              "sharp": (0.0, 3.0), "blur": (1e-4, 4.0), "tone": (0.6, 1.4)}
    ident = R.build_params(R.TransformationType.SAME, torch.Generator())
    drawn = [R.build_params(R.TransformationType.RANDOM, torch.Generator().manual_seed(s))
             for s in range(64)]
    drawn_j = [build_j(T_j.RANDOM, jax.random.PRNGKey(s), jnp.float32) for s in range(8)]
    for field, (lo, hi) in ranges.items():
        values = torch.stack([getattr(p, field) for p in drawn]).numpy()
        values_j = np.stack([np.asarray(getattr(p, field)) for p in drawn_j])
        assert values.min() >= lo and values.max() < hi, field
        assert values_j.min() >= lo and values_j.max() < hi, field
        assert values.shape[1:] == values_j.shape[1:], field
        # the draws spread over the range, as JAX's uniform does
        assert values.max() - values.min() > 0.5 * (hi - lo), field
    for field in ("color", "scale"):
        assert all(torch.equal(getattr(p, field), getattr(ident, field)) for p in drawn)
    a = R.build_params(R.TransformationType.RANDOM, torch.Generator().manual_seed(5))
    b = R.build_params(R.TransformationType.RANDOM, torch.Generator().manual_seed(5))
    assert torch.equal(a.tone, b.tone) and torch.equal(a.exposure, b.exposure)


@pytest.fixture(scope="module")
def regressor_file(tmp_path_factory):
    from rgie_tpu_torch.models.emotion import create_regressor

    reg = create_regressor(torch.Generator().manual_seed(11), input_size=40, crop_size=32)
    path = tmp_path_factory.mktemp("va") / "va_pred_all.pt"
    torch.save(reg.net.state_dict(), path)
    return str(path)


def _jax_params(p):
    return CH_j.FilterParams(**{k: jnp.asarray(v.numpy()) for k, v in vars(p).items()})


@pytest.mark.parametrize("ttype", ["CUSTOM", "RANDOM"])
def test_cli_on_coco_matches_jax(tmp_path, rng, regressor_file, ttype, capsys, monkeypatch):
    """The CLI over a COCO layout in batches of 2 (the tail batch of 1 is not
    padded): outputs written per image, each batch equal to JAX's fused
    chain on the same parameters, and the --compare-emotions statistics
    equal to JAX's evaluate + stats on the same regressor weights. The
    regressor's ten-crop geometry is cut from 480/448 to 40/32 through the
    loader the CLI calls."""
    from rgie_tpu.engine import parametric as P_j
    from rgie_tpu.losses.emotion_loss import ValenceArousalLoss as VAL_j
    from rgie_tpu.models.emotion import EmotionRegressor as ER_j
    from rgie_tpu.utils import stats as S_j
    from rgie_tpu.utils import torch_convert as TC

    from rgie_tpu_torch.models import loader

    load = loader.load_va_loss
    monkeypatch.setattr(loader, "load_va_loss", lambda path, generator: load(
        path, generator, input_size=40, crop_size=32))
    _coco(tmp_path / "coco", rng)
    argv = ["--data-dir", str(tmp_path / "coco"), "--dataset", "coco", "--type", ttype,
            "--batch", "2", "--input-size", "32", "--crop-size", "32", "--compare-emotions",
            "--va-model", regressor_file, "--output-dir", str(tmp_path / "out"),
            "--device", "cpu", "--seed", "3"]
    summary = R.main(argv)
    printed = capsys.readouterr().out
    assert summary.images == 3 and summary.batches == 2 and ttype in printed
    assert sorted(os.listdir(tmp_path / "out")) == [f"{i * 7 + 3:012d}.jpg" for i in range(3)]

    args = R.build_parser().parse_args(argv)
    params_j = _jax_params(summary.params)
    va_j = VAL_j(regressor=ER_j(
        variables=jax.tree.map(jnp.asarray, TC.convert_resnet50(
            TC.load_torch_state_dict(regressor_file))), input_size=40, crop_size=32))
    evaluate_j = jax.jit(P_j.make_evaluate(va_j))
    models_j = P_j.models_of(va_j, None)
    chain_j = jax.jit(lambda im: CH_j.apply_filter_chain_fused(im, params_j))
    stats_j = {}
    S_j.check_init_stats_adapt(stats_j, ttype)
    for images, adapted, _ in R.transformed_batches(args, summary.params, torch.device("cpu")):
        expect = np.asarray(chain_j(jnp.asarray(images.numpy())))
        np.testing.assert_allclose(adapted.numpy(), expect, rtol=0, atol=IMAGE_TOL)
        for b in range(images.shape[0]):
            m = evaluate_j(models_j, jnp.asarray(images[b:b + 1].numpy()),
                           jnp.asarray(adapted[b:b + 1].numpy()))
            S_j.record_edit(stats_j[ttype], np.asarray(m["va_original"]),
                            np.asarray(m["va_adapted"]), float(m["rec_error"]))
    assert set(summary.stats) == set(stats_j) == {ttype}
    for key, values in stats_j[ttype].items():
        assert len(summary.stats[ttype][key]) == len(values) == 3, key
        np.testing.assert_allclose(summary.stats[ttype][key], values, rtol=0, atol=STATS_TOL,
                                   err_msg=key)
    assert max(summary.stats[ttype]["rec_error"]) > 1e-3


def test_cli_on_a_caption_feed_with_checks_and_one_batch(tmp_path, rng):
    """--dataset feed, --check-individual (one image per chain op) and
    --one-batch, without --compare-emotions."""
    _feed(tmp_path / "feed", rng, n=3)
    summary = R.main(["--data-dir", str(tmp_path / "feed"), "--dataset", "feed", "--type", "MAX",
                      "--batch", "2", "--input-size", "36", "--crop-size", "32",
                      "--check-individual", "--one-batch", "--output-dir", str(tmp_path / "out"),
                      "--device", "cpu"])
    assert summary.images == 2 and summary.batches == 1
    assert all(not v for v in summary.stats["MAX"].values())
    names = sorted(os.listdir(tmp_path / "out"))
    assert names == sorted([f"check_{op}.jpg" for op in R.CH.DEFAULT_TRANSFORMS]
                           + ["000000000001.jpg", "000000000002.jpg"])


def test_bench_fused_chain_row_on_the_cpu():
    from rgie_tpu_torch.cli import bench_fused_chain as B

    row = B.main(["--batch", "2", "--size", "24", "--runs", "2", "--device", "cpu"])
    d = row["detail"]
    assert d["shape"] == [2, 24, 24, 3] and d["device_ms"] is None
    assert d["max_abs_err"] <= B.TOLERANCE and d["bound_by"] == "bytes"
    assert d["bytes"] == 2 * 4 * 2 * 24 * 24 * 3 and row["value"] == d["call_ms"] > 0
    assert B.build_parser().parse_args([]).batch == 12
