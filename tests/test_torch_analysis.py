"""The analysis suite of the port (``rgie_tpu_torch/analysis``) against the JAX
package's on the CPU: the FID, KID and Inception Score maths on the same
features, the CLIP feature extractor with the same weights, the
significance tests on a plain column table against JAX's on the same pandas
frame, VA scoring and ``collect_scores`` over a folder of images with the
same regressor weights, the CSV, and ``scale_single_image``.

Tolerances: the metric maths are the same numpy/scipy code on float64
features, 1e-10 relative; the stats tests the same scipy calls on the same
numbers, 1e-12; VA predictions of a float32 ResNet-50 on both sides 1e-5;
the low-level metrics are the same numpy code on the same files, equal; CLIP
features 1e-5 (the models' own parity test's).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from rgie_tpu.analysis import fid as FJ
from rgie_tpu.analysis import stats_tests as STJ
from rgie_tpu_torch.analysis import fid as F
from rgie_tpu_torch.analysis import process_results as PR
from rgie_tpu_torch.analysis import stats_tests as ST

torch.set_num_threads(2)

MATH_RTOL, STATS_RTOL, VA_ATOL = 1e-10, 1e-12, 1e-5


def test_fid_kid_isc_maths_equal_the_jax_package(rng):
    f1 = rng.standard_normal((12, 24)) * 0.3 + 0.1
    f2 = rng.standard_normal((10, 24)) * 0.5
    probs = rng.dirichlet(np.ones(7), size=12)
    for a, b in zip(F.feature_statistics(f1), FJ.feature_statistics(f1)):
        np.testing.assert_allclose(a, b, rtol=MATH_RTOL)
    got, expect = F.fid_from_features(f1, f2), FJ.fid_from_features(f1, f2)
    assert got > 0 and abs(got - expect) <= MATH_RTOL * abs(expect)
    assert abs(F.fid_from_features(f1, f1)) < 1e-6
    for subset in (5, 100):
        got = F.kid_from_features(f1, f2, subset_size=subset, num_subsets=7, seed=3)
        expect = FJ.kid_from_features(f1, f2, subset_size=subset, num_subsets=7, seed=3)
        np.testing.assert_allclose(got, expect, rtol=MATH_RTOL)
    for splits in (1, 3, 10):
        np.testing.assert_allclose(F.inception_score(probs, splits),
                                   FJ.inception_score(probs, splits), rtol=MATH_RTOL)

    pair = lambda x: (x.reshape(len(x), -1)[:, :24].astype(np.float64), probs[:len(x)])
    imgs1, imgs2 = rng.uniform(0, 1, (12, 4, 2, 3)), rng.uniform(0, 1, (10, 4, 2, 3))
    got = F.calculate_metrics(imgs1, imgs2, pair, kid_subset_size=6)
    expect = FJ.calculate_metrics(imgs1, imgs2, pair, kid_subset_size=6)
    assert set(got) == set(expect) and "inception_score_mean" in got
    for k in expect:
        np.testing.assert_allclose(got[k], expect[k], rtol=MATH_RTOL, err_msg=k)
    feats_only = lambda x: pair(x)[0]
    prob_fn = lambda x: probs[:len(x)]
    got = F.calculate_metrics(imgs1, imgs2, feats_only, prob_fn, kid_subset_size=6)
    expect = FJ.calculate_metrics(imgs1, imgs2, feats_only, prob_fn, kid_subset_size=6)
    for k in expect:
        np.testing.assert_allclose(got[k], expect[k], rtol=MATH_RTOL, err_msg=k)


def test_clip_feature_extractor_matches_jax(rng):
    from rgie_tpu.models.clip import ClipImageEncoder, VisionTransformer
    from rgie_tpu.utils import torch_convert as TC
    from rgie_tpu_torch.models.clip import create_clip_image_encoder

    small = dict(width=32, layers=2, heads=2, patch_size=16, input_resolution=64, output_dim=16)
    enc = create_clip_image_encoder(torch.Generator().manual_seed(0), **small)
    variables = jax.tree.map(jnp.asarray, TC.convert_clip_visual(
        {k: v.numpy() for k, v in enc.model.state_dict().items()}, layers=2, heads=2, width=32))
    enc_j = ClipImageEncoder(variables=variables, model=VisionTransformer(**small))
    images = rng.uniform(0, 1, (5, 48, 48, 3)).astype(np.float32)
    got = F.make_clip_feature_extractor(enc, batch_size=2)(images)
    expect = FJ.make_clip_feature_extractor(enc_j, batch_size=2)(images)
    assert got.shape == (5, 16) and got.dtype == np.float32
    np.testing.assert_allclose(got, expect, rtol=0, atol=1e-5)


def _table(rng, normal):
    """Three methods of 8 values: normal (ANOVA branch) or skewed (Kruskal)."""
    methods = np.repeat(np.asarray(["original", "param", "gan"], dtype=object), 8)
    if normal:
        values = rng.standard_normal(24) * 0.5 + np.repeat([0.0, 1.4, 0.2], 8)
    else:
        values = rng.exponential(1.0, 24) ** 3 + np.repeat([0.0, 4.0, 0.0], 8)
    order = rng.permutation(24)
    return {"method": methods[order], "valence": values[order]}


def _assert_result_equal(got, expect):
    assert got.keys() == expect.keys() and got["test"] == expect["test"]
    for k in ("statistic", "p_value"):
        assert abs(got[k] - expect[k]) <= STATS_RTOL * max(abs(expect[k]), 1e-300), k
    if "posthoc" in expect:
        assert got["posthoc"].keys() == expect["posthoc"].keys()
        for pair, p in expect["posthoc"].items():
            assert abs(got["posthoc"][pair] - p) <= STATS_RTOL * max(p, 1e-300), pair


@pytest.mark.parametrize("normal,test", [(True, "anova"), (False, "kruskal")])
def test_stats_tests_on_a_dict_table_equal_jax_on_the_same_frame(rng, capsys, normal, test):
    table = _table(rng, normal)
    frame = pd.DataFrame({k: list(v) for k, v in table.items()})
    got = ST.one_way_stats_test(table, "method", "valence")
    printed = capsys.readouterr().out
    expect = STJ.one_way_stats_test(frame, "method", "valence")
    printed_j = capsys.readouterr().out
    assert got["test"] == test and "posthoc" in got
    _assert_result_equal(got, expect)
    assert printed == printed_j
    # a frame still works, and quietly
    _assert_result_equal(ST.one_way_stats_test(frame, "method", "valence", verbose=False),
                         expect)
    assert capsys.readouterr().out == ""
    assert ST.levels(table, "method") == list(frame["method"].unique())
    np.testing.assert_array_equal(ST.adjust_pvalues([0.01, 0.04, 0.03], "holm"),
                                  STJ.adjust_pvalues([0.01, 0.04, 0.03], "holm"))


@pytest.fixture(scope="module")
def scoring_setup(tmp_path_factory):
    """A folder of {name}_{method}.jpg images (one that is not a JPEG, to be
    skipped) and a regressor checkpoint both packages read."""
    from PIL import Image

    from rgie_tpu_torch.models.emotion import create_regressor

    root = tmp_path_factory.mktemp("results")
    rng = np.random.default_rng(5)
    for name in ("a_o", "a_param", "b_o", "b_param"):
        arr = (rng.uniform(0, 1, (20, 24, 3)) * 255).astype(np.uint8)
        Image.fromarray(arr).save(root / f"{name}.jpg")
    (root / "c_gan.jpg").write_text("not an image")
    (root / "notes.txt").write_text("skipped")
    reg = create_regressor(torch.Generator().manual_seed(2))
    path = tmp_path_factory.mktemp("va") / "va_pred_all.pt"
    torch.save(reg.net.state_dict(), path)
    return str(root), str(path)


@pytest.fixture
def fresh_jax_scorer(monkeypatch):
    """The JAX package keeps one scorer for its process: start from none."""
    from rgie_tpu.analysis import predict_va as PJ

    monkeypatch.setattr(PJ, "_LOSS", None)
    monkeypatch.setattr(PJ, "_SCORE_FN", None)
    return PJ


def test_collect_scores_and_predict_va_match_jax(scoring_setup, fresh_jax_scorer, tmp_path,
                                                 capsys):
    from rgie_tpu.analysis import process_results as PRJ
    from rgie_tpu_torch.analysis import predict_va as PV

    folder, model_path = scoring_setup
    table = PR.collect_scores(folder, model_path, device="cpu")
    printed = capsys.readouterr().out
    frame = PRJ.collect_scores(folder, model_path)
    assert "Error processing c_gan.jpg" in printed
    assert list(table) == list(frame.columns) == list(PR.COLUMNS)
    assert table["method"].tolist() == frame["method"].tolist() == ["original", "param",
                                                                    "original", "param"]
    assert table["image_path"].tolist() == frame["image_path"].tolist()
    for col in PR.METRIC_COLUMNS:
        if col in ("valence", "arousal"):
            np.testing.assert_allclose(table[col], frame[col].values, rtol=0, atol=VA_ATOL)
        else:
            np.testing.assert_array_equal(table[col], frame[col].values, err_msg=col)

    # one image again, and "emonet": the valence column of the same ResNet-50
    # regressor (as in the JAX package)
    path = os.path.join(folder, "b_o.jpg")
    va = PV.predict_valence_arousal(path, model_path, device="cpu")
    np.testing.assert_array_equal(va, [table["valence"][2], table["arousal"][2]])
    valence = PV.get_classifier_score_of_images([path], "emonet", model_path, device="cpu")
    assert valence.shape == (1, 1) and valence[0, 0] == va[0]

    # the CSV is the JAX CLI's (DataFrame.to_csv(index=False)) of the same table
    PR.write_csv(table, str(tmp_path / "ours.csv"))
    PR.to_frame(table).to_csv(tmp_path / "frame.csv", index=False)
    assert (tmp_path / "ours.csv").read_text() == (tmp_path / "frame.csv").read_text()
    means = PR.method_means(table)
    expect_means = PR.to_frame(table).drop(columns=["image_path"]).groupby("method").mean()
    for metric in PR.METRIC_COLUMNS:
        for method, v in means[metric].items():
            assert abs(v - expect_means.loc[method, metric]) <= 1e-12 * max(abs(v), 1.0)


def test_process_result_images_cli_on_the_cpu(scoring_setup, tmp_path, capsys):
    """The CLI over the folder with --fid --clip-fid and --csv: one table row
    per scored image, the stats test of every metric, FID/KID/ISC of 'param'
    against the originals; without --clip-fid the features are a random
    full-width Inception-v3's (2048-d, 1008 classes)."""
    from rgie_tpu_torch.cli import process_result_images as CLI

    folder, model_path = scoring_setup
    analysis = CLI.main([folder, "--va-model", model_path, "--fid", "--clip-fid",
                         "--kid-subset", "2", "--csv", str(tmp_path / "scores.csv"),
                         "--device", "cpu"])
    assert PR.table_size(analysis.table) == 4
    assert set(analysis.stats) == set(PR.METRIC_COLUMNS)
    assert set(analysis.quality) == {"param"}
    q = analysis.quality["param"]
    assert set(q) == {"frechet_inception_distance", "kernel_inception_distance_mean",
                      "kernel_inception_distance_std"}
    assert all(np.isfinite(v) for v in q.values())
    assert (tmp_path / "scores.csv").read_text().splitlines()[0] == ",".join(PR.COLUMNS)
    assert len((tmp_path / "scores.csv").read_text().splitlines()) == 5

    args = CLI.build_parser().parse_args([folder, "--fid"])
    extract = CLI.build_feature_extractor(args, torch.device("cpu"))
    assert "random-weight Inception-v3" in capsys.readouterr().out
    feats, probs = extract(np.full((1, 32, 32, 3), 0.5, np.float32))
    assert feats.shape == (1, 2048) and probs.shape == (1, 1008)


def test_scale_single_image_equals_the_jax_package(tmp_path, rng):
    from PIL import Image

    from rgie_tpu.analysis import image_comparison as ICJ
    from rgie_tpu_torch.analysis import image_comparison as IC

    src = tmp_path / "in.png"
    Image.fromarray((rng.uniform(0, 1, (30, 44, 3)) * 255).astype(np.uint8)).save(src)
    for size, note in ((64, None), (20, "V 0.5")):
        a = IC.scale_single_image(str(src), str(tmp_path / "ours.png"), size, note)
        b = ICJ.scale_single_image(str(src), str(tmp_path / "theirs.png"), size, note)
        np.testing.assert_array_equal(np.asarray(Image.open(a)), np.asarray(Image.open(b)))
        assert min(Image.open(a).size) == size
