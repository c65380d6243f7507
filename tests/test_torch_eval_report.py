"""The integrated edit -> analysis report of the port
(``rgie_tpu_torch/cli/run_eval_report.py``) at ``--scale tiny --limit 2``
with few steps, on the CPU: every method writes an edited output for every
image, and the report's analysis numbers equal the JAX package's analysis
functions run on those same files: ``collect_scores`` with the same VA
regressor weights, ``one_way_stats_test`` on the same scores, and
``calculate_metrics`` on the same image sets with the same extractor.

The report builds its Inception-v3 (16 classes at tiny scale); the test
swaps its feature extractor for pixel-block means and a fixed softmax head
(``pixel_extractor``), whose FID and KID vary with the images, where the
random Inception's features are nearly constant (FID and KID round to 0).
The Inception parity itself: tests/test_torch_inception.py. At two images
JAX's Inception Score, ten splits of at most one image, is exactly 1 for
any probabilities; its maths on more images: tests/test_torch_analysis.py.

Tolerances: VA scores of a float32 ResNet-50 on both sides 1e-5, their
method means (rounded to 5 decimals in the report) 2e-5; the low-level
metrics are the same numpy code on the same files: equal; the stats tests
and the quality metrics are the same numpy/scipy code on the same numbers,
1e-10 relative, both unrounded and as the report rounds them (5 decimals).

The file takes about 60 s on 2 threads: the report's analysis scores eight
images with the full 480/448 ten-crop ResNet-50 (about 3 s each), and the
test scores them again through JAX.
"""

import json
import os

import numpy as np
import pytest
import torch

from rgie_tpu_torch.analysis import predict_va as PV
from rgie_tpu_torch.analysis import process_results as PR
from rgie_tpu_torch.cli import run_eval_report as R

torch.set_num_threads(2)

VA_ATOL, MEAN_ATOL, MATH_RTOL = 1e-5, 2e-5, 1e-10
METHODS = ("o", "param", "gan", "diff")


_HEAD = np.random.default_rng(5).standard_normal((48, 16)) * 20.0


def pixel_extractor(images):
    """(features, probabilities) of images (N, H, W, 3): the means of a 4 x 4
    grid of blocks per channel (48-d) and a fixed softmax head on them."""
    feats = np.stack([block.mean(axis=(1, 2)) for rows in np.array_split(images, 4, axis=1)
                      for block in np.array_split(rows, 4, axis=2)], axis=1)
    feats = feats.reshape(len(images), -1).astype(np.float64)
    logits = (feats - 0.5) @ _HEAD
    probs = np.exp(logits - logits.max(axis=1, keepdims=True))
    return feats, probs / probs.sum(axis=1, keepdims=True)


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    """The report's JSON, its directory, the score table its analysis
    collected (kept by a spy on ``collect_scores``), the Inception-v3 it
    built and its ``calculate_metrics`` calls, unrounded (kept by spies)."""
    from rgie_tpu_torch.analysis import fid as F
    from rgie_tpu_torch.models import inception as I

    out = tmp_path_factory.mktemp("report")
    tables, models, metrics = [], [], []
    collect, calculate = PR.collect_scores, F.calculate_metrics

    def spy_collect(*args, **kwargs):
        tables.append(collect(*args, **kwargs))
        return tables[-1]

    def spy_extractor(model, batch_size=32, device=None):
        models.append(model)
        return pixel_extractor

    def spy_metrics(images1, images2, feature_extractor, prob_fn=None, kid_subset_size=1000):
        result = calculate(images1, images2, feature_extractor, prob_fn, kid_subset_size)
        metrics.append((images1, images2, kid_subset_size, result))
        return result

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PR, "collect_scores", spy_collect)
        mp.setattr(I, "make_feature_extractor", spy_extractor)
        mp.setattr(F, "calculate_metrics", spy_metrics)
        result = R.main(["--scale", "tiny", "--limit", "2", "--steps", "8", "--diff-steps",
                         "2", "--nto-steps", "2", "--out-dir", str(out), "--device", "cpu"])
    assert len(tables) == 1 and len(models) == 1
    return result, out, tables[0], models[0], metrics


def test_every_method_edits_every_image(report):
    from PIL import Image

    result, out, *_ = report
    names = sorted(os.listdir(out / "images"))
    assert names == sorted(f"synthetic{i}_{m}.jpg" for i in range(2) for m in METHODS)
    for i in range(2):
        orig = np.asarray(Image.open(out / "images" / f"synthetic{i}_o.jpg"), np.float32)
        for method in METHODS[1:]:
            edited = np.asarray(Image.open(out / "images" / f"synthetic{i}_{method}.jpg"),
                                np.float32)
            assert edited.shape == orig.shape == (64, 64, 3)
            assert float(np.mean(np.abs(edited - orig))) > 0.5, (i, method)

    assert result["config"] == {"scale": "tiny", "images": 2, "steps": 8, "diff_steps": 2,
                                "size": 64}
    vdt = result["va_delta_vs_target"]
    assert set(vdt) == {"target", "param", "gan", "diff", "diff_unguided",
                        "diff_guidance_effect"}
    assert vdt["target"] == [0.2, 0.2]
    assert all(np.isfinite(v).all() for v in vdt.values())
    teacher = result["midu_teacher_training"]
    assert teacher["samples"] == 2 * 8 * 2 and teacher["final_loss"] < teacher["first_loss"]
    assert json.loads((out / "eval_report.json").read_text()) == result
    md = (out / "eval_report.md").read_text()
    for heading in ("## Mean scores by method", "## Quality vs originals",
                    "## Stats tests (one-way, per metric)"):
        assert heading in md


def test_analysis_numbers_equal_the_jax_functions_on_the_same_files(report, tmp_path,
                                                                   monkeypatch):
    from rgie_tpu.analysis import fid as FJ
    from rgie_tpu.analysis import predict_va as PJ
    from rgie_tpu.analysis import process_results as PRJ
    from rgie_tpu.analysis import stats_tests as STJ

    result, out, table, _, _ = report
    # the regressor the report scored with, as a checkpoint JAX reads
    scorer = PV.scoring_model("va", None, "cpu")
    path = tmp_path / "va_pred_all.pt"
    torch.save(scorer.regressor.net.state_dict(), path)
    monkeypatch.setattr(PJ, "_LOSS", None)
    monkeypatch.setattr(PJ, "_SCORE_FN", None)
    frame = PRJ.collect_scores(str(out / "images"), str(path))
    assert table["method"].tolist() == frame["method"].tolist()
    for col in PR.METRIC_COLUMNS:
        if col in ("valence", "arousal"):
            np.testing.assert_allclose(table[col], frame[col].values, rtol=0, atol=VA_ATOL)
        else:
            np.testing.assert_array_equal(table[col], frame[col].values, err_msg=col)
    means = frame.drop(columns=["image_path"]).groupby("method").mean().round(5).to_dict()
    assert set(result["scores"]) == set(means)
    for metric, by_method in means.items():
        assert set(result["scores"][metric]) == {"original", "param", "gan", "diff"}
        for method, v in by_method.items():
            assert abs(result["scores"][metric][method] - v) <= MEAN_ATOL, (metric, method)

    # the stats tests: JAX's on a frame of the scores the report used
    ours = PR.to_frame(table)
    for metric in PR.METRIC_COLUMNS:
        expect = STJ.one_way_stats_test(ours, "method", metric, verbose=False)
        got = result["stats_tests"][metric]
        assert got["test"] == expect["test"], metric
        for k in ("statistic", "p_value"):
            assert abs(got[k] - expect[k]) <= MATH_RTOL * max(abs(expect[k]), 1e-12), metric



def test_quality_numbers_equal_jax_calculate_metrics_on_the_same_files(report):
    """FID/KID/ISC of each method against the originals: the report's
    Inception-v3 has 16 classes, each ``calculate_metrics`` call (methods in
    sorted order) reads the method's files and the originals, and its unrounded result and the
    report's rounded one equal JAX's ``calculate_metrics`` on the image sets
    JAX's ``load_image_set`` reads from those files, with the same
    extractor. FID and KID are held away from 0 so that a wrong image set or
    formula shows."""
    from rgie_tpu.analysis import fid as FJ
    from rgie_tpu.analysis import process_results as PRJ
    from rgie_tpu_torch.models.inception import InceptionV3

    result, out, _, model, metrics = report
    assert isinstance(model, InceptionV3) and model.fc.out_features == 16
    files = lambda m: sorted(str(out / "images" / f"synthetic{i}_{m}.jpg") for i in range(2))
    originals = PRJ.load_image_set(files("o"))
    assert len(metrics) == 3 and set(result["quality_vs_original"]) == {"param", "gan", "diff"}
    fids = []
    for (images1, images2, subset, got), method in zip(metrics, ("diff", "gan", "param")):
        edited = PRJ.load_image_set(files(method))
        np.testing.assert_array_equal(images1, originals)
        np.testing.assert_array_equal(images2, edited, err_msg=method)
        assert subset == 2
        expect = FJ.calculate_metrics(originals, edited, pixel_extractor, kid_subset_size=2)
        rounded = result["quality_vs_original"][method]
        assert set(got) == set(expect) == set(rounded)
        for k, v in expect.items():
            assert abs(got[k] - v) <= MATH_RTOL * abs(v), (method, k, got[k], v)
            assert abs(rounded[k] - round(float(v), 5)) <= MATH_RTOL * max(abs(v), 1.0), (
                method, k)
        assert expect["kernel_inception_distance_mean"] != 0, method
        assert expect["inception_score_mean"] == 1.0   # ten splits of at most one image
        fids.append(expect["frechet_inception_distance"])
    assert min(fids) > 1e-4 and len(set(fids)) == 3, fids
