"""Result-image post-processing: per-method VA and low-level metrics, the
significance tests, and distributional quality. Port of
``rgie_tpu/analysis/process_results.py``, on a column table (a
``{column: array}`` dict) instead of a pandas frame; ``to_frame`` and
``write_csv`` give the JAX package's frame and CSV.

Reference: ``src/analysis/process_result_images.py:17-89``: a folder of
``{name}_{method}.jpg`` outputs -> VA + 6 low-level metrics per image,
Kruskal/ANOVA per metric, FID/KID/ISC per method against the originals.
"""

from __future__ import annotations

import csv
import os
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np

from rgie_tpu_torch.analysis import low_level_metrics as llim
from rgie_tpu_torch.analysis.predict_va import get_classifier_score_of_images
from rgie_tpu_torch.analysis.stats_tests import one_way_stats_test

METRIC_COLUMNS = ("valence", "arousal", "saturation", "bright", "colorful",
                  "light", "contrast", "blur")
COLUMNS = ("method", *METRIC_COLUMNS, "image_path")


def collect_scores(folder_path: str, model_path: Optional[str] = None,
                   device="cuda") -> Dict[str, np.ndarray]:
    """Scan ``{name}_{method}.jpg`` files (a one-character method is
    'original', process_result_images.py:30-35) into the column table, one
    row per image that scored; an image that fails is reported and skipped
    (the reference's per-image fault isolation, :57-58)."""
    rows: Dict[str, list] = {k: [] for k in COLUMNS}
    for filename in sorted(os.listdir(folder_path)):
        if not (filename.endswith(".jpg") and "_" in filename):
            continue
        try:
            _, flag_ext = filename.rsplit("_", 1)
            flag = flag_ext.split(".")[0]
            if len(flag) == 1:
                flag = "original"
            path = os.path.join(folder_path, filename)
            score = get_classifier_score_of_images([path], "va", model_path, device)
            row = {"method": flag, "valence": float(score[0, 0]), "arousal": float(score[0, 1]),
                   "saturation": llim.compute_mean_saturation(path),
                   "bright": llim.compute_mean_brightness(path),
                   "colorful": llim.calculate_colorfulness(path),
                   "light": llim.compute_lighting_diversity(path),
                   "contrast": llim.compute_rms_contrast(path),
                   "blur": llim.compute_blur_effect(path), "image_path": path}
        except Exception as e:  # per-image fault isolation (reference :57-58)
            print(f"Error processing {filename}: {e}")
            continue
        for k in COLUMNS:
            rows[k].append(row[k])
    return {k: np.asarray(v, dtype=object if k in ("method", "image_path") else np.float64)
            for k, v in rows.items()}


def table_size(table: Dict[str, np.ndarray]) -> int:
    return len(table["method"])


def group_paths(table: Dict[str, np.ndarray]) -> Dict[str, List[str]]:
    """Image paths per method, methods sorted (pandas' ``groupby``)."""
    out: Dict[str, List[str]] = {}
    for method in sorted(set(table["method"].tolist())):
        out[method] = [p for m, p in zip(table["method"], table["image_path"]) if m == method]
    return out


def method_means(table: Dict[str, np.ndarray]) -> Dict[str, Dict[str, float]]:
    """{metric: {method: mean}}, methods sorted (the JAX report's
    ``groupby("method").mean().to_dict()``)."""
    methods = sorted(set(table["method"].tolist()))
    return {metric: {m: float(table[metric][table["method"] == m].mean()) for m in methods}
            for metric in METRIC_COLUMNS}


def to_frame(table: Dict[str, np.ndarray]):
    """The JAX package's pandas frame of the table."""
    import pandas as pd

    return pd.DataFrame({k: list(v) for k, v in table.items()})


def write_csv(table: Dict[str, np.ndarray], path: str) -> None:
    """The table as the JAX CLI's CSV (``DataFrame.to_csv(index=False)``:
    a header of the columns, floats written as Python writes them)."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(table.keys())
        for i in range(table_size(table)):
            writer.writerow([v[i].item() if isinstance(v[i], np.generic) else v[i]
                             for v in table.values()])


def load_image_set(paths: List[str], size: int = 299) -> np.ndarray:
    from rgie_tpu_torch.data.dataset import load_image_rgb, preprocess_image

    return np.concatenate([preprocess_image(load_image_rgb(p), size, size) for p in paths])


class Analysis(NamedTuple):
    table: Dict[str, np.ndarray]   # one row per scored image, COLUMNS
    stats: Dict[str, dict]         # per metric: one_way_stats_test's result
    quality: Dict[str, dict]       # per method: calculate_metrics against the originals


def analyse(table: Dict[str, np.ndarray], feature_extractor: Optional[Callable] = None,
            kid_subset_size: Optional[int] = 20, verbose: bool = True) -> Analysis:
    """The stats test of every metric across methods and, with a feature
    extractor and originals, FID/KID/ISC of each method against them
    (``kid_subset_size=None``: the smaller of 4 and the method's images, as
    the JAX report takes it)."""
    from rgie_tpu_torch.analysis.fid import calculate_metrics

    stats = {}
    for metric in METRIC_COLUMNS:
        if len(set(table["method"].tolist())) > 1:
            stats[metric] = one_way_stats_test(table, "method", metric, verbose=verbose)
    quality = {}
    grouped = group_paths(table)
    if "original" in grouped and feature_extractor is not None:
        originals = load_image_set(grouped["original"])
        for method, paths in grouped.items():
            if method == "original":
                continue
            subset = kid_subset_size if kid_subset_size is not None else min(4, len(paths))
            quality[method] = calculate_metrics(originals, load_image_set(paths),
                                                feature_extractor, kid_subset_size=subset)
            if verbose:
                print(method)
                print(quality[method])
    return Analysis(table=table, stats=stats, quality=quality)


def process_result_images(folder_path: str, model_path: Optional[str] = None,
                          feature_extractor: Optional[Callable] = None,
                          kid_subset_size: int = 20, device="cuda") -> Analysis:
    """Full analysis pass (process_result_images.py:17-89): scores, the
    stats test per metric, and FID/KID/ISC per method against the
    originals, each printed as it comes."""
    table = collect_scores(folder_path, model_path, device)
    if table_size(table) == 0:
        print("no result images found")
        return Analysis(table=table, stats={}, quality={})
    return analyse(table, feature_extractor, kid_subset_size)
