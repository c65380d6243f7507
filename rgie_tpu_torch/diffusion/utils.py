"""Diffusion utility grab-bag. A copy of ``rgie_tpu/diffusion/utils.py``,
which imports no JAX (numpy, json, PIL and scipy where a function needs them).

Reference: ``src/pipelines/diff_utils.py``, the pieces not already absorbed
into pipeline/text_encoder/schedulers: image grids, JSON experiment-feed
loaders, timestamp folders, and the exponential time-distance fit
(diff_utils.py:370-388).
"""

from __future__ import annotations

import json
from datetime import datetime
from typing import List, Optional, Sequence

import numpy as np


def image_grid(imgs: Sequence, rows: int, cols: int):
    """PIL image grid (diff_utils.py:36-44)."""
    from PIL import Image

    assert len(imgs) == rows * cols
    w, h = imgs[0].size
    grid = Image.new("RGB", size=(cols * w, rows * h))
    for i, img in enumerate(imgs):
        grid.paste(img, box=(i % cols * w, i // cols * h))
    return grid


def create_timestamp_folder_name() -> str:
    """(diff_utils.py timestamp helper)"""
    return datetime.now().strftime("%Y-%m-%d_%H-%M-%S")


def load_json(file_path: str):
    with open(file_path) as f:
        return json.load(f)


def get_fixed_exp_image_data(file_path: str, base_directory: str):
    """Experiment feed with absolute image urls (diff_utils.py:190-197)."""
    data = load_json(file_path)["data"]
    for item in data:
        item["image_url"] = base_directory + "/" + item["image_url"]
    return data


def get_feed_exp_image_data(file_path: str, base_directory: str, output_directory: str):
    """Relative-path experiment feed (diff_utils.py:199-207)."""
    data = load_json(file_path)
    for image_data in data:
        rel = image_data["relative_path"]
        image_data["image_path"] = base_directory + "/" + rel
        image_data["output_path"] = output_directory + "/" + "/".join(rel.split("/")[:-1])
    return data


def exponential_func(t, a, b, c):
    return a * np.exp(b * t) + c


def fit_time_distance(time, dis, ref_dis=None, do_plot: bool = True,
                      plot_path: Optional[str] = None):
    """Fit a * exp(b t) + c to latent-distance-over-time curves
    (diff_utils.py:370-388). Returns (params or None, fitted points or None);
    plots headlessly when requested."""
    from scipy.optimize import curve_fit

    time = np.asarray(time, dtype=np.float64)
    dis = np.asarray(dis, dtype=np.float64)
    fitted = None
    params = None
    try:
        popt, _ = curve_fit(exponential_func, time, dis, p0=(1, 0.1, 0.1), maxfev=5000)
        params = tuple(popt)
        print(f"Exp Function: f(t) = {popt[0]} * exp({popt[1]} * t) + {popt[2]}")
        fitted = exponential_func(time, *popt)
    except RuntimeError:
        pass

    if do_plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots()
        ax.plot(time, dis, label="distance")
        if ref_dis is not None:
            ax.plot(time, np.asarray(ref_dis), label="reference")
        if fitted is not None:
            ax.plot(time, fitted, label="exp fit")
        ax.set_xlabel("time")
        ax.legend()
        fig.savefig(plot_path or "time_distance.png", dpi=100)
        plt.close(fig)
    return params, fitted
