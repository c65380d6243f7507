"""Per-timestep prediction statistics for guidance-regressor training. A
copy of ``rgie_tpu/training/prediction_stats.py`` (JAX-free): everything
below this docstring is the original's, byte for byte
(``tests/test_torch_standalone.py`` checks it).

Reference: ``log_prediction_stats`` (``src/clf/train_guidance_clf.py:390-414``)
bins validation predictions by diffusion timestep and plots mean/std per bin
to diagnose where along the noise schedule the midu regressor is reliable.
The matplotlib figure is saved headlessly; the raw stats are returned for
JSONL logging.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def prediction_stats_by_timestep(timesteps: np.ndarray, predictions: np.ndarray,
                                 labels: np.ndarray, num_bins: int = 10,
                                 num_train_timesteps: int = 1000) -> Dict[str, np.ndarray]:
    """Bin (t, prediction, label) triples by timestep decile. Returns per-bin
    mean/std of predictions and of |prediction - label|."""
    timesteps = np.asarray(timesteps).reshape(-1)
    predictions = np.asarray(predictions).reshape(len(timesteps), -1)
    labels = np.asarray(labels).reshape(len(timesteps), -1)
    edges = np.linspace(0, num_train_timesteps, num_bins + 1)
    bin_ix = np.clip(np.digitize(timesteps, edges) - 1, 0, num_bins - 1)

    d = predictions.shape[1]
    mean = np.full((num_bins, d), np.nan)
    std = np.full((num_bins, d), np.nan)
    err = np.full((num_bins, d), np.nan)
    count = np.zeros(num_bins, dtype=np.int64)
    for b in range(num_bins):
        mask = bin_ix == b
        count[b] = mask.sum()
        if count[b]:
            mean[b] = predictions[mask].mean(axis=0)
            std[b] = predictions[mask].std(axis=0)
            err[b] = np.abs(predictions[mask] - labels[mask]).mean(axis=0)
    centers = (edges[:-1] + edges[1:]) / 2
    return {"bin_centers": centers, "mean": mean, "std": std,
            "abs_error": err, "count": count}


def plot_prediction_stats(stats: Dict[str, np.ndarray], out_path: str,
                          output_names: Optional[Sequence[str]] = None) -> str:
    """Save the per-timestep line plot (the wandb line_series analog,
    train_guidance_clf.py:417-423) headlessly."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    d = stats["mean"].shape[1]
    names = output_names or ([f"out_{i}" for i in range(d)] if d != 2
                             else ["valence", "arousal"])
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))
    for i, name in enumerate(names):
        ax1.errorbar(stats["bin_centers"], stats["mean"][:, i],
                     yerr=stats["std"][:, i], label=name, capsize=2)
        ax2.plot(stats["bin_centers"], stats["abs_error"][:, i], label=name)
    ax1.set_xlabel("timestep"); ax1.set_ylabel("prediction"); ax1.legend()
    ax1.set_title("prediction mean±std by timestep")
    ax2.set_xlabel("timestep"); ax2.set_ylabel("|error|"); ax2.legend()
    ax2.set_title("abs error by timestep")
    fig.tight_layout()
    fig.savefig(out_path, dpi=100)
    plt.close(fig)
    return out_path
