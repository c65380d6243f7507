"""Run statistics accumulation and reporting. The port's own copy of
``rgie_tpu/utils/stats.py`` (numpy only).

Reference: STATS dicts + helpers in `src/baselines/utils.py`
(`check_init_stats_adapt:284-288`, `print_stats:274-281`, `cohen_d:241-251`)
and the printed-score format of `src/adapt_images/scoring.py:28-40` (kept
verbatim for parity diffing).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

STAT_KEYS = ("rec_error", "valence", "arousal", "delta_valence", "delta_arousal")


def check_init_stats_adapt(stats: Dict[str, Dict[str, List[float]]], adaptation: str) -> None:
    """Ensure per-adaptation stat lists exist (utils.py:284-288)."""
    if adaptation not in stats:
        stats[adaptation] = {k: [] for k in STAT_KEYS}


def _with_arousal(score: np.ndarray) -> np.ndarray:
    """A valence-only score (an EmoNet loss, ``loss_type="valence"``) gets
    EmoNet's zero "fake arousal" column (EmoNet.py:92-96); the JAX package's
    copy indexes a second column that is not there and raises."""
    score = np.asarray(score)
    if score.shape[-1] == 1:
        score = np.concatenate([score, np.zeros_like(score)], axis=-1)
    return score


def record_edit(stats: Dict[str, List[float]], va_original: np.ndarray,
                va_adapted: np.ndarray, rec_error: float) -> None:
    """Accumulate one edit's metrics (compare_emotions, run_img_trans.py:361-386)."""
    va_original, va_adapted = _with_arousal(va_original), _with_arousal(va_adapted)
    delta = va_adapted - va_original
    stats["rec_error"].append(float(rec_error))
    stats["valence"].append(float(va_adapted[0, 0]))
    stats["arousal"].append(float(va_adapted[0, 1]))
    stats["delta_valence"].append(float(delta[0, 0]))
    stats["delta_arousal"].append(float(delta[0, 1]))


def print_stats(stats: Dict[str, Dict[str, List[float]]]) -> None:
    """Mean/std per adaptation per metric (utils.py:274-281)."""
    for adaptation, metrics in stats.items():
        print(adaptation)
        for key, values in metrics.items():
            if values:
                arr = np.asarray(values)
                print(f"  {key}: mean {arr.mean():.4f} std {arr.std():.4f} n {len(arr)}")


def print_score(score: np.ndarray, label: str, orig_score: np.ndarray = None) -> None:
    """Exact printed format of ImageScorer.print_score (scoring.py:28-40)."""
    score = _with_arousal(score)
    if orig_score is None:
        print(f"Score {label}: valence {score[0, 0]:.4f}, arousal {score[0, 1]:.4f}")
        return
    delta = score - _with_arousal(orig_score)
    print(f"Score {label}: valence {score[0, 0]:.4f} delta {delta[0, 0]:.4f}, "
          f"arousal {score[0, 1]:.4f} delta {delta[0, 1]:.4f}")


def cohen_d(x: Sequence[float], y: Sequence[float]) -> float:
    """Effect size (utils.py:241-251)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    nx, ny = len(x), len(y)
    dof = nx + ny - 2
    pooled = np.sqrt(((nx - 1) * x.std(ddof=1) ** 2 + (ny - 1) * y.std(ddof=1) ** 2) / dof)
    return float((x.mean() - y.mean()) / pooled)
