"""Distributional image-quality metrics: FID, KID, Inception Score. Port of
``rgie_tpu/analysis/fid.py``: the metric maths in numpy and scipy as they
are there, over features from a pluggable extractor.

Reference: ``src/analysis/process_result_images.py:78-87`` calls
torch_fidelity.calculate_metrics(isc=True, fid=True, kid=True). For numbers
comparable to published FID/KID/ISC, use the Inception-v3 extractor
(``rgie_tpu_torch.models.inception.make_feature_extractor`` with a
pytorch-fid or torchvision checkpoint, ``load_inception``); the CLIP
extractor below gives the "CLIP-FID" variant. Feature extraction runs in
batches on the model's device; the O(d^3) covariance square root runs on the
host in scipy.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np


def feature_statistics(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    mu = features.mean(axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, sigma


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """FID = |mu1-mu2|^2 + tr(S1 + S2 - 2 sqrt(S1 S2))."""
    from scipy import linalg

    diff = mu1 - mu2
    # The same matrix as JAX's ``sqrtm(..., disp=False)[0]``; newer scipy drops ``disp``.
    covmean = linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def fid_from_features(f1: np.ndarray, f2: np.ndarray) -> float:
    return frechet_distance(*feature_statistics(f1), *feature_statistics(f2))


def kid_from_features(f1: np.ndarray, f2: np.ndarray, subset_size: int = 1000,
                      num_subsets: int = 100, seed: int = 0) -> Tuple[float, float]:
    """Unbiased polynomial-kernel MMD^2 (Binkowski et al.), torch_fidelity
    conventions: k(x,y) = (x.y/d + 1)^3, averaged over random subsets.
    Returns (mean, std)."""
    rng = np.random.default_rng(seed)
    n = min(len(f1), len(f2), subset_size)
    d = f1.shape[1]
    vals = []
    for _ in range(num_subsets):
        x = f1[rng.choice(len(f1), n, replace=False)]
        y = f2[rng.choice(len(f2), n, replace=False)]
        kxx = (x @ x.T / d + 1.0) ** 3
        kyy = (y @ y.T / d + 1.0) ** 3
        kxy = (x @ y.T / d + 1.0) ** 3
        np.fill_diagonal(kxx, 0)
        np.fill_diagonal(kyy, 0)
        mmd = kxx.sum() / (n * (n - 1)) + kyy.sum() / (n * (n - 1)) - 2 * kxy.mean()
        vals.append(mmd)
    return float(np.mean(vals)), float(np.std(vals))


def inception_score(probs: np.ndarray, splits: int = 10) -> Tuple[float, float]:
    """IS = exp(E_x KL(p(y|x) || p(y))) over class probabilities."""
    scores = []
    n = len(probs)
    for i in range(splits):
        part = probs[i * n // splits:(i + 1) * n // splits]
        if len(part) == 0:
            continue
        py = part.mean(axis=0, keepdims=True)
        kl = part * (np.log(part + 1e-12) - np.log(py + 1e-12))
        scores.append(np.exp(kl.sum(axis=1).mean()))
    return float(np.mean(scores)), float(np.std(scores))


def make_clip_feature_extractor(clip_encoder, batch_size: int = 32,
                                device: Optional["torch.device"] = None):
    """images (N, H, W, 3) [0,1] -> (N, D) features via the CLIP tower,
    batched, on the tower's device, without gradient."""
    import torch

    device = device or next(clip_encoder.parameters()).device

    @torch.no_grad()
    def extract(images: np.ndarray) -> np.ndarray:
        feats = []
        for i in range(0, len(images), batch_size):
            batch = torch.as_tensor(np.asarray(images[i:i + batch_size], np.float32),
                                    device=device)
            feats.append(clip_encoder(batch).float().cpu().numpy())
        return np.concatenate(feats, axis=0)

    return extract


def calculate_metrics(images1: np.ndarray, images2: np.ndarray,
                      feature_extractor: Callable[[np.ndarray], np.ndarray],
                      prob_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
                      kid_subset_size: int = 1000) -> dict:
    """torch_fidelity.calculate_metrics-shaped API over edited vs original
    image sets (process_result_images.py:78-87).

    ``feature_extractor`` may return either features (N, D) or a
    (features, class_probs) tuple — the Inception extractor
    (rgie_tpu_torch.models.inception.make_feature_extractor) returns both in one
    pass, giving calibrated FID/KID *and* ISC without a second sweep."""
    p1 = None
    f1 = feature_extractor(images1)
    f2 = feature_extractor(images2)
    if isinstance(f1, tuple):
        f1, p1 = f1
        f2, _ = f2
    kid_mean, kid_std = kid_from_features(f1, f2, subset_size=kid_subset_size)
    out = {
        "frechet_inception_distance": fid_from_features(f1, f2),
        "kernel_inception_distance_mean": kid_mean,
        "kernel_inception_distance_std": kid_std,
    }
    if p1 is None and prob_fn is not None:
        p1 = prob_fn(images1)
    if p1 is not None:
        isc_mean, isc_std = inception_score(p1)
        out["inception_score_mean"] = isc_mean
        out["inception_score_std"] = isc_std
    return out
