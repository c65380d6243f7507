"""Miscellaneous host helpers from the reference's ``baselines/utils.py``
(the port's copy of ``rgie_tpu/utils/misc.py``): device information, dataset
splits, row interleaving and a headless image grid."""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np


def has_display() -> bool:
    """(utils.py:16-17)"""
    return bool(os.environ.get("DISPLAY"))


def get_device_info() -> str:
    """What the reference's get_torch_device (utils.py:20-28) picks, as
    "platform xcount": the CUDA devices when there are any, else the CPU."""
    import torch

    if torch.cuda.is_available():
        return f"cuda x{torch.cuda.device_count()} ({torch.cuda.get_device_name(0)})"
    return "cpu x1"


def interweave_batch_tensors(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Interleave two (B, D) arrays row-wise: [a0, b0, a1, b1, ...]
    (utils.py:231-238)."""
    a, b = np.asarray(a), np.asarray(b)
    out = np.empty((a.shape[0] + b.shape[0],) + a.shape[1:], dtype=a.dtype)
    out[0::2] = a
    out[1::2] = b
    return out


def create_dataset_splits(n: int, val_fraction: float = 0.2,
                          seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Random train/val index split (utils.py:83-96)."""
    perm = np.random.default_rng(seed).permutation(n)
    n_val = int(round(n * val_fraction))
    return perm[n_val:], perm[:n_val]


def perform_val_train_split(items: Sequence, val_fraction: float = 0.2,
                            seed: int = 0) -> Tuple[List, List]:
    """(utils.py:210-214)"""
    train_ix, val_ix = create_dataset_splits(len(items), val_fraction, seed)
    items = list(items)
    return [items[i] for i in train_ix], [items[i] for i in val_ix]


def plot_imgs_tensor(images: np.ndarray, titles=None, save_path: str = None):
    """Grid plot of NHWC images in [0, 1] (utils.py:139-143); saved headlessly
    (to ``save_path``, or images.png without a display)."""
    import matplotlib

    if not has_display():
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    images = np.asarray(images)
    n = images.shape[0]
    fig, axes = plt.subplots(1, n, figsize=(3 * n, 3))
    axes = [axes] if n == 1 else list(axes)
    if isinstance(titles, str):
        titles = [titles] * n
    for i, ax in enumerate(axes):
        ax.imshow(np.clip(images[i], 0, 1))
        if titles is not None and i < len(titles):
            ax.set_title(titles[i], fontsize=9)
        ax.axis("off")
    fig.tight_layout()
    if save_path or not has_display():
        out = save_path or "images.png"
        fig.savefig(out, dpi=100)
        plt.close(fig)
        return out
    plt.show()
    return None
