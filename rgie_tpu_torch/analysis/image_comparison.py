"""Side-by-side image comparison with VA annotations. Port of
``rgie_tpu/analysis/image_comparison.py``; pandas and matplotlib are
imported inside the functions that use them.

Reference: ``src/analysis/image_comparison.py``: an interactive matplotlib
chooser (original vs methods, keyboard selection) plus the merging of
per-method scores. This version works headless (saves comparison grids to
disk when no display) and interactive (key selection) when a display exists.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def has_display() -> bool:
    """(reference: baselines/utils.py:16-17)"""
    return bool(os.environ.get("DISPLAY"))


def show_images_in_subplot(image_paths: Sequence[str], labels: Sequence[str],
                           scores: Optional[Sequence[Tuple[float, float]]] = None,
                           save_path: Optional[str] = None):
    """Render images side by side with VA annotations
    (image_comparison.py:60-138). Headless -> save to save_path."""
    import matplotlib

    if not has_display():
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from PIL import Image

    n = len(image_paths)
    fig, axes = plt.subplots(1, n, figsize=(4 * n, 4.5))
    if n == 1:
        axes = [axes]
    for ax, path, label, ix in zip(axes, image_paths, labels, range(n)):
        ax.imshow(Image.open(path))
        title = label
        if scores is not None:
            v, a = scores[ix]
            title += f"\nvalence {v:.3f}  arousal {a:.3f}"
        ax.set_title(title, fontsize=9)
        ax.axis("off")
    plt.tight_layout()
    if save_path or not has_display():
        out = save_path or "comparison.png"
        fig.savefig(out, dpi=100)
        plt.close(fig)
        return out
    plt.show()
    return None


def user_select_image(image_paths: Sequence[str], labels: Sequence[str],
                      scores: Optional[Sequence[Tuple[float, float]]] = None) -> int:
    """Interactive selection (image_comparison.py:141-198): keyboard 1..N over
    the displayed grid; headless fallback prompts on stdin."""
    if not has_display():
        show_images_in_subplot(image_paths, labels, scores, save_path="comparison.png")
        print("saved comparison.png; enter selection index "
              f"(1..{len(image_paths)}):")
        try:
            return int(input().strip()) - 1
        except Exception:
            return -1

    import matplotlib.pyplot as plt
    from PIL import Image

    selected = {"ix": -1}
    n = len(image_paths)
    fig, axes = plt.subplots(1, n, figsize=(4 * n, 4.5))
    if n == 1:
        axes = [axes]
    for ix, (ax, path, label) in enumerate(zip(axes, image_paths, labels)):
        ax.imshow(Image.open(path))
        title = f"[{ix + 1}] {label}"
        if scores is not None:
            title += f"\nV {scores[ix][0]:.3f} A {scores[ix][1]:.3f}"
        ax.set_title(title, fontsize=9)
        ax.axis("off")

    def on_key(event):
        if event.key and event.key.isdigit():
            k = int(event.key)
            if 1 <= k <= n:
                selected["ix"] = k - 1
                plt.close(fig)

    fig.canvas.mpl_connect("key_press_event", on_key)
    plt.show()
    return selected["ix"]


def get_dataframes(folders: Dict[str, str], model_path: Optional[str] = None,
                   device="cuda"):
    """Merge per-method score frames over output folders
    (image_comparison.py:232-261); a pandas frame."""
    import pandas as pd

    from rgie_tpu_torch.analysis.process_results import collect_scores, to_frame

    frames = []
    for method, folder in folders.items():
        df = to_frame(collect_scores(folder, model_path, device))
        df["source"] = method
        frames.append(df)
    return pd.concat(frames, ignore_index=True) if frames else pd.DataFrame()


def scale_single_image(image_path: str, output_path: str, size: int = 1024,
                       annotation: Optional[str] = None) -> str:
    """Resize (+optionally annotate) one image
    (reference: analysis/scale_single_image.py:7-49)."""
    from PIL import Image, ImageDraw

    img = Image.open(image_path)
    if img.mode != "RGB":
        img = img.convert("RGB")
    w, h = img.size
    if w <= h:
        img = img.resize((size, round(h * size / w)), Image.BILINEAR)
    else:
        img = img.resize((round(w * size / h), size), Image.BILINEAR)
    if annotation:
        draw = ImageDraw.Draw(img)
        draw.text((10, 10), annotation, fill=(255, 255, 0))
    img.save(output_path)
    return output_path
