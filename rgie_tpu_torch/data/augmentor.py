"""Config-driven training-time augmentation, the imaginaire Augmentor's
surface (``src/external/imaginaire/utils/data.py:93-176``) on numpy and PIL:
the port's copy of ``rgie_tpu/data/augmentor.py``.

aug_list keys, with the semantics of the albumentations ops the reference
builds: resize_smallest_side, resize_h_w, random_resize_h_w_aspect, rotate,
random_rotate_90, random_scale_limit, random_crop_h_w, center_crop_h_w,
horizontal_flip, contrast (RandomBrightnessContrast), blur (box Blur),
motion_blur, compression (JPEG), gamma (RandomGamma).

Host-side preprocessing, images float32 [0, 1] HWC.
"""

from __future__ import annotations

import io
from typing import Dict, Optional, Tuple

import numpy as np


def _to_pil(image: np.ndarray):
    from PIL import Image

    return Image.fromarray((np.clip(image, 0.0, 1.0) * 255).astype(np.uint8))


def _from_pil(pil) -> np.ndarray:
    return np.asarray(pil, dtype=np.float32) / 255.0


def _resize(image: np.ndarray, h: int, w: int) -> np.ndarray:
    from PIL import Image

    return _from_pil(_to_pil(image).resize((w, h), Image.BILINEAR))


def _odd_ksize(rng: np.random.Generator, limit: int) -> int:
    """Odd kernel size in [3, limit] (albumentations samples odd only)."""
    return int(rng.choice(np.arange(3, max(limit, 3) + 1, 2)))


def _pad_to(image: np.ndarray, th: int, tw: int) -> np.ndarray:
    """Reflect-pad up to at least (th, tw) — the alb.PadIfNeeded the reference
    pairs with RandomCrop, so crops never silently shrink."""
    h, w = image.shape[:2]
    if h >= th and w >= tw:
        return image
    ph, pw = max(th - h, 0), max(tw - w, 0)
    pad = ((ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2)) + \
          ((0, 0),) * (image.ndim - 2)
    mode = "reflect" if min(h, w) > 1 else "edge"
    return np.pad(image, pad, mode=mode)


def _parse_hw(value) -> Tuple[int, int]:
    if isinstance(value, int):
        return value, value
    h, w = str(value).split(",")[:2]
    return int(h), int(w)


class Augmentor:
    """augment(image, rng) applies the configured op sequence in the
    reference's build order (aug_list iteration order)."""

    def __init__(self, aug_list: Optional[Dict] = None):
        self.aug_list = dict(aug_list or {})

    def __call__(self, image: np.ndarray,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
        rng = rng if rng is not None else np.random.default_rng()
        for key, value in self.aug_list.items():
            image = self._apply(key, value, image, rng)
        return np.ascontiguousarray(image.astype(np.float32))

    # -- individual ops ------------------------------------------------------

    def _apply(self, key: str, value, image: np.ndarray,
               rng: np.random.Generator) -> np.ndarray:
        h, w = image.shape[:2]
        if key == "resize_smallest_side":
            target = value if isinstance(value, int) else min(_parse_hw(value))
            scale = target / min(h, w)
            return _resize(image, max(1, round(h * scale)), max(1, round(w * scale)))
        if key == "resize_h_w":
            th, tw = _parse_hw(value)
            return _resize(image, th, tw)
        if key == "random_resize_h_w_aspect":
            # alb.RandomResizedCrop(h, w, scale=(1,1), ratio=(amin, amax)):
            # crop the full-area window at a random aspect, resize to (h, w).
            s = str(value)
            a0, a1 = s.find("("), s.find(")")
            amin, amax = (float(v) for v in s[a0 + 1:a1].split(","))
            th, tw = (int(v) for v in s[:a0].split(",")[:2])
            ratio = np.exp(rng.uniform(np.log(amin), np.log(amax)))
            cw = min(w, int(round(np.sqrt(h * w * ratio))))
            ch = min(h, int(round(np.sqrt(h * w / ratio))))
            top = int(rng.integers(0, h - ch + 1))
            left = int(rng.integers(0, w - cw + 1))
            return _resize(image[top:top + ch, left:left + cw], th, tw)
        if key == "rotate":
            from PIL import Image

            angle = float(rng.uniform(-value, value))
            return _from_pil(_to_pil(image).rotate(angle, Image.BILINEAR))
        if key == "random_rotate_90":
            if rng.random() < 0.5:
                return np.rot90(image, k=int(rng.integers(1, 4)))
            return image
        if key == "random_scale_limit":
            scale = 1.0 + float(rng.uniform(0.0, value))
            return _resize(image, max(1, round(h * scale)), max(1, round(w * scale)))
        if key == "random_crop_h_w":
            ch, cw = _parse_hw(value)
            image = _pad_to(image, ch, cw)
            h, w = image.shape[:2]
            top = int(rng.integers(0, h - ch + 1))
            left = int(rng.integers(0, w - cw + 1))
            return image[top:top + ch, left:left + cw]
        if key == "center_crop_h_w":
            ch, cw = _parse_hw(value)
            image = _pad_to(image, ch, cw)
            h, w = image.shape[:2]
            top, left = (h - ch) // 2, (w - cw) // 2
            return image[top:top + ch, left:left + cw]
        if key == "horizontal_flip":
            if value and rng.random() < 0.5:
                return image[:, ::-1]
            return image
        if key == "contrast":
            if rng.random() >= value.get("p", 0.5):
                return image
            bl = value.get("brightness_limit", 0.2)
            cl = value.get("contrast_limit", 0.2)
            alpha = 1.0 + float(rng.uniform(-cl, cl))
            beta = float(rng.uniform(-bl, bl))
            # albumentations RandomBrightnessContrast on float images:
            # img*alpha + beta (not mean-anchored).
            return np.clip(image * alpha + beta, 0.0, 1.0)
        if key == "blur":
            if rng.random() >= value.get("p", 0.5):
                return image
            return _box_blur(image, _odd_ksize(rng, value.get("blur_limit", 7)))
        if key == "motion_blur":
            if rng.random() >= value.get("p", 0.5):
                return image
            return _motion_blur(image, _odd_ksize(rng, value.get("blur_limit", 7)), rng)
        if key == "compression":
            if rng.random() >= value.get("p", 0.5):
                return image
            from PIL import Image

            q = int(rng.integers(value.get("quality_lower", 60), 101))
            buf = io.BytesIO()
            _to_pil(image).save(buf, format="JPEG", quality=q)
            buf.seek(0)
            return _from_pil(Image.open(buf).convert("RGB"))
        if key == "gamma":
            if rng.random() >= value.get("p", 0.5):
                return image
            lo = value.get("gamma_limit_lb", 80) / 100.0
            hi = value.get("gamma_limit_ub", 120) / 100.0
            gamma = float(rng.uniform(lo, hi))
            return np.clip(image, 0.0, 1.0) ** gamma
        if key == "max_time_step":  # video-only control knob; no image effect
            return image
        raise ValueError(f"Unknown augmentation {key}")


def _box_blur(image: np.ndarray, k: int) -> np.ndarray:
    pad = k // 2
    padded = np.pad(image, ((pad, pad), (pad, pad), (0, 0)), mode="edge")
    cs = np.cumsum(np.cumsum(np.pad(padded, ((1, 0), (1, 0), (0, 0))),
                             axis=0), axis=1)
    h, w = image.shape[:2]
    out = (cs[k:k + h, k:k + w] - cs[:h, k:k + w]
           - cs[k:k + h, :w] + cs[:h, :w]) / (k * k)
    return out.astype(np.float32)


def _motion_blur(image: np.ndarray, k: int, rng: np.random.Generator) -> np.ndarray:
    """Random-direction line kernel (albumentations MotionBlur semantics)."""
    kernel = np.zeros((k, k), np.float32)
    angle = rng.uniform(0, np.pi)
    c = (k - 1) / 2.0
    for t in np.linspace(-c, c, 2 * k):
        i = int(round(c + t * np.sin(angle)))
        j = int(round(c + t * np.cos(angle)))
        if 0 <= i < k and 0 <= j < k:
            kernel[i, j] = 1.0
    kernel /= kernel.sum()
    pad = k // 2
    padded = np.pad(image, ((pad, pad), (pad, pad), (0, 0)), mode="edge")
    h, w = image.shape[:2]
    windows = np.lib.stride_tricks.sliding_window_view(padded, (k, k), axis=(0, 1))
    return np.einsum("hwcij,ij->hwc", windows[:h, :w], kernel).astype(np.float32)
