"""Low-level image metrics (host-side numpy): the port's own copy of
``rgie_tpu/analysis/low_level_metrics.py``, equal to it below this docstring.

Reference: ``src/analysis/low_level_image_metrics.py``: colorfulness
(Hasler-Süsstrunk on LAB a*/b*), mean brightness (GANalyze), mean
saturation, RMS contrast (Peli), lighting diversity (L-channel std), and the
Crete et al. perceptual blur metric (the algorithm of
skimage.measure.blur_effect, which is not a dependency).
"""

from __future__ import annotations

from typing import Union

import numpy as np

ImageLike = Union[str, np.ndarray]


def _load_rgb(image: ImageLike) -> np.ndarray:
    if isinstance(image, np.ndarray):
        arr = image
        if arr.dtype != np.uint8:
            arr = np.clip(arr * 255.0, 0, 255).astype(np.uint8)
        return arr
    from PIL import Image

    img = Image.open(image)
    if img.mode != "RGB":
        img = img.convert("RGB")
    return np.asarray(img)


def _to_lab(rgb: np.ndarray) -> np.ndarray:
    """RGB(uint8) -> LAB with OpenCV's 8-bit scaling (L*255/100, a+128,
    b+128), implemented in numpy: importing cv2 into a JAX process deadlocks
    XLA's compile threads on single-core hosts, so cv2 stays out of the
    library (the reference itself pins cv2 threads to zero —
    external/imaginaire/utils/data.py:17)."""
    srgb = rgb.astype(np.float64) / 255.0
    # sRGB -> linear
    lin = np.where(srgb <= 0.04045, srgb / 12.92, ((srgb + 0.055) / 1.055) ** 2.4)
    r, g, b = lin[..., 0], lin[..., 1], lin[..., 2]
    # linear RGB -> XYZ (D65)
    x = 0.412453 * r + 0.357580 * g + 0.180423 * b
    y = 0.212671 * r + 0.715160 * g + 0.072169 * b
    z = 0.019334 * r + 0.119193 * g + 0.950227 * b
    # normalize by white point
    x /= 0.950456
    z /= 1.088754
    delta = 6.0 / 29.0

    def f(t):
        return np.where(t > delta ** 3, np.cbrt(t), t / (3 * delta ** 2) + 4.0 / 29.0)

    fx, fy, fz = f(x), f(y), f(z)
    l = 116.0 * fy - 16.0
    a = 500.0 * (fx - fy)
    bb = 200.0 * (fy - fz)
    lab = np.stack([l * 255.0 / 100.0, a + 128.0, bb + 128.0], axis=-1)
    return np.clip(np.round(lab), 0, 255).astype(np.uint8)


def calculate_colorfulness(image: ImageLike) -> float:
    """Hasler-Süsstrunk colorfulness on LAB a*/b*
    (low_level_image_metrics.py:7-33)."""
    lab = _to_lab(_load_rgb(image)).astype(np.float64)
    a, b = lab[..., 1], lab[..., 2]
    a_diff = a - a.mean()
    b_diff = b - b.mean()
    color_diff = np.sqrt(a_diff ** 2 + b_diff ** 2)
    return float(color_diff.std() + 0.3 * color_diff.mean())


def compute_mean_brightness(image: ImageLike) -> float:
    """Mean grayscale value (low_level_image_metrics.py:36-52).
    PIL 'L' = ITU-R 601 luma."""
    rgb = _load_rgb(image).astype(np.float64)
    gray = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    return float(gray.mean())


def compute_mean_saturation(image: ImageLike) -> float:
    """Mean of the HSV S channel, 0-255 scale (low_level_image_metrics.py:55-63)."""
    rgb = _load_rgb(image).astype(np.float64) / 255.0
    cmax = rgb.max(-1)
    cmin = rgb.min(-1)
    s = np.where(cmax == 0, 0.0, (cmax - cmin) / np.maximum(cmax, 1e-12))
    return float((s * 255.0).mean())


def compute_rms_contrast(image: ImageLike) -> float:
    """Std of the grayscale image (Peli; low_level_image_metrics.py:66-74)."""
    rgb = _load_rgb(image).astype(np.float64)
    gray = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    return float(gray.std())


def compute_lighting_diversity(image: ImageLike) -> float:
    """Std of the LAB L channel (low_level_image_metrics.py:77-83)."""
    lab = _to_lab(_load_rgb(image)).astype(np.float64)
    return float(lab[..., 0].std())


def compute_blur_effect(image: ImageLike, h_size: int = 11) -> float:
    """Crete et al. no-reference perceptual blur metric, the algorithm of
    skimage.measure.blur_effect (low_level_image_metrics.py:86-101):
    blur with a h_size box filter along each axis, compare the loss of
    neighbor-difference energy; metric = max over axes, in [0, 1]."""
    rgb = _load_rgb(image).astype(np.float64)
    gray = (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]) / 255.0

    def axis_blur_metric(im: np.ndarray, axis: int) -> float:
        # 1-D box blur along `axis` (reflect border, like scipy uniform_filter1d default 'reflect')
        k = np.ones(h_size) / h_size
        pad = h_size // 2
        padded = np.pad(im, [(pad, pad) if ax == axis else (0, 0) for ax in range(2)],
                        mode="reflect")
        blurred = np.apply_along_axis(lambda m: np.convolve(m, k, mode="valid"),
                                      axis, padded)
        d_im = np.abs(np.diff(im, axis=axis))
        d_bl = np.abs(np.diff(blurred, axis=axis))
        t = np.maximum(0.0, d_im - d_bl)
        s_im = d_im.sum()
        s_t = t.sum()
        return float((s_im - s_t) / s_im) if s_im > 0 else 0.0

    return float(max(axis_blur_metric(gray, 0), axis_blur_metric(gray, 1)))


ALL_METRICS = {
    "colorfulness": calculate_colorfulness,
    "brightness": compute_mean_brightness,
    "saturation": compute_mean_saturation,
    "rms_contrast": compute_rms_contrast,
    "lighting_diversity": compute_lighting_diversity,
    "blur": compute_blur_effect,
}


def compute_all(image: ImageLike) -> dict:
    return {name: fn(image) for name, fn in ALL_METRICS.items()}
