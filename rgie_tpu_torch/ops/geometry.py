"""Differentiable geometric image ops (NHWC): bilinear warping, the separable
zoom of the chain's scale op, resize and crops.

Port of ``rgie_tpu/ops/geometry.py``. The TPU layout levers of that module
(``space_to_depth``, ``tencrop_offsets_even``, ``replicate_and_crop_s2d``)
have no counterpart here: they compute the same numbers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from rgie_tpu_torch.ops.numerics import absolute, maximum


def bilinear_sample(image: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                    padding_mode: str = "zeros") -> torch.Tensor:
    """Sample one HWC image at float pixel coords (x, y) of any shape.
    ``padding_mode`` is 'zeros' (out of bounds reads 0) or 'border'."""
    h, w = image.shape[0], image.shape[1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    x0i = x0.long()
    y0i = y0.long()

    def gather(yi, xi):
        vals = image[yi.clamp(0, h - 1), xi.clamp(0, w - 1)]  # (..., C)
        if padding_mode == "zeros":
            valid = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
            vals = torch.where(valid[..., None], vals, 0.0)
        return vals

    top = gather(y0i, x0i) * (1 - wx) + gather(y0i, x0i + 1) * wx
    bot = gather(y0i + 1, x0i) * (1 - wx) + gather(y0i + 1, x0i + 1) * wx
    return top * (1 - wy) + bot * wy


def warp_affine(image: torch.Tensor, matrix: torch.Tensor,
                padding_mode: str = "zeros") -> torch.Tensor:
    """Warp an NHWC batch by per-image (B, 2, 3) matrices mapping source to
    destination pixels (kornia/OpenCV convention); sampling inverts them."""
    h, w = image.shape[1], image.shape[2]
    ys = torch.arange(h, dtype=image.dtype, device=image.device)
    xs = torch.arange(w, dtype=image.dtype, device=image.device)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    out = []
    for img, m in zip(image, matrix):
        a, t = m[:, :2], m[:, 2]
        det = a[0, 0] * a[1, 1] - a[0, 1] * a[1, 0]
        det = torch.where(torch.abs(det) < 1e-12, 1e-12, det)
        dx = xx - t[0]
        dy = yy - t[1]
        sx = (a[1, 1] * dx - a[0, 1] * dy) / det
        sy = (-a[1, 0] * dx + a[0, 0] * dy) / det
        out.append(bilinear_sample(img, sx, sy, padding_mode))
    return torch.stack(out)


def _axis_interp_matrix(src_coords: torch.Tensor, src_len: int) -> torch.Tensor:
    """Bilinear interpolation matrix M (..., out_len, src_len) with zeros
    padding: M[i, j] = max(0, 1 - |src[i] - j|), with JAX's subgradients at
    the tie and the kink (see ops.numerics)."""
    taps = torch.arange(src_len, dtype=src_coords.dtype, device=src_coords.device)
    return maximum(1.0 - absolute(src_coords[..., :, None] - taps), 0.0)


def scale_about_center(image: torch.Tensor, scale_xy: torch.Tensor,
                       center_xy: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Zoom an NHWC batch by per-image (sx, sy) about (cx, cy) pixel centers
    (kornia.geometry.transform.scale, zeros padding): the sampled source
    coordinate is c + (dst - c) / s.

    Kept in the JAX package's separable form, two interpolation-matrix
    products, so that values and tie subgradients follow it."""
    b, h, w, _ = image.shape
    if center_xy is None:
        center_xy = image.new_tensor([(w - 1) / 2.0, (h - 1) / 2.0]).expand(b, 2)
    sx = torch.where(torch.abs(scale_xy[:, 0]) < 1e-12, 1e-12, scale_xy[:, 0])
    sy = torch.where(torch.abs(scale_xy[:, 1]) < 1e-12, 1e-12, scale_xy[:, 1])
    cx, cy = center_xy[:, 0:1], center_xy[:, 1:2]
    ys = torch.arange(h, dtype=image.dtype, device=image.device)
    xs = torch.arange(w, dtype=image.dtype, device=image.device)
    row_m = _axis_interp_matrix(cy + (ys - cy) / sy[:, None], h)   # (B, H, H)
    col_m = _axis_interp_matrix(cx + (xs - cx) / sx[:, None], w)   # (B, W, W)
    tmp = torch.einsum("boi,biwc->bowc", row_m, image)
    return torch.einsum("bpj,bojc->bopc", col_m, tmp)


# ---------------------------------------------------------------------------
# Preprocessing: resize / crops (torchvision-transform equivalents)
# ---------------------------------------------------------------------------


def resize(image: torch.Tensor, size: Tuple[int, int], antialias: bool = True) -> torch.Tensor:
    """Bilinear resize of an NHWC batch (or HWC image) to (H, W), half-pixel
    centers (``jax.image.resize(method="linear")``)."""
    batched = image.ndim == 4
    x = image if batched else image[None]
    # An NHWC tensor permuted to NCHW is a channels_last tensor; interpolate
    # keeps that layout, so the permute back is contiguous again.
    x = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size), mode="bilinear",
                      align_corners=False, antialias=antialias).permute(0, 2, 3, 1)
    return x if batched else x[0]


def resize_shorter_side(image: torch.Tensor, size: int, antialias: bool = True) -> torch.Tensor:
    """torchvision.transforms.Resize(int): scale so the shorter side == size."""
    h, w = (image.shape[1], image.shape[2]) if image.ndim == 4 else (image.shape[0], image.shape[1])
    if h <= w:
        new_h, new_w = size, max(1, round(w * size / h))
    else:
        new_h, new_w = max(1, round(h * size / w)), size
    return resize(image, (new_h, new_w), antialias=antialias)


def center_crop(image: torch.Tensor, crop: int) -> torch.Tensor:
    """torchvision.transforms.CenterCrop(crop) for NHWC/HWC, crop <= H, W."""
    h, w = (image.shape[1], image.shape[2]) if image.ndim == 4 else (image.shape[0], image.shape[1])
    top = (h - crop) // 2
    left = (w - crop) // 2
    return image[..., top:top + crop, left:left + crop, :]


def ten_crop_offsets(h: int, w: int, crop: int) -> Tuple[Tuple[int, int], ...]:
    """The JAX package's deterministic 10-crop grid (4 corners, center, 4 edge
    midpoints, one interior point), replacing the reference's seed-dependent
    RandomCrop x10 (ReplicateAndCrop.py:23)."""
    my, mx = h - crop, w - crop
    return (
        (0, 0), (0, mx), (my, 0), (my, mx),
        (my // 2, mx // 2),
        (0, mx // 2), (my // 2, 0), (my, mx // 2), (my // 2, mx),
        (my // 4, 3 * mx // 4),
    )


def replicate_and_crop(image: torch.Tensor, crop: int, num_replications: int = 10,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(B, H, W, C) -> (B * N, crop, crop, C) in (image, replica) order
    (ReplicateAndCrop.py:40-43). Without ``generator`` the crops are the
    deterministic grid; with one, N random offsets shared by the batch."""
    b, h, w, c = image.shape
    if generator is None:
        offsets = ten_crop_offsets(h, w, crop)[:num_replications]
    else:
        tops = torch.randint(0, h - crop + 1, (num_replications,), generator=generator)
        lefts = torch.randint(0, w - crop + 1, (num_replications,), generator=generator)
        offsets = list(zip(tops.tolist(), lefts.tolist()))
    crops = [image[:, t:t + crop, l:l + crop, :] for (t, l) in offsets]
    return torch.stack(crops, dim=1).reshape(b * len(offsets), crop, crop, c)


def mean_replicated(x: torch.Tensor, num_replications: int = 10) -> torch.Tensor:
    """Average model outputs over replicas: (B*N, D) -> (B, D)."""
    b = x.shape[0] // num_replications
    return x.reshape(b, num_replications, *x.shape[1:]).mean(dim=1)
