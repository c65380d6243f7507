"""ctypes binding to the native C++ preprocessing library
``native/librgie_preprocess.so`` (the port's copy of
``rgie_tpu/data/native_preprocess.py``).

Built with ``make -C native`` at first use when the library is missing;
when it cannot be built or loaded, ``preprocess_batch`` takes the pure-PIL
path (``data.dataset.preprocess_image``), as the JAX package does. The C++
path does the shorter-side bilinear resize, center crop and optional
normalize in a pthread pool without the GIL: host work, not a device kernel.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
from typing import Optional, Sequence

import numpy as np

from rgie_tpu_torch.config import PROJECT_ROOT

NATIVE_DIR = PROJECT_ROOT / "native"


@functools.lru_cache(maxsize=None)
def _load() -> Optional[ctypes.CDLL]:
    so = NATIVE_DIR / "librgie_preprocess.so"
    try:
        if not so.exists():
            subprocess.run(["make", "-C", str(NATIVE_DIR)], check=True, capture_output=True)
        lib = ctypes.CDLL(str(so))
    except (OSError, subprocess.CalledProcessError):
        return None
    lib.rgie_preprocess_batch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
    ]
    lib.rgie_preprocess_batch.restype = None
    return lib


def native_available() -> bool:
    return _load() is not None


def preprocess_batch(images: Sequence[np.ndarray], resize_shorter: int, crop: int,
                     normalize: bool = False, num_threads: Optional[int] = None) -> np.ndarray:
    """HWC uint8 (or [0, 1] float) RGB arrays -> (N, crop, crop, 3) float32,
    through the C++ pool when it loads, else the PIL path."""
    lib = _load()
    if lib is None:
        from rgie_tpu_torch.data.dataset import preprocess_image

        return np.concatenate([
            preprocess_image(img.astype(np.float32) / 255.0 if img.dtype == np.uint8 else img,
                             resize_shorter, crop, normalize) for img in images])
    n = len(images)
    u8 = [np.ascontiguousarray(img if img.dtype == np.uint8
                               else np.clip(img * 255, 0, 255).astype(np.uint8))
          for img in images]
    for img in u8:
        if img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"expected HWC RGB images, got shape {img.shape}")
    srcs = (ctypes.c_void_p * n)(*[im.ctypes.data for im in u8])
    hs = (ctypes.c_int * n)(*[im.shape[0] for im in u8])
    ws = (ctypes.c_int * n)(*[im.shape[1] for im in u8])
    out = np.empty((n, crop, crop, 3), dtype=np.float32)
    threads = num_threads or min(8, os.cpu_count() or 1)
    lib.rgie_preprocess_batch(srcs, hs, ws, n, resize_shorter, crop, int(normalize),
                              out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), threads)
    return out
