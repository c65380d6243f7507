"""Keyed backing stores for imaginaire-style datasets: folder and LMDB (the
port's copy of ``rgie_tpu/data/stores.py``).

Re-implements the loader surface of imaginaire's ``utils/data.py:438-482``
(``load_from_lmdb`` / ``load_from_folder``): each takes ``keys``, a dict
mapping data_type -> path(s), and per-data-type store handles, and returns a
dict of data_type -> list of decoded items. The handle API follows the
loader's call sites: ``getitem_by_path(key: bytes, data_type: str)``.

Images decode with PIL to HWC uint8 numpy; other data types come back as raw
bytes. ``load_from_object_store`` (an S3 reader) is not implemented. LMDB
needs the optional ``lmdb`` module, imported when an ``LmdbStore`` is made:
without it that raises ImportError and everything else works.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, List, Sequence, Union

import numpy as np

# data.py:20-23 (lowercase + uppercase variants collapse under .lower()).
IMG_EXTENSIONS = ("jpg", "jpeg", "png", "ppm", "bmp",
                  "pgm", "tif", "tiff", "webp")


def _is_image_key(key: str) -> bool:
    ext = key.rsplit(".", 1)[-1].lower()
    return ext in IMG_EXTENSIONS


def _decode(raw: bytes, key: str, data_type: str) -> Union[np.ndarray, bytes]:
    """Images -> HWC uint8 RGB numpy; everything else -> raw bytes."""
    if _is_image_key(key):
        import io

        from PIL import Image

        img = Image.open(io.BytesIO(raw))
        if img.mode != "RGB":
            img = img.convert("RGB")
        return np.asarray(img, dtype=np.uint8)
    return raw


class FolderStore:
    """Directory-backed store: keys are paths relative to ``root``."""

    def __init__(self, root: str):
        self.root = Path(root)
        if not self.root.is_dir():
            raise FileNotFoundError(f"FolderStore root is not a dir: {root}")

    def keys(self) -> List[str]:
        """All file keys under the root, sorted, '/'-separated."""
        out = []
        for dirpath, _, files in os.walk(self.root):
            rel = os.path.relpath(dirpath, self.root)
            for f in files:
                out.append(f if rel == "." else f"{rel}/{f}".replace(os.sep, "/"))
        return sorted(out)

    def getitem_by_path(self, key: bytes, data_type: str):
        k = key.decode() if isinstance(key, bytes) else key
        with open(self.root / k, "rb") as f:
            raw = f.read()
        return _decode(raw, k, data_type)


class LmdbStore:
    """LMDB-backed store (optional ``lmdb`` module; read-only env)."""

    def __init__(self, path: str):
        try:
            import lmdb
        except ImportError as exc:
            raise ImportError("LmdbStore requires the optional 'lmdb' package; "
                              "use FolderStore or install lmdb") from exc
        self._env = lmdb.open(path, readonly=True, lock=False,
                              readahead=False, meminit=False)

    def getitem_by_path(self, key: bytes, data_type: str):
        k = key if isinstance(key, bytes) else key.encode()
        with self._env.begin(write=False) as txn:
            raw = txn.get(k)
        if raw is None:
            raise KeyError(k)
        return _decode(bytes(raw), k.decode("utf-8", "replace"), data_type)


def _load(keys: Dict[str, Union[str, Sequence[str]]],
          handles: Dict[str, object]) -> Dict[str, list]:
    data: Dict[str, list] = {}
    for data_type, dt_keys in keys.items():
        if not isinstance(dt_keys, (list, tuple)):
            dt_keys = [dt_keys]
        data[data_type] = [
            handles[data_type].getitem_by_path(
                k.encode() if isinstance(k, str) else k, data_type)
            for k in dt_keys]
    return data


def load_from_folder(keys, handles) -> Dict[str, list]:
    """`data.py:463-482`: data_type -> list of decoded items."""
    return _load(keys, handles)


def load_from_lmdb(keys, lmdbs) -> Dict[str, list]:
    """`data.py:438-460`: data_type -> list of decoded items."""
    return _load(keys, lmdbs)
