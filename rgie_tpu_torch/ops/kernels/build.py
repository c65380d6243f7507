"""Build the port's CUDA C++ kernels with ``nvcc`` and load them with
``ctypes``.

Each source under ``rgie_tpu_torch/csrc/`` has a plain C interface and no
PyTorch headers, so it compiles in seconds into its own shared library under
``build/kernels/`` (an ignored directory of the checkout) the first time a
kernel is launched. A library is rebuilt when its source or the shared header
is newer. Nothing is built or loaded when a module is imported.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List

_REPO_ROOT = Path(__file__).resolve().parents[3]
CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = _REPO_ROOT / "build" / "kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC"]

_LIBRARIES: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    candidates = [shutil.which("nvcc"),
                  os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")]
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found (looked on PATH and under $CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels are built from source at first use")


def _stale(lib: Path, sources: Iterable[Path]) -> bool:
    return not lib.exists() or any(s.stat().st_mtime > lib.stat().st_mtime for s in sources)


def build_libraries(names: Iterable[str], verbose: bool = False) -> List[Path]:
    """Compile ``csrc/<name>.cu`` -> ``build/kernels/lib<name>.so`` for every
    stale name, all ``nvcc`` processes started together. With ``verbose`` the
    compiler's resource report (``-Xptxas -v``) is printed."""
    headers = sorted(CSRC_DIR.glob("*.cuh"))
    jobs, libs = [], []
    for name in names:
        src, lib = CSRC_DIR / f"{name}.cu", BUILD_DIR / f"lib{name}.so"
        libs.append(lib)
        if not _stale(lib, [src, *headers]):
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(src)]
        jobs.append((name, tmp, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for name, tmp, lib, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{out}")
            continue
        if verbose:
            print(out)
        os.replace(tmp, lib)
    if failures:
        raise RuntimeError("\n".join(failures))
    return libs


def load_library(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built if needed."""
    if name not in _LIBRARIES:
        (lib,) = build_libraries([name])
        _LIBRARIES[name] = ctypes.CDLL(str(lib))
    return _LIBRARIES[name]
