"""Bench provenance log: every bench row of the port, appended to one JSONL
file with a timestamp and the git SHA (port of
``rgie_tpu/utils/bench_history.py``).

The port's benches (``cli/bench.py``, ``cli/bench_gan.py``,
``cli/bench_diffusion.py``) append to their own
``artifacts/bench_history_torch.jsonl``, never to the JAX package's
``artifacts/bench_history.jsonl``, so a number can be audited against the
raw run that produced it. The row already names its device, power limit
and torch and CUDA versions.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Optional

from rgie_tpu_torch.config import ARTIFACTS_DIR, PROJECT_ROOT

HISTORY_PATH = ARTIFACTS_DIR / "bench_history_torch.jsonl"


def _git_sha() -> Optional[str]:
    try:
        out = subprocess.run(["git", "rev-parse", "--short", "HEAD"], capture_output=True,
                             text=True, cwd=PROJECT_ROOT, timeout=10).stdout.strip()
        return out or None
    except (OSError, subprocess.SubprocessError):
        return None


def rgie_env() -> dict:
    """All RGIE_* environment variables of this process (levers such as
    ``RGIE_FLASH_ATTN`` change the numbers, so the row carries them)."""
    return {k: v for k, v in sorted(os.environ.items()) if k.startswith("RGIE_")}


def record(bench: str, row: dict, path: Optional[str] = None) -> None:
    """Append one measurement row under ``bench`` provenance to ``path``
    (default ``HISTORY_PATH``); the row's ``detail`` gains ``rgie_env``.
    Never raises: a provenance write that fails must not fail the bench."""
    detail = dict(row.get("detail") or {})
    detail.setdefault("rgie_env", rgie_env())
    entry = {"ts": time.strftime("%Y-%m-%dT%H:%M:%S%z"), "git_sha": _git_sha(), "bench": bench,
             **row, "detail": detail}
    path = str(HISTORY_PATH if path is None else path)
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps(entry) + "\n")
    except OSError as exc:
        print(f"bench_history: could not append: {exc!r}", file=sys.stderr)
