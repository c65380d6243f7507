"""Structured metrics logging: JSONL always, wandb when asked for and
installed (the port's copy of ``rgie_tpu/utils/logging.py``).

Reference: stdout prints and optional wandb
(``src/clf/train_guidance_clf.py:183-187,277-307,417-423``). Every run writes
machine-readable JSONL next to its outputs; wandb is an optional mirror.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, log_dir: str, run_name: str = "run", use_wandb: bool = False,
                 wandb_project: str = "rgie_tpu", config: Optional[Dict[str, Any]] = None):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.path = self.log_dir / f"{run_name}.jsonl"
        self._fh = open(self.path, "a")
        self._start = time.time()
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                wandb.init(project=wandb_project, name=run_name, config=config or {})
                self._wandb = wandb
            except Exception as e:  # an optional mirror: JSONL goes on without it
                print(f"wandb unavailable ({e}); JSONL only")
        if config:
            self.log({"event": "config", **config}, step=0)

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        rec = {"t": round(time.time() - self._start, 3), **metrics}
        if step is not None:
            rec["step"] = step
        self._fh.write(json.dumps(rec, default=float) + "\n")
        self._fh.flush()
        if self._wandb is not None:
            try:
                self._wandb.log({k: v for k, v in metrics.items()
                                 if isinstance(v, (int, float))}, step=step)
            except Exception as e:  # the mirror must not stop the run
                print(f"wandb log failed ({e})")

    def close(self) -> None:
        self._fh.close()
        if self._wandb is not None:
            try:
                self._wandb.finish()
            except Exception as e:  # the mirror must not stop the run
                print(f"wandb finish failed ({e})")

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
