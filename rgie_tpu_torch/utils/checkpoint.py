"""Reading torch checkpoint files for the port's modules."""

from __future__ import annotations

from typing import Dict

import torch


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torch checkpoint file as a flat ``{name: tensor}`` dict on the CPU; a
    ``{"state_dict": ...}`` wrapper is unwrapped and non-tensor entries are
    dropped."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v.detach() for k, v in obj.items() if isinstance(v, torch.Tensor)}
