"""Torch checkpoint files for the port's modules: reading plain state dicts,
and imaginaire's MUNIT checkpoint with its spectral norms folded into the
kernels (the port's own copies of ``realize_spectral_norm`` and
``filter_imaginaire_states`` of ``rgie_tpu/utils/torch_convert.py``);
writing the best midu of a training run (``BestCheckpointer``); saving and
restoring a state tree with its step, and the resume manifest of a dataset
edit run (``EditManifest``), after ``rgie_tpu/utils/checkpoint.py``."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Set

import torch
import torch.nn as nn


#: The file a ``save_checkpoint`` directory holds.
STATE_FILE = "state.pt"


def save_checkpoint(path: str, tree: Any, step: Optional[int] = None) -> str:
    """``torch.save`` of a state tree (nested dicts, lists and tensors: a
    ``state_dict``, an optimizer's, ...) with its step, into the directory
    ``path`` (``path/step_<step>`` when a step is given, as the JAX package's
    orbax checkpoints are laid out). Returns the directory."""
    path = Path(path).absolute()
    if step is not None:
        path = path / f"step_{step}"
    path.mkdir(parents=True, exist_ok=True)
    torch.save({"tree": tree, "step": step}, path / STATE_FILE)
    return str(path)


def load_checkpoint(path: str, target: Optional[Any] = None) -> Any:
    """The tree ``save_checkpoint`` wrote to ``path``, on the CPU; with a
    ``target`` (a module or an optimizer), loaded into it with
    ``load_state_dict`` and the target returned."""
    tree = torch.load(Path(path).absolute() / STATE_FILE, map_location="cpu",
                      weights_only=True)["tree"]
    if target is None:
        return tree
    target.load_state_dict(tree)
    return target


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torch checkpoint file as a flat ``{name: tensor}`` dict on the CPU; a
    ``{"state_dict": ...}`` wrapper is unwrapped and non-tensor entries are
    dropped."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v.detach() for k, v in obj.items() if isinstance(v, torch.Tensor)}


def realize_spectral_norm(weight_orig: torch.Tensor, u: torch.Tensor,
                          v: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fold torch's spectral norm into the kernel: W / sigma, sigma = u^T W v
    from the STORED power-iteration vectors, as torch computes it at eval
    (rgie_tpu/utils/torch_convert.py:39-58). Without a stored v, v =
    normalize(W^T u)."""
    w = weight_orig.detach().float()
    w_mat = w.reshape(w.shape[0], -1)
    u = u.detach().float().reshape(-1)
    if v is None:
        v = w_mat.T @ u
        v = v / (torch.linalg.vector_norm(v) + 1e-12)
    else:
        v = v.detach().float().reshape(-1)
    return w / torch.dot(u, w_mat @ v)


def filter_imaginaire_states(state_dict: Mapping[str, torch.Tensor],
                             use_averaged_model: bool = False) -> Dict[str, torch.Tensor]:
    """Strip 'module.' prefixes and keep the (non-)averaged model's keys
    (get_relevant_states, optimize_image_imaginaire.py:148-159)."""
    if use_averaged_model:
        out = {k.replace("module.", ""): v for k, v in state_dict.items()
               if "averaged_model" in k}
        out = {k.replace("averaged_model.", ""): v for k, v in out.items()}
    else:
        out = {k.replace("module.", ""): v for k, v in state_dict.items()
               if "averaged_model" not in k}
    out.pop("num_updates_tracked", None)
    return out


def fold_spectral_norms(state_dict: Mapping[str, torch.Tensor], prefix: str
                        ) -> Dict[str, torch.Tensor]:
    """The entries under ``prefix`` (stripped), with every spectral-normed
    ``weight_orig`` / ``weight_u`` / ``weight_v`` triple replaced by the
    realized ``weight``."""
    sd = {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}
    out = {}
    for k, v in sd.items():
        if k.endswith(".weight_orig"):
            base = k[:-len("_orig")]
            out[base] = realize_spectral_norm(v, sd[f"{base}_u"], sd.get(f"{base}_v"))
        elif not k.endswith((".weight_u", ".weight_v")):
            out[k] = v.detach()
    return out


def load_munit_checkpoint(path: str, cfg, weight_dis: float = 0.0):
    """imaginaire ``imaginaire_munit_200000_s5.pt`` -> (the domain-a
    ``AutoEncoder`` of ``net_G``, frozen, float32, on the CPU; and, when
    ``weight_dis > 0`` and the checkpoint has ``net_D``, its
    ``discriminator_a`` as a ``MultiResPatchDiscriminator``, else None).
    Spectral norms are folded into the kernels and both load with
    ``strict=True`` (scripts/optimize_image_imaginaire.py:77-103). ``cfg`` is
    the ``MunitGenConfig``; the discriminator has ``MunitDisConfig``'s
    shipped widths and as many scales as the checkpoint holds."""
    from rgie_tpu_torch.config import MunitDisConfig
    from rgie_tpu_torch.models.discriminators import MultiResPatchDiscriminator
    from rgie_tpu_torch.models.init import freeze_
    from rgie_tpu_torch.models.munit import AutoEncoder

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    gen = AutoEncoder(cfg)
    gen.load_state_dict(fold_spectral_norms(filter_imaginaire_states(ckpt["net_G"]),
                                            "autoencoder_a."), strict=True)
    dis = None
    if weight_dis > 0 and "net_D" in ckpt:
        dis_sd = fold_spectral_norms(filter_imaginaire_states(ckpt["net_D"]), "discriminator_a.")
        num_dis = len({k.split(".")[1] for k in dis_sd if k.startswith("discriminators.")})
        dis_cfg = MunitDisConfig()
        dis = MultiResPatchDiscriminator(num_dis, dis_cfg.num_filters, dis_cfg.num_layers,
                                         dis_cfg.max_num_filters)
        dis.load_state_dict(dis_sd, strict=True)
        dis = freeze_(dis)
    return freeze_(gen), dis


class BestCheckpointer:
    """Best-validation-loss checkpointing (the reference's gate,
    train_guidance_clf.py:296-318). The JAX package writes an orbax tree; the
    port writes, as the reference does, the model's ``state_dict`` with
    ``torch.save`` (``best.pt``, the midu under the reference's keys: convs
    at 0, 3, ...), which ``load_torch_state_dict`` and the diffusion CLI's
    ``--midu-ckpt`` read back with ``strict=True``."""

    def __init__(self, directory: str):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.best_loss = float("inf")
        self.best_path: Optional[str] = None

    def maybe_save(self, val_loss: float, model: nn.Module, step: int) -> bool:
        if val_loss < self.best_loss:
            self.best_loss = val_loss
            path = self.directory / "best.pt"
            torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, path)
            self.best_path = str(path)
            with open(self.directory / "best_meta.json", "w") as f:
                json.dump({"val_loss": val_loss, "step": step}, f)
            return True
        return False


class EditManifest:
    """Idempotent record of completed (image, adaptation) edits, JSON lines on
    disk, so a dataset run that stopped resumes where it stopped. The lines
    are the JAX package's (``{"key": "<image>::<adaptation>", ...extra}``):
    either package reads the other's."""

    def __init__(self, path: str):
        self.path = Path(path)
        self.done: Set[str] = set()
        if self.path.exists():
            with open(self.path) as f:
                for line in f:
                    try:
                        self.done.add(json.loads(line)["key"])
                    except (json.JSONDecodeError, KeyError, TypeError):
                        continue    # a line cut short by the stop
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a")

    @staticmethod
    def key(image_name: str, adaptation: str) -> str:
        return f"{image_name}::{adaptation}"

    def is_done(self, image_name: str, adaptation: str) -> bool:
        return self.key(image_name, adaptation) in self.done

    def mark(self, image_name: str, adaptation: str, **extra) -> None:
        k = self.key(image_name, adaptation)
        self.done.add(k)
        self._fh.write(json.dumps({"key": k, **extra}) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()
