"""What every kind of cell shares: finding a cell's files by name, the
import guard, the seeded weights, the chip's peaks and the device record."""

from __future__ import annotations

import json
import math
import sys
import zlib
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: Published dense peaks of one H100 SXM (NVIDIA's data sheet, 700 W).
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
#: ... and its float32 peak on the CUDA cores, without tensor cores.
PEAK_FP32_FLOPS = 67e12

#: Top-level module names that may never be loaded in a run's process.
FORBIDDEN = ("jax", "jaxlib", "flax", "rgie_tpu")
#: ... nor in the reference's own imports, besides those.
FORBIDDEN_IN_REFERENCE = FORBIDDEN + ("rgie_tpu_torch",)


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(workload: str) -> Tuple[dict, dict, dict]:
    """The cell ``workloads/<workload>.json`` and the configuration and
    traffic mix it names, each found by its name."""
    cell = read_json(HERE / "workloads" / f"{workload}.json")
    config = read_json(HERE / "configs" / f"{cell['config']}.json")
    traffic = read_json(HERE / "traffic" / f"{cell['traffic']}.json")
    return cell, config, traffic


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read(ctx)``."""
    import importlib.util

    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules(names: Iterable[str], forbidden: Iterable[str] = FORBIDDEN) -> List[str]:
    """The names among ``names`` whose top-level part, compared whole, is
    one of ``forbidden``."""
    banned = set(forbidden)
    return sorted(n for n in names if n.split(".")[0] in banned)


def check_imports(where: str) -> None:
    """Exit with an error if this process has loaded JAX, Flax or the JAX
    package."""
    found = forbidden_modules(sys.modules)
    if found:
        sys.stderr.write(f"forbidden modules loaded {where}: {', '.join(found[:20])}\n")
        raise SystemExit(3)


def derive_seed(seed: int, salt: str) -> int:
    """One generator seed per (run seed, purpose), for seeds of any size."""
    return (int(seed) * 1000003 + zlib.crc32(salt.encode())) % (2 ** 63)


#: Normal draws per generator call when the weights are made.
DRAW_CHUNK = 1 << 28


def fill_weights_(module, seed: int, salt: str) -> None:
    """Every parameter of ``module``, in the order of its sorted names:
    matrices and kernels N(0, 1/fan_in) (LeCun normal, fan_in the product of
    all dims but the first), biases 0, other vectors (norm scales) 1. The
    normal draws come from one generator on the module's device, a chunk of
    up to ``DRAW_CHUNK`` values per call, so the same (seed, salt) gives the
    same weights to any module with the same names and shapes."""
    import torch

    params = sorted(module.named_parameters(), key=lambda kv: kv[0])
    device = params[0][1].device
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, salt))
    chunks: List[List] = [[]]
    size = 0
    for _, p in params:
        if p.ndim >= 2:
            if chunks[-1] and size + p.numel() > DRAW_CHUNK:
                chunks.append([])
                size = 0
            chunks[-1].append(p)
            size += p.numel()
    with torch.no_grad():
        for n, p in params:
            if p.ndim < 2:
                p.fill_(0.0 if n.endswith("bias") else 1.0)
        for chunk in chunks:
            draws = torch.randn(sum(p.numel() for p in chunk), generator=gen, device=device,
                                dtype=torch.float32)
            offset = 0
            for p in chunk:
                k = p.numel()
                p.copy_(draws[offset:offset + k].view(p.shape) / math.sqrt(math.prod(p.shape[1:])))
                offset += k
            del draws


def plain_unet_config(cfg: dict) -> dict:
    """The configuration file's ``unet`` with diffusers' defaults filled in:
    one transformer layer per block where the file names none, and SDXL's
    pooled text width (the added projection's input less six time ids)."""
    u = dict(cfg["unet"])
    u.setdefault("transformer_layers_per_block", [1] * len(u["block_out_channels"]))
    if u.get("addition_embed_type") == "text_time":
        u["addition_pooled_dim"] = (u["projection_class_embeddings_input_dim"]
                                    - 6 * u["addition_time_embed_dim"])
    return u


def device_record(count: int = 1) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count}


def relative_gap(a, b) -> float:
    """||a - b|| / ||b|| in float64."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp(min=1e-300))


def rows_gap(program, reference) -> float:
    """The largest ``relative_gap`` over the rows (the leading axis)."""
    return max(relative_gap(p, r) for p, r in zip(program, reference))


def medianf(values: List[float]) -> float:
    v = sorted(values)
    n = len(v)
    return v[n // 2] if n % 2 else 0.5 * (v[n // 2 - 1] + v[n // 2])


def leaf_norm_gap(program: Dict[str, object], reference: Dict[str, object],
                  include: Optional[Iterable[str]] = None) -> float:
    """The worst leaf's gap of norms: | ||p|| - ||r|| | over the larger of
    the reference leaf's norm and the median reference leaf norm."""
    names = list(include) if include is not None else list(reference)
    norms = {n: float(reference[n].double().norm()) for n in reference}
    floor = medianf(list(norms.values()))
    worst = 0.0
    for n in names:
        gap = abs(float(program[n].double().norm()) - norms[n])
        worst = max(worst, gap / max(norms[n], floor, 1e-300))
    return worst
