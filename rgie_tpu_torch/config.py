"""Configuration dataclasses and paths of the port: its own copy of the parts
of ``rgie_tpu/config.py`` that the ported slices use, with every default
kept (``tests/test_torch_standalone.py`` compares them field by field).

Paths are overridable through the same environment variables as the JAX
package's (``RGIE_ARTIFACTS_DIR``, ``RGIE_MODELS_DIR``, ``RGIE_DATA_DIR``,
``RGIE_OUT_DIR``).
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Optional, Tuple

PROJECT_ROOT = Path(__file__).resolve().parent.parent
ARTIFACTS_DIR = Path(os.environ.get("RGIE_ARTIFACTS_DIR", PROJECT_ROOT / "artifacts"))
MODELS_DIR = Path(os.environ.get("RGIE_MODELS_DIR", ARTIFACTS_DIR / "models"))
DATA_DIR = Path(os.environ.get("RGIE_DATA_DIR", ARTIFACTS_DIR / "data"))
OUT_DIR = Path(os.environ.get("RGIE_OUT_DIR", ARTIFACTS_DIR / "out"))


@dataclasses.dataclass(frozen=True)
class OptimizeConfig:
    """Per-image Adam optimization settings (reference: src/baselines/optimize_image.py:56-97)."""

    num_steps: int = 300
    learning_rate: float = 0.05
    lr_rampup_length: float = 0.05
    lr_rampdown_length: float = 0.25
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8


@dataclasses.dataclass(frozen=True)
class ParamEditConfig:
    """Parametric pixel-space editing (reference: src/optimize_image_param.py:28-118)."""

    optimize: OptimizeConfig = dataclasses.field(default_factory=OptimizeConfig)
    weight_clf: float = 0.15
    weight_recon: float = 1.0
    weight_dis: float = 0.0
    input_size: int = 480
    crop_size: int = 480
    output_size: int = 1024
    # Recompute the objective's frozen-model activations on backward (bigger
    # image batches at the cost of one extra forward).
    remat: bool = False
    # alpha offsets applied to the original image's VA prediction to form the
    # per-image target (reference: src/optimize_image_param.py:34-42; "neg_02"
    # is -0.1 there too).
    adaptations: Tuple[Tuple[str, float], ...] = (
        ("pos_01", 0.1),
        ("pos_02", 0.2),
        ("neg_01", -0.1),
        ("neg_02", -0.1),
        ("neutral", 0.0),
    )
    # Op order of the active filter chain (reference: src/optimize_image_param.py:227).
    transforms: Tuple[str, ...] = (
        "exposure", "saturation", "tone", "color", "contrast", "sharp", "blur", "scale",
    )


@dataclasses.dataclass(frozen=True)
class AdaptConfig:
    """Diffusion inversion/resampling settings (reference: src/adapt_images/config.py:3-11).
    ``end_iteration=None`` means "use num_inversion_steps"."""

    num_inversion_steps: int = 50
    num_inference_steps: int = 50
    end_iteration: Optional[int] = None
    normalize_gradient: bool = True
    scheduler_type: str = "ddim"
    save_orig: bool = False
    is_xl: bool = True

    def resolved_end_iteration(self) -> int:
        return self.end_iteration if self.end_iteration is not None else self.num_inversion_steps


@dataclasses.dataclass(frozen=True)
class GuidanceConfig:
    """Classifier(-free) guidance settings (reference: src/adapt_images/config.py:13-23)."""

    clf_scale: float = 0.2
    reference_value: Optional[float] = None
    prompt: str = ""
    negative_prompt: str = ""
    cfg_scale: float = 2.0
    use_caption: bool = True
    is_nto: bool = True
    max: bool = False
    label: Optional[str] = None

    def resolved_label(self) -> str:
        return self.label if self.label is not None else f"CG_CFG_{self.cfg_scale:g}_{self.clf_scale:g}"
