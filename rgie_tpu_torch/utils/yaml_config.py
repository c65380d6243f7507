"""YAML run configs for MUNIT onto the port's typed dataclasses (the port's
copy of ``rgie_tpu/utils/yaml_config.py``, on ``rgie_tpu_torch.config``).

Reference: ``src/external/imaginaire/config.py:19-207`` (AttrDict and Config
with deep trainer/gen/dis/data defaults) and the shipped
``imagenet2imagenet.yaml``. Unknown keys are kept in the attribute dict.
"""

from __future__ import annotations

from typing import Any, Dict

from rgie_tpu_torch.config import MunitDisConfig, MunitGenConfig


class AttrDict(dict):
    """Recursive attribute dict (imaginaire config.py:19-73)."""

    def __getattr__(self, key):
        try:
            v = self[key]
        except KeyError as e:
            raise AttributeError(key) from e
        return AttrDict(v) if isinstance(v, dict) and not isinstance(v, AttrDict) else v

    def __setattr__(self, key, value):
        self[key] = value


def load_yaml(path: str) -> AttrDict:
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f)
    return _to_attrdict(data)


def _to_attrdict(obj):
    if isinstance(obj, dict):
        return AttrDict({k: _to_attrdict(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [_to_attrdict(v) for v in obj]
    return obj


def recursive_update(base: Dict[str, Any], update: Dict[str, Any]) -> Dict[str, Any]:
    """(imaginaire config.py:226-238)"""
    for k, v in update.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            recursive_update(base[k], v)
        else:
            base[k] = v
    return base


#: The ``gen:`` keys that map onto ``MunitGenConfig`` (weight_norm_type is
#: realized when a checkpoint is read, so it is dropped).
GEN_KEYS = ("latent_dim", "num_filters", "max_num_filters", "num_filters_mlp", "num_res_blocks",
            "num_mlp_blocks", "num_downsamples_style", "num_downsamples_content",
            "num_image_channels", "content_norm_type", "style_norm_type", "decoder_norm_type",
            "pre_act")


def munit_gen_config_from_yaml(path: str) -> MunitGenConfig:
    """A ``gen:`` block like imagenet2imagenet.yaml:54-67 as a
    ``MunitGenConfig``."""
    gen = load_yaml(path).get("gen", {})
    return MunitGenConfig(**{k: gen[k] for k in GEN_KEYS if k in gen})


def munit_dis_config_from_yaml(path: str) -> MunitDisConfig:
    dis = load_yaml(path).get("dis", {})
    return MunitDisConfig(patch_wise=dis.get("patch_wise", True),
                          num_filters=dis.get("num_filters", 48),
                          max_num_filters=dis.get("max_num_filters", 1024),
                          num_layers=dis.get("num_layers", 5))
