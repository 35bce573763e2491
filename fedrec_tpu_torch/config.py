"""Configuration for the port: the fields of ``fedrec_tpu.config`` that the
ported slices read, with the same names and defaults.

A copy, not an import: the port never imports the JAX package. ``--set
section.key=value`` overrides work as they do there
(``ExperimentConfig.apply_overrides``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


@dataclass
class DataConfig:
    """Dataset knobs the serving slice reads."""

    max_his_len: int = 50              # click-history cap (pad id 0 = <unk>)
    max_title_len: int = 50            # tokens per news title


@dataclass
class ModelConfig:
    """Two-tower model hyperparameters (defaults as ``fedrec_tpu``'s)."""

    news_dim: int = 400                # news/user embedding dim
    num_heads: int = 20                # user-encoder MHA heads
    head_dim: int = 20                 # d_k = d_v
    query_dim: int = 200               # additive-attention query hidden
    dropout_rate: float = 0.2
    user_tower: str = "mha"            # only "mha" is ported
    text_head_arch: str = "additive"   # only "additive" is ported
    bert_hidden: int = 768             # frozen-trunk hidden size
    # max-subtracted exp-normalization; False is the reference's raw exp
    stable_softmax: bool = True
    dtype: str = "float32"             # "float32" | "bfloat16"
    # route the text head's additive pool through kernel A (additive_pool)
    use_pallas: bool = False
    # route the user tower through kernel B (fused_history_score)
    fuse_hot_path: bool = False


@dataclass
class ExperimentConfig:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)

    def apply_overrides(self, overrides: list[str]) -> "ExperimentConfig":
        """Apply ``section.key=value`` strings (e.g. ``model.news_dim=32``);
        unknown sections and keys raise ``KeyError``."""
        for item in overrides:
            if "=" not in item:
                raise ValueError(f"override must be section.key=value, got {item!r}")
            path, raw = item.split("=", 1)
            parts = path.split(".")
            if len(parts) != 2:
                raise ValueError(f"override path must be section.key, got {path!r}")
            section = getattr(self, parts[0], None)
            if section is None or not dataclasses.is_dataclass(section):
                raise KeyError(f"unknown config section: {path!r}")
            if not hasattr(section, parts[1]):
                raise KeyError(f"unknown config key: {path!r}")
            current = getattr(section, parts[1])
            setattr(section, parts[1], _coerce(raw, type(current)))
        return self


def _coerce(raw: str, ty: type) -> Any:
    if ty is bool:
        low = raw.strip().lower()
        if low in ("1", "true", "yes", "on"):
            return True
        if low in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"cannot parse bool from {raw!r}")
    if ty is int:
        return int(raw)
    if ty is float:
        return float(raw)
    return raw
