"""YAML run configs into typed dataclasses (port of
control_gic_tpu/config.py): configs/train.yaml and configs/inference.yaml
map onto CGICConfig, LossConfig and TrainConfig; unknown keys are ignored.
PyYAML is imported where a file is read."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from .models.cgic import CGICConfig
from .train.losses import LossConfig
from .train.state import TrainConfig


def _filter_kwargs(cls, d: Dict[str, Any]) -> Dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


def _tupled(d: Dict[str, Any]) -> Dict[str, Any]:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    model: CGICConfig
    train: TrainConfig
    data: Dict[str, Any]
    trainer: Dict[str, Any]
    ckpt_path: Optional[str] = None
    ratios: tuple = (0.1, 0.4)


def load_config(path: str) -> RunConfig:
    import yaml
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    model = CGICConfig(**_tupled(_filter_kwargs(CGICConfig,
                                                raw.get("model", {}))))
    loss = LossConfig(**_filter_kwargs(LossConfig, raw.get("loss", {})))
    train_kwargs = _filter_kwargs(TrainConfig, raw.get("train", {}))
    train_kwargs["loss"] = loss
    ratios = tuple(raw.get("ratios", (0.1, 0.4)))
    if "coarse_ratio" not in train_kwargs:
        train_kwargs["coarse_ratio"] = ratios[0]
        train_kwargs["medium_ratio"] = ratios[1]
    return RunConfig(model=model, train=TrainConfig(**train_kwargs),
                     data=raw.get("data", {}), trainer=raw.get("trainer", {}),
                     ckpt_path=raw.get("ckpt_path"), ratios=ratios)
