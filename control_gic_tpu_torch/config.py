"""YAML run configs into typed dataclasses (port of
control_gic_tpu/config.py): configs/train.yaml and configs/inference.yaml
map onto CGICConfig, LossConfig and TrainConfig; unknown keys are ignored.
PyYAML is imported where a file is read. The model keys that JAX's
CGICConfig has and the port's does not yet, dropout and remat, raise unless
they are off: dropping them would train a different model without a
word."""
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


def _check_unported(model: Dict[str, Any]) -> None:
    """Raise for model.dropout != 0 or model.remat true (JAX
    models/cgic.py:44,48), as Trainer raises for adaptive_g_weight."""
    for key, on in (("dropout", float(model.get("dropout", 0.0)) != 0.0),
                    ("remat", bool(model.get("remat", False)))):
        if on:
            raise NotImplementedError(
                f"model.{key}: {model[key]!r} is not ported yet (ROADMAP "
                "queue 1 item 12); the port trains without it")


def load_config(path: str) -> RunConfig:
    import yaml
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    _check_unported(raw.get("model", {}))
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
