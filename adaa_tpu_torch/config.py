"""Config / flag surface (port of ``adaa_tpu/config.py``).

The reference's yaml schema (``configs/**``)::

    data:
      seed: 42
      adversarial_attacks: [FGSM, ...]        # optional
    checkpoint:
      path: trained_models/.../ckpt.pth       # or a JAX .msgpack
      # legacy variant written by the adversarial training CLI:
      # paths: [ ... ]
    model:
      name: lcnn | specrnet | rawnet3
      parameters: {...}
      optimizer: {lr: 1e-4, ...}

Both checkpoint schemas are accepted (``path``, or ``paths[0]`` as the
reference's adversarial-training CLI writes it). ``yaml`` is imported at
first use, so importing this module loads none.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, List, Optional, Union


@dataclasses.dataclass
class ModelConfig:
    name: str
    parameters: Dict[str, Any] = dataclasses.field(default_factory=dict)
    optimizer: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ExperimentConfig:
    model: ModelConfig
    seed: int = 42
    checkpoint_path: Optional[str] = None
    adversarial_attacks: List[str] = dataclasses.field(default_factory=list)
    raw: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_dict(cls, config: Dict[str, Any]) -> "ExperimentConfig":
        data = config.get("data", {}) or {}
        model = config.get("model", {}) or {}
        return cls(
            model=ModelConfig(name=model.get("name", ""),
                              parameters=model.get("parameters", {}) or {},
                              optimizer=model.get("optimizer", {}) or {}),
            seed=data.get("seed", 42),
            checkpoint_path=resolve_checkpoint_path(config.get("checkpoint", {}) or {}),
            adversarial_attacks=list(data.get("adversarial_attacks", []) or []),
            raw=config,
        )

    @classmethod
    def from_yaml(cls, path: Union[str, Path]) -> "ExperimentConfig":
        return cls.from_dict(load_yaml(path))

    def to_dict(self) -> Dict[str, Any]:
        d = dict(self.raw) if self.raw else {}
        d.setdefault("data", {})["seed"] = self.seed
        if self.adversarial_attacks:
            d["data"]["adversarial_attacks"] = list(self.adversarial_attacks)
        d["checkpoint"] = {"path": self.checkpoint_path}
        d["model"] = {"name": self.model.name, "parameters": self.model.parameters,
                      "optimizer": self.model.optimizer}
        return d

    def dump_yaml(self, path: Union[str, Path]) -> None:
        import yaml

        with open(path, "w") as f:
            yaml.dump(self.to_dict(), f)


def resolve_checkpoint_path(ckpt: Dict[str, Any]) -> Optional[str]:
    """Accept both ``checkpoint.path`` and legacy ``checkpoint.paths[0]``."""
    path = ckpt.get("path")
    if path:
        return str(path)
    paths = ckpt.get("paths")
    if paths:
        return str(paths[0])
    return None


def load_yaml(path: Union[str, Path]) -> Dict[str, Any]:
    import yaml

    with open(path, "r") as f:
        return yaml.safe_load(f)
