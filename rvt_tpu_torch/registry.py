"""Name-based registries (a copy of ``rvt_tpu.registry``; mirror of the
upstream ``modules/utils/fetch.py:8-28``).

The reference maps config names to Lightning modules ('rnndet' ->
detection Module; 'gen1'/'gen4' -> DataModule). Here the same names resolve
to the port's model constructors and dataset presets so config-driven
tooling can stay string-typed.
"""
from __future__ import annotations

from typing import Callable, Dict

from rvt_tpu_torch.config import ExperimentConfig, ModelConfig


def build_model(cfg: ModelConfig, name: str = "rnndet"):
    from rvt_tpu_torch.models.detector import RVTDetector

    registry: Dict[str, Callable] = {"rnndet": lambda: RVTDetector(cfg)}
    if name not in registry:
        raise NotImplementedError(f"unknown model {name!r}; "
                                  f"available: {sorted(registry)}")
    return registry[name]()


def build_backbone(cfg):
    """Backbone registry (models/detection/recurrent_backbone/__init__.py)."""
    from rvt_tpu_torch.models.backbone import RVTBackbone

    registry = {"MaxViTRNN": lambda: RVTBackbone(cfg)}
    name = "MaxViTRNN"
    return registry[name]()


def dataset_preset(name: str, size: str = "tiny", **overrides) -> ExperimentConfig:
    from rvt_tpu_torch.config import preset

    if name not in ("gen1", "gen4"):
        raise NotImplementedError(f"unknown dataset {name!r}")
    return preset(name, size, **overrides)
