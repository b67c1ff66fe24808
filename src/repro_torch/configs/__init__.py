"""Config registry: ``get_config(arch_id)`` for the architectures the port
serves so far."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = ["smollm-135m"]

_MODULES = {
    "smollm-135m": "smollm_135m",
}


def get_config(arch_id: str, precision: str = None, kv_bits: int = None,
               **overrides) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; the port serves {ARCH_IDS}")
    cfg = importlib.import_module(
        f"repro_torch.configs.{_MODULES[arch_id]}").CONFIG
    if precision is not None:
        overrides["precision"] = precision
    if kv_bits is not None:
        overrides["kv_bits"] = kv_bits
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg
