"""Config registry: ``get_config(arch_id)`` for the architectures the port
serves so far."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = ["smollm-135m", "granite-moe-1b-a400m", "falcon-mamba-7b",
            "jamba-v0.1-52b"]

_MODULES = {
    "smollm-135m": "smollm_135m",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "jamba-v0.1-52b": "jamba_v01_52b",
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
