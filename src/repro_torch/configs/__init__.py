"""Config registry: ``get_config(arch_id)`` for every LM architecture of the
reference, in its order, and the dry run's grid of (arch x shape) cells
(``iter_cells``)."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig  # noqa: F401

ARCH_IDS = [
    "jamba-v0.1-52b",
    "glm4-9b",
    "smollm-135m",
    "gemma2-27b",
    "starcoder2-15b",
    "whisper-base",
    "internvl2-76b",
    "kimi-k2-1t-a32b",
    "granite-moe-1b-a400m",
    "falcon-mamba-7b",
]

_MODULES = {
    "jamba-v0.1-52b": "jamba_v01_52b",
    "glm4-9b": "glm4_9b",
    "smollm-135m": "smollm_135m",
    "gemma2-27b": "gemma2_27b",
    "starcoder2-15b": "starcoder2_15b",
    "whisper-base": "whisper_base",
    "internvl2-76b": "internvl2_76b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "falcon-mamba-7b": "falcon_mamba_7b",
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


def iter_cells():
    """All (arch, shape, skip) dry-run cells, in the reference's order:
    ``skip`` is None, or why the cell is not run (pure full attention at
    the 524k context)."""
    for arch_id in ARCH_IDS:
        cfg = get_config(arch_id)
        for shape in SHAPES.values():
            skip = None
            if shape.name == "long_500k" and not cfg.sub_quadratic:
                skip = "pure full attention at 524k ctx (DESIGN.md §4)"
            yield arch_id, shape, skip
