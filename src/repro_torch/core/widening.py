"""WRPN widening (paper §II.A / §IV), as ``repro.core.widening``.

Accuracy lost to low-bit quantization is recovered by widening filter
counts: the feature maps of each CNN conv layer, or an LM's d_ff.  Ops grow
~width^2, the denominator of the paper's "Eq TOPS" normalization.
"""
from __future__ import annotations

import dataclasses


def widen_cnn_channels(channels, width_mult: float, keep_first: bool = True,
                       keep_last: bool = True):
    """Widen a list of per-layer channel counts; the input layer and the
    classifier keep their width (WRPN)."""
    n = len(channels)
    return [c if (keep_first and i == 0) or (keep_last and i == n - 1)
            else int(round(c * width_mult)) for i, c in enumerate(channels)]


def eq_ops_factor(width_mult: float) -> float:
    """Paper §IV.C: 2x and 3x wide topologies divide the achievable
    performance by 4 and 9."""
    return float(width_mult) ** 2


def widen_config(cfg, width_mult: float):
    """Widen an LM config dataclass: scales d_ff (and an MoE expert's d_ff).
    width_mult=1 is the identity."""
    if width_mult == 1:
        return cfg
    updates = {}
    if getattr(cfg, "d_ff", 0):
        updates["d_ff"] = int(cfg.d_ff * width_mult)
    if getattr(cfg, "moe_d_ff", 0):
        updates["moe_d_ff"] = int(cfg.moe_d_ff * width_mult)
    return dataclasses.replace(cfg, **updates)
