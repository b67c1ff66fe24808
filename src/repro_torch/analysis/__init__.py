"""Invariant auditing — the port of ``repro.analysis``.

Two passes, one front door (``python -m repro_torch.analysis audit``):

  * the **contract checker** (:mod:`.rules`) runs every serving step of
    the config matrix (:mod:`.steps`) once, eagerly, under the recorders
    the port keeps — the engine's dispatch trace and launch counts, the
    collective counts, the tuning-cache stats — and the aten op walker
    (:mod:`.op_walker`), and holds each step to its declarative rules: no
    collectives on pure-DP steps, the CUDA kernels actually launched, no
    int codes upcast to a float matmul outside a kernel, per-row
    activation scales, caches updated in place, warm tuning keys, the
    fused paged decode as one dispatch a layer;
  * the **AST architecture linter** (:mod:`.astlint`) over the port's
    sources.

No counterpart: the reference's ``analysis/hlo.py`` (and
``launch/hlo_cost.py``, which it serves) parses XLA's HLO text, which the
port never has.  The port counts its collectives in
``repro_torch.parallel.comm`` as it makes them.

Submodules load on first attribute access, as the reference's do.
"""
from __future__ import annotations

_LAZY = {
    "astlint": ".astlint",
    "op_walker": ".op_walker",
    "rules": ".rules",
    "steps": ".steps",
    "report": ".report",
    "cli": ".cli",
    # conveniences
    "audit_step": (".rules", "audit_step"),
    "Finding": (".report", "Finding"),
    "Report": (".report", "Report"),
    "StepSpec": (".report", "StepSpec"),
}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    import importlib
    spec = _LAZY.get(name)
    if spec is None:
        raise AttributeError(f"module 'repro_torch.analysis' has no "
                             f"attribute {name!r}")
    if isinstance(spec, tuple):
        return getattr(importlib.import_module(spec[0], __name__), spec[1])
    return importlib.import_module(spec, __name__)
