"""The comparison that decides ``correct``.

The program's logits of a sample of the window's batches, drawn from the
seed, are held to the reference's logits of the same input batches:
``logit_gap`` is the largest absolute difference over every compared logit
over the largest absolute reference logit.  Logits of the wrong shape, or
not finite, read ``FAR``, and so does a comparison whose reference
logits are all 0, which could tell nothing apart.  Each configuration file states its limit
(``limits``) and ``PERF.md`` the readings it was set from: the program's
over a dozen seeds or more, and the control's, the reference computed in
TF32.
"""
from __future__ import annotations

import sys

import numpy as np

# what a comparison that can tell nothing reads: the largest float, which
# JSON can carry (an infinity it can not)
FAR = sys.float_info.max


def logit_gap(got: list, want: list) -> float:
    """max |got - want| / max |want| over pairs of (B, classes) arrays."""
    num, den = 0.0, 0.0
    for g, w in zip(got, want, strict=True):
        g = np.asarray(g, dtype=np.float64)
        w = np.asarray(w, dtype=np.float64)
        if g.shape != w.shape or not np.isfinite(g).all():
            return FAR
        num = max(num, float(np.abs(g - w).max()))
        den = max(den, float(np.abs(w).max()))
    if den == 0.0:                 # nothing to compare: no pass
        return FAR
    return num / den


def decide(readings: dict[str, float], limits: dict[str, float]):
    """(correct, checks): every reading within its limit; checks gives
    each with its limit."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in readings.items()}
    ok = bool(readings) and all(v <= limits[k] for k, v in readings.items())
    return ok, checks
