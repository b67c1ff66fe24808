"""device_idle_pct (%): the share of the traced batches' span in which no
device operation ran (the union of their intervals)."""
from __future__ import annotations

import devtrace


def read(run):
    lo, hi, _ = devtrace.window(run.trace)
    if hi <= lo or not run.trace.ops:
        return None
    return 100.0 * (1.0 - devtrace.busy_us(run.trace) / (hi - lo))
