"""device_ops_per_batch (ops): device operations a forward (kernels,
copies, fills), from the profiler; the harness's copy of the logits to the
host is left out."""
from __future__ import annotations

import devtrace


def read(run):
    _, _, batches = devtrace.window(run.trace)
    ops = devtrace.program_ops(run.trace)
    if not batches or not ops:
        return None
    return len(ops) / batches
