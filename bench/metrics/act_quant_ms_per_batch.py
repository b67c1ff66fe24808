"""act_quant_ms_per_batch (ms): device time a batch of the activation
quantizer kernels (``csrc/act_quant.cu``: B7c's row form on this path)."""
from __future__ import annotations

import devtrace

KERNELS = ("act_quant_",)


def read(run):
    _, _, batches = devtrace.window(run.trace)
    ops = [o for o in devtrace.program_ops(run.trace) if o.kind == "kernel"
           and devtrace.kernel_base(o.name).startswith(KERNELS)]
    if not batches or not ops:
        return None
    return sum(o.end - o.start for o in ops) / 1e3 / batches
