"""qmatmul_roofline (%): the quantized products' least time over the
device time of the kernels of ``csrc/qmatmul.cu`` (B1) that ran them.

The least time sums ``costs.bound_s`` over the layers those kernels ran:
the operations at the int8 peak or the bytes (input map and output map as
int8 codes, the packed weight) at HBM's, whichever is longer.  Which
layers those are: the kernels' launches a forward, matched to the
quantized layers whose weight packs into 32-bit words (K a multiple of
32 / w_bits; the rest run on another path), or to every quantized layer.
Where the count matches neither, the reader can not tell which layers ran
there, and returns nothing."""
from __future__ import annotations

import costs
import devtrace

KERNELS = ("qmm_",)


def read(run):
    _, _, batches = devtrace.window(run.trace)
    ops = [o for o in devtrace.program_ops(run.trace) if o.kind == "kernel"
           and devtrace.kernel_base(o.name).startswith(KERNELS)]
    if not batches or not ops or len(ops) % batches:
        return None
    quantized = [x for x in run.layers if x.quantized]
    packed = [x for x in quantized if x.k % (32 // x.w_bits) == 0]
    launches = len(ops) // batches
    served = packed if launches == len(packed) else \
        quantized if launches == len(quantized) else None
    if served is None:
        return None
    kernel_s = sum(o.end - o.start for o in ops) / 1e6 / batches
    return 100.0 * sum(costs.bound_s(x) for x in served) / kernel_s
