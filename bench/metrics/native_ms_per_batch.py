"""native_ms_per_batch (ms): device time a batch in operations that are not
the program's own kernels: PyTorch's kernels, copies and fills, and
library GEMMs (the glue around the products: im2col, BNS, ReLU, the eq.
(4) re-quantization, pooling, residual adds, the head).  The program's
kernels are the ``__global__`` functions of its CUDA sources; the
harness's copies of the logits to the host are left out."""
from __future__ import annotations

import devtrace


def read(run):
    _, _, batches = devtrace.window(run.trace)
    ops = devtrace.program_ops(run.trace)
    if not batches or not ops:
        return None
    native = [o for o in ops if o.kind != "kernel"
              or devtrace.kernel_base(o.name) not in run.port_kernels]
    return sum(o.end - o.start for o in native) / 1e3 / batches
