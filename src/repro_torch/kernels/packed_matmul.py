"""Packed k-bit weight matmul — the low-bit integer PEs (k in {2, 4, 8}).

Weights live bit-packed, 32/k signed fields per int32 word, cutting weight
traffic 16/k times against bf16.  On a CUDA tensor this launches the
hand-written kernel in ``csrc/qmatmul.cu`` (the same template as the ternary
kernel; it replaces the TPU kernel
``repro/kernels/packed_matmul.py:packed_matmul``); on a CPU tensor it runs
the plain version, :func:`repro_torch.kernels.ref.packed_matmul_ref`.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import packed_matmul_ref
from .ternary_matmul import _KINDS, check_matmul_args, launch_int8_variant

KERNEL_BITS = (2, 4, 8)


def packed_matmul(x: torch.Tensor, wt_packed: torch.Tensor,
                  scale: torch.Tensor, bias: torch.Tensor | None = None, *,
                  bits: int, block=None) -> torch.Tensor:
    """``x (M, K) @ unpack(W^T) * scale (+ bias)`` -> (M, N) float32;
    ``block`` as in :func:`.ternary_matmul.ternary_matmul`."""
    if not x.is_cuda:
        return packed_matmul_ref(x, wt_packed, scale, bits, bias=bias)
    if bits not in KERNEL_BITS:
        raise ValueError(f"packed_matmul kernel takes bits in {KERNEL_BITS}, "
                         f"got {bits}")
    m, n, k = check_matmul_args(x, wt_packed, scale, bias, bits, x.device)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0:
        return out
    lib = _build.library("qmatmul")
    if block is not None:
        err = launch_int8_variant(lib, x, wt_packed, scale, bias, out, bits,
                                  "int", block)
    else:
        err = lib.packed_matmul(
            x.data_ptr(), _KINDS[x.dtype], wt_packed.data_ptr(),
            scale.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), m, n, k, bits, _build.stream_ptr(x))
    _build.check(err, "packed_matmul")
    _build.LAUNCHES["packed_matmul"] += 1
    return out
