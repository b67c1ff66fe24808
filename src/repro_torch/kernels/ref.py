"""Plain PyTorch versions of the packed matmul kernels — the semantics of
``repro.kernels.ref`` (integer paths match exactly, float paths to a
tolerance).  They run on any device: the CPU path of every wrapper, and the
yardstick the CUDA kernels are held against on the card.

Integer products accumulate in float64, which holds every int8 x int8 sum
these shapes produce exactly (|acc| < 2^53), so the result equals an int32
accumulation on CPU and CUDA alike (CUDA has no integer ``matmul``).
"""
from __future__ import annotations

import torch

from repro_torch.core import packing


def int_dot(x: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """Exact ``x @ wt.T`` for integer ``x`` (M, K) and codes ``wt`` (N, K),
    as int32."""
    return (x.to(torch.float64) @ wt.to(torch.float64).T).to(torch.int32)


def _epilogue(acc_f32, scale, row_scale, bias, out_dtype):
    out = acc_f32 * scale[None, :]
    if row_scale is not None:
        out = out * row_scale
    if bias is not None:
        out = out + bias[None, :]
    return out.to(out_dtype)


def packed_matmul_ref(x, wt_packed, scale, bits: int, bias=None,
                      out_dtype=torch.float32, row_scale=None):
    """x (M, K) int8 codes or float; wt_packed (N, K*bits/32) int32 signed
    fields; scale (N,) f32; row_scale optional (M, 1) f32, applied after the
    weight scale and before the bias.  Returns (M, N)."""
    wt = packing.unpack(wt_packed, bits, signed=True)          # (N, K) int8
    if not x.is_floating_point():
        acc = int_dot(x, wt).to(torch.float32)
    else:
        acc = x.to(torch.float32) @ wt.to(torch.float32).T
    return _epilogue(acc, scale, row_scale, bias, out_dtype)


def ternary_matmul_ref(x, wt_packed, alpha, bias=None,
                       out_dtype=torch.float32, row_scale=None):
    """x (M, K) int8/float; wt_packed (N, K/16) int32 of 2-bit codes in
    {-1, 0, +1}; alpha (N,) per-feature TWN scale.  A plain dot with
    ternary weights: out[m, n] = alpha[n] * sum_k x[m, k] * w[n, k]."""
    wt = packing.unpack(wt_packed, 2, signed=True)             # (N, K)
    if not x.is_floating_point():
        acc = int_dot(x, wt).to(torch.float32)
    else:
        acc = x.to(torch.float32) @ wt.to(torch.float32).T
    return _epilogue(acc, alpha, row_scale, bias, out_dtype)
