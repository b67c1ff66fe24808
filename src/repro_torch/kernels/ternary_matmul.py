"""Ternary-weight matmul — the paper's sign-flip + mux PE (Fig. 1 left).

Weights are {-1, 0, +1} stored as 2-bit signed fields, 16 per int32 word.
On a CUDA tensor this launches the hand-written kernel in
``csrc/qmatmul.cu`` (it replaces the TPU kernel
``repro/kernels/ternary_matmul.py:ternary_matmul``); on a CPU tensor it runs
the plain version, :func:`repro_torch.kernels.ref.ternary_matmul_ref`.

Epilogue: per-feature alpha (TWN scale) plus an optional bias, in f32; the
kernel's int path is bit-equal to the plain version.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import ternary_matmul_ref

_KINDS = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}


def check_matmul_args(x, wt_packed, scale, bias, bits: int, device) -> tuple:
    """Validate a packed matmul's operands for the CUDA launcher; returns
    (M, N, K)."""
    if x.dim() != 2 or wt_packed.dim() != 2:
        raise ValueError(f"x {tuple(x.shape)} and wt_packed "
                         f"{tuple(wt_packed.shape)} must be 2-D")
    m, k = x.shape
    n, kw = wt_packed.shape
    if kw * (32 // bits) != k:
        raise ValueError(f"K mismatch: x has {k}, {bits}-bit words hold "
                         f"{kw * (32 // bits)}")
    if x.dtype not in _KINDS:
        raise TypeError(f"x dtype {x.dtype} not in {list(_KINDS)}")
    if wt_packed.dtype != torch.int32:
        raise TypeError(f"wt_packed must be int32, got {wt_packed.dtype}")
    for name, t in (("scale", scale), ("bias", bias)):
        if t is not None and (t.dtype != torch.float32 or t.shape != (n,)):
            raise TypeError(f"{name} must be float32 of shape ({n},), got "
                            f"{t.dtype} {tuple(t.shape)}")
    for t in (x, wt_packed, scale, bias):
        if t is not None and (t.device != device or not t.is_contiguous()):
            raise ValueError("all operands must be contiguous on "
                             f"{device}")
    return m, n, k


def ternary_matmul(x: torch.Tensor, wt_packed: torch.Tensor,
                   alpha: torch.Tensor, bias: torch.Tensor | None = None
                   ) -> torch.Tensor:
    """``x (M, K) @ W^T * alpha (+ bias)`` -> (M, N) float32.

    x: int8 codes (int32 accumulation) or f32/bf16 (f32 accumulation);
    wt_packed: (N, K/16) int32; alpha, bias: (N,) float32."""
    if not x.is_cuda:
        return ternary_matmul_ref(x, wt_packed, alpha, bias=bias)
    m, n, k = check_matmul_args(x, wt_packed, alpha, bias, 2, x.device)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0:
        return out
    lib = _build.library("qmatmul")
    err = lib.ternary_matmul(
        x.data_ptr(), _KINDS[x.dtype], wt_packed.data_ptr(), alpha.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        m, n, k, _build.stream_ptr(x))
    _build.check(err, "ternary_matmul")
    _build.LAUNCHES["ternary_matmul"] += 1
    return out
