"""Binary (1x1) matmul — XNOR + popcount, the paper's Fig. 1 PE.

Both operands are +/-1 vectors stored as {1, 0} bits, 32 per int32 word:

    out[m, n] = sum_k a[m, k] * w[n, k]   (a, w in {-1, +1})
              = K - 2 * popcount(a_bits XOR w_bits)

On a CUDA tensor this launches one of the two hand-written kernels in
``csrc/binary_matmul.cu``, chosen there by M and N (decode rows on the CUDA
cores, or the 1-bit tensor cores); together they replace the TPU kernel
``repro/kernels/binary_matmul.py:binary_matmul``.  On a CPU tensor it runs
the plain version, :func:`repro_torch.kernels.ref.binary_matmul_ref`.

Epilogue: per-feature alpha (the XNOR-net scale) plus an optional bias, in
f32; both kernels are bit-equal to the plain version.  ``block`` names one
of the two kernels by its tile (:mod:`.tuning`) and launches it through
``binary_matmul_variant``, which is how the tuning cache's picks run.
"""
from __future__ import annotations

import torch

from . import _build, tuning
from .ref import binary_matmul_ref


def _check_args(a_packed, wt_packed, alpha, bias, k: int) -> tuple:
    """Validate the operands for the CUDA launcher; returns (M, N)."""
    if a_packed.dim() != 2 or wt_packed.dim() != 2:
        raise ValueError(f"a_packed {tuple(a_packed.shape)} and wt_packed "
                         f"{tuple(wt_packed.shape)} must be 2-D")
    m, kw = a_packed.shape
    n, kw2 = wt_packed.shape
    if kw != kw2 or kw * 32 != k:
        raise ValueError(f"K mismatch: k={k}, words {kw} (a) and {kw2} (w); "
                         "K must be 32 per word")
    for name, t in (("a_packed", a_packed), ("wt_packed", wt_packed)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32 words, got {t.dtype}")
    for name, t in (("alpha", alpha), ("bias", bias)):
        if t is not None and (t.dtype != torch.float32 or t.shape != (n,)):
            raise TypeError(f"{name} must be float32 of shape ({n},), got "
                            f"{t.dtype} {tuple(t.shape)}")
    for t in (a_packed, wt_packed, alpha, bias):
        if t is not None and (t.device != a_packed.device
                              or not t.is_contiguous()):
            raise ValueError(f"all operands must be contiguous on "
                             f"{a_packed.device}")
    return m, n


def binary_matmul(a_packed: torch.Tensor, wt_packed: torch.Tensor,
                  alpha: torch.Tensor, bias: torch.Tensor | None = None, *,
                  k: int, block=None) -> torch.Tensor:
    """``(K - 2 * popcount(a XOR w)) * alpha (+ bias)`` -> (M, N) float32.

    a_packed: (M, K/32) int32; wt_packed: (N, K/32) int32; alpha, bias:
    (N,) float32; ``k`` the unpacked K (a multiple of 32); ``block`` the
    tile of the kernel to run (None: the automatic choice; the plain
    version ignores it)."""
    if not a_packed.is_cuda:
        out = binary_matmul_ref(a_packed, wt_packed, k, alpha=alpha)
        return out if bias is None else out + bias[None, :]
    m, n = _check_args(a_packed, wt_packed, alpha, bias, k)
    out = torch.empty((m, n), dtype=torch.float32, device=a_packed.device)
    if m == 0:
        return out
    lib = _build.library("binary_matmul")
    bias_ptr = None if bias is None else bias.data_ptr()
    if block is not None:
        err = lib.binary_matmul_variant(
            a_packed.data_ptr(), wt_packed.data_ptr(), alpha.data_ptr(),
            bias_ptr, out.data_ptr(), m, n, k,
            tuning.matmul_variant("binary", k, block),
            _build.stream_ptr(a_packed))
    else:
        err = lib.binary_matmul(
            a_packed.data_ptr(), wt_packed.data_ptr(), alpha.data_ptr(),
            bias_ptr, out.data_ptr(), m, n, k, _build.stream_ptr(a_packed))
    _build.check(err, "binary_matmul")
    _build.LAUNCHES["binary_matmul"] += 1
    return out
