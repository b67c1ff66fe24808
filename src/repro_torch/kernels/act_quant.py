"""Activation quantizers — float rows to int8 codes in one elementwise pass.

The counterparts of the three TPU kernels of ``repro/kernels/act_quant.py``
and two forms that also compute their scale:

  * :func:`act_quant` — unsigned eq. (4), ``floor(clip(x,0,1)*(2^k-1)+0.5)``
    (half up), for post-ReLU activations;
  * :func:`act_quant_signed` — ``clip(round(x/s), +-(2^(k-1)-1))`` (half to
    even) with one scale ``s``;
  * :func:`act_quant_signed_tensor` — its tensor form, the card's path of
    ``core.act_quant_codes_signed``: the scale ``max(amax|x|, 1e-8) / qmax``
    over all of x computed in the same launch, and returned beside the
    codes.  Its launches count as ``act_quant_signed``'s;
  * :func:`act_quant_signed_grouped` — the same with ``s`` (M, G), G | F,
    each scale covering F/G columns;
  * :func:`act_quant_signed_rows` — its row form, the engine's per-row
    quantizer (``engine._prep_activations``): G = 1 with the scale
    ``max(amax|x[row]|, 1e-8) / qmax`` computed in the same launch, and
    returned beside the codes.  Its launches count as
    ``act_quant_signed_grouped``'s: it is the same TPU kernel's work.

x is (M, F) f32 or bf16; the codes are (M, F) int8.  ``compute_dtype``
float32 is the TPU kernels' arithmetic; bfloat16 rounds every intermediate
to bf16, as the same PyTorch expression on bf16 rows does (the engine
passes the rows' dtype).  The kernel takes these two; the plain versions
compute in any float dtype.  On a CUDA tensor each wrapper launches its
hand-written kernel in ``csrc/act_quant.cu``; on a CPU tensor it runs the
plain version in :mod:`repro_torch.kernels.ref`.  The kernel is
``torch.equal`` to the plain version.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import (act_quant_ref, act_quant_signed_grouped_ref,
                  act_quant_signed_ref, act_quant_signed_rows_ref,
                  act_quant_signed_tensor_ref)

_KINDS = {torch.float32: 1, torch.bfloat16: 2}      # x and scale dtypes
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def _check_x(x, bits: int, compute_dtype) -> tuple[int, int]:
    """Validate x and the options for the CUDA launcher; returns (M, F)."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {compute_dtype} not in "
                         f"{COMPUTE_DTYPES}")
    if x.dim() != 2:
        raise ValueError(f"x must be (M, F), got {tuple(x.shape)}")
    if x.dtype not in _KINDS:
        raise TypeError(f"x dtype {x.dtype} not in {list(_KINDS)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if not 1 <= bits <= 8:
        raise ValueError(f"bits={bits} outside [1, 8]")
    return x.shape


def _check_scale(scale, x, shape) -> None:
    if scale.dtype not in _KINDS:
        raise TypeError(f"scale dtype {scale.dtype} not in {list(_KINDS)}")
    if tuple(scale.shape) != tuple(shape):
        raise ValueError(f"scale must be {tuple(shape)}, got "
                         f"{tuple(scale.shape)}")
    if scale.device != x.device or not scale.is_contiguous():
        raise ValueError(f"scale must be contiguous on {x.device}")


def _aligned(x, out) -> int:
    """1 when the row kernels may use 16-byte loads and 8-byte stores."""
    return int(x.shape[1] % 8 == 0 and _flat_aligned(x, out))


def _flat_aligned(x, out) -> int:
    """1 when the flat kernels (x as one array) may use 16-byte loads and
    8-byte stores: any F."""
    return int(x.data_ptr() % 16 == 0 and out.data_ptr() % 8 == 0)


# The tensor form's state: 3 words (max, arrivals, reads), zero at rest (the
# kernel puts them back to zero before it ends).  Two launches that may run
# at once must not share one: an eager call takes its stream's, and a call
# captured into a CUDA graph a slot of its own, which the graph keeps, from
# a pool zeroed at the device's first eager call (256 KB: a timing loop
# captures hundreds of calls; a capture that finds none left zeroes a state
# of its own inside the graph, one memset node more).
_STREAM_STATE: dict[tuple, torch.Tensor] = {}
_GRAPH_SLOTS = 16384
_GRAPH_POOL: dict[torch.device, list] = {}      # device -> [(slots, 4), taken]


def _tensor_state(device) -> torch.Tensor:
    if torch.cuda.is_current_stream_capturing():
        pool = _GRAPH_POOL.get(device)
        if pool is None or pool[1] == _GRAPH_SLOTS:
            return torch.zeros(3, dtype=torch.int32, device=device)
        pool[1] += 1
        return pool[0][pool[1] - 1]
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    state = _STREAM_STATE.get(key)
    if state is None:
        if device not in _GRAPH_POOL:
            _GRAPH_POOL[device] = [torch.zeros(
                (_GRAPH_SLOTS, 4), dtype=torch.int32, device=device), 0]
        state = _STREAM_STATE[key] = torch.zeros(3, dtype=torch.int32,
                                                 device=device)
        # zero before a graph replayed on any stream reads the pool
        torch.cuda.current_stream(device).synchronize()
    return state


def _launch(name: str, fn: str, x, args) -> torch.Tensor:
    """Allocate the codes and launch ``fn`` with (x, x_kind, *args(out))."""
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    if x.numel() == 0:
        return out
    lib = _build.library("act_quant")
    err = getattr(lib, fn)(x.data_ptr(), _KINDS[x.dtype], *args(out))
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return out


def act_quant(x: torch.Tensor, *, bits: int,
              compute_dtype=torch.float32) -> torch.Tensor:
    """Unsigned eq. (4) codes 0..min(2^k - 1, 127) of x (M, F)."""
    if not x.is_cuda:
        return act_quant_ref(x, bits, compute_dtype=compute_dtype)
    m, f = _check_x(x, bits, compute_dtype)
    bf16 = int(compute_dtype == torch.bfloat16)
    return _launch("act_quant", "act_quant_unsigned", x, lambda out: (
        out.data_ptr(), m, f, bits, bf16, _flat_aligned(x, out),
        _build.stream_ptr(x)))


def act_quant_signed(x: torch.Tensor, scale: torch.Tensor, *, bits: int,
                     compute_dtype=torch.float32) -> torch.Tensor:
    """Signed symmetric codes of x (M, F) under one scale (a one-element
    f32/bf16 tensor on x's device: no host round trip)."""
    if not x.is_cuda:
        return act_quant_signed_ref(x, bits, scale,
                                    compute_dtype=compute_dtype)
    m, f = _check_x(x, bits, compute_dtype)
    if scale.numel() != 1:
        raise ValueError(f"scale must hold one value, got {tuple(scale.shape)}")
    scale = scale.reshape(1)
    _check_scale(scale, x, (1,))
    bf16 = int(compute_dtype == torch.bfloat16)
    return _launch("act_quant_signed", "act_quant_signed", x, lambda out: (
        scale.data_ptr(), _KINDS[scale.dtype], out.data_ptr(), m, f, bits,
        bf16, _flat_aligned(x, out), _build.stream_ptr(x)))


def act_quant_signed_tensor(x: torch.Tensor, *, bits: int
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Signed codes of x (M, F) f32/bf16 under one scale taken from all of
    x, computed in x's dtype: ``scale = max(amax|x|, 1e-8) / qmax``, codes
    ``clip(round(x / scale), +-qmax)``; 2 <= bits <= 8.  Returns (codes,
    the scale as a float32 scalar), one launch on the card."""
    if not x.is_cuda:
        return act_quant_signed_tensor_ref(x, bits)
    m, f = _check_x(x, bits, x.dtype)
    if bits < 2 or x.numel() == 0:
        raise ValueError(f"bits={bits}, shape {tuple(x.shape)}: the tensor "
                         "form needs qmax >= 1 and values to take the max of")
    state = _tensor_state(x.device)
    scale = torch.empty((), dtype=torch.float32, device=x.device)
    codes = _launch("act_quant_signed", "act_quant_signed_tensor", x,
                    lambda out: (out.data_ptr(), scale.data_ptr(),
                                 state.data_ptr(), m, f, bits,
                                 _flat_aligned(x, out),
                                 _build.stream_ptr(x)))
    return codes, scale


def act_quant_signed_grouped(x: torch.Tensor, scale: torch.Tensor, *,
                             bits: int,
                             compute_dtype=torch.float32) -> torch.Tensor:
    """Signed symmetric codes of x (M, F) under scale (M, G), G | F:
    column c of row i divides by scale[i, c // (F // G)]."""
    if not x.is_cuda:
        return act_quant_signed_grouped_ref(x, bits, scale,
                                            compute_dtype=compute_dtype)
    m, f = _check_x(x, bits, compute_dtype)
    if scale.dim() != 2 or scale.shape[1] == 0 or f % scale.shape[1]:
        raise ValueError(f"scale {tuple(scale.shape)} does not group x "
                         f"{tuple(x.shape)}")
    g = scale.shape[1]
    _check_scale(scale, x, (m, g))
    bf16 = int(compute_dtype == torch.bfloat16)
    return _launch("act_quant_signed_grouped", "act_quant_signed_grouped", x,
                   lambda out: (scale.data_ptr(), _KINDS[scale.dtype],
                                out.data_ptr(), m, f, g, bits, bf16,
                                _aligned(x, out), _build.stream_ptr(x)))


def act_quant_signed_rows(x: torch.Tensor, *, bits: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row signed codes of x (M, F) f32/bf16 and their scales (M, 1) in
    x's dtype, computed in x's dtype: ``a_scale = max(amax|x[row]|, 1e-8)
    / qmax``, codes ``clip(round(x / a_scale), +-qmax)``; 2 <= bits <= 8."""
    if not x.is_cuda:
        return act_quant_signed_rows_ref(x, bits)
    m, f = _check_x(x, bits, x.dtype)
    if bits < 2 or f == 0:
        raise ValueError(f"bits={bits}, F={f}: the row form needs qmax >= 1 "
                         "and a row to take the max of")
    scale = torch.empty((m, 1), dtype=x.dtype, device=x.device)
    codes = _launch("act_quant_signed_grouped", "act_quant_signed_rows", x,
                    lambda out: (out.data_ptr(), scale.data_ptr(), m, f, bits,
                                 _aligned(x, out), _build.stream_ptr(x)))
    return codes, scale
