"""Precision-dispatch kernel engine — the counterpart of
``repro.kernels.engine``.

A kernel **registry** keyed on ``(weight_kind, act_bits, weight_bits,
backend)`` behind one entry point, :func:`qmatmul`, which

  1. prepares activations for the config (dynamic symmetric PER-ROW
     quantization to int8 codes; at 1 bit the signs, bit-packed for the
     XNOR kernel; or float passthrough),
  2. resolves the implementation: the exact key first, then the plain
     ``torch`` backend (keys with no CUDA kernel, such as the unpacked
     int8-codes storage, are registered for ``torch`` only),
  3. on the card, resolves which compiled kernel an int-code matmul runs
     from the tuning cache (:mod:`repro_torch.kernels.tuning`; serving
     never re-tunes, it looks up; a miss is the C file's automatic choice),
  4. applies the epilogue ``acc * w_scale * a_scale + bias`` in that order.

On the card, step 1's per-row scales and codes come from one launch of
the activation-quantizer kernel's row form (``act_quant_signed_rows``,
counted as ``act_quant_signed_grouped``).

Backends: ``"cuda"`` (the hand-written kernels of ``csrc/``) and
``"torch"`` (their plain versions).  With ``backend=None`` a CUDA tensor
goes to the kernel and a CPU tensor to the plain version; ``"cuda"`` with a
CPU tensor raises; nothing switches to the plain path while a card is
present unless the caller passes ``backend="torch"``.

A second registry keyed on ``(attn_kind, kv_bits, backend)`` serves the
attention kernels: the dense-cache decode (:func:`decode_attention`), the
paged block pool (:func:`paged_attention`), the fused paged decode with the
``wo`` projection folded in (:func:`fused_paged_decode`) and full-sequence
causal attention (:func:`flash_attention`, prefill and forward).

``weight_kind`` is the *storage* kind: "int" / "ternary" / "binary" for
bit-packed int32 words, "codes" for the unpacked int8 fallback (3-bit,
misaligned K).  ``act_bits == 0`` means float activations.

The dry run (``launch.dryrun``) traces a step on ``meta`` tensors (no
data, no data pointer) inside :func:`trace_as_card`, where they take the
card's routes.  Each CUDA route then returns an empty result of its
kernel's shape and dtype and adds one launch and the kernel's work
(:mod:`.costs`) to :func:`traced_work`, in place of the launch: nothing
is built or loaded, no stream is touched, and the dispatch trace says
``cuda`` as it does on the card.  A tensor with data never takes that
branch.
"""
from __future__ import annotations

import contextlib
from collections.abc import Callable
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import packing
from repro_torch.core.precision import (A_FLOAT, PrecisionConfig, W_BINARY,
                                        W_FLOAT, W_INT, W_TERNARY)
from repro_torch.core.quantize import (act_fake_quant, true_div,
                                      weight_fake_quant, weight_quant)

from . import _build, costs, ref, tuning
from .act_quant import act_quant_signed_grouped, act_quant_signed_rows
from .binary_matmul import binary_matmul
from .decode_attention import (_pos_vector,
                               decode_attention as _decode_attention_kernel,
                               decode_attention_serving_ref)
from .decode_attention import launch_plan as decode_launch_plan
from .decode_fused import fused_decode as _fused_decode_kernel
from .flash_attention import flash_attention as _flash_attention_kernel
from .paged_attention import paged_attention as _paged_attention_kernel
from .paged_attention import paged_attention_ref
from .packed_matmul import packed_matmul
from .ternary_matmul import ternary_matmul

BACKEND_CUDA = "cuda"
BACKEND_TORCH = "torch"
BACKENDS = (BACKEND_CUDA, BACKEND_TORCH)

# storage kind for the unpacked int8-codes fallback (3-bit, misaligned K)
K_CODES = "codes"

# the hand-written kernels, by launch-counter name
KERNELS = ("ternary_matmul", "packed_matmul", "binary_matmul",
           "decode_attention", "paged_attention", "fused_decode",
           "act_quant", "act_quant_signed", "act_quant_signed_grouped",
           "flash_attention")


# ---------------------------------------------------------------------------
# packed-weight container + packers
# ---------------------------------------------------------------------------
class PackedWeight(NamedTuple):
    """A quantized+packed weight ready for the kernels.

    wt_packed: (N, K*bits/32) int32 (W^T packed along K) — or (N, K) int8
               when the config doesn't pack (e.g. 3-bit).
    scale:     (N,) float32 per-output-channel alpha/dequant scale.
    bits:      field width (2 for ternary, 1 for binary).
    mode:      W_INT | W_TERNARY | W_BINARY.
    k:         unpacked reduction length.
    """
    wt_packed: torch.Tensor
    scale: torch.Tensor
    bits: int
    mode: str
    k: int


def weight_bits(cfg: PrecisionConfig) -> int:
    if cfg.w_mode == W_BINARY:
        return 1
    if cfg.w_mode == W_TERNARY:
        return 2
    return cfg.w_bits


def pack_weight(w: torch.Tensor, cfg: PrecisionConfig) -> PackedWeight:
    """Quantize a float weight (K, N) per ``cfg`` and pack W^T along K."""
    k, n = w.shape
    codes, scale = weight_quant(w, cfg, axis=0)        # codes (K, N), scale (1, N)
    scale = scale.reshape(n)
    ct = codes.T.contiguous()                          # (N, K)
    if cfg.w_mode == W_BINARY:
        if k % 32 == 0:
            return PackedWeight(packing.pack_binary_pm1(ct), scale, 1, W_BINARY, k)
        return PackedWeight(ct, scale, 1, W_BINARY, k)
    bits = weight_bits(cfg)
    if cfg.pack_weights and 32 % bits == 0 and k % (32 // bits) == 0:
        return PackedWeight(packing.pack(ct, bits), scale, bits, cfg.w_mode, k)
    return PackedWeight(ct, scale, bits, cfg.w_mode, k)   # unpacked int8 fallback


def as_packed_weight(p: dict, cfg: PrecisionConfig) -> PackedWeight:
    """View a serving param dict ``{"wt_packed", "scale"}`` (models/convert
    output) as a :class:`PackedWeight`."""
    wt = p["wt_packed"]
    bits = weight_bits(cfg)
    k = wt.shape[-1] * (32 // bits) if wt.dtype == torch.int32 else wt.shape[-1]
    return PackedWeight(wt, p["scale"], bits, cfg.w_mode, k)


def storage_kind(pw: PackedWeight) -> str:
    if pw.wt_packed.dtype != torch.int32:
        return K_CODES
    return pw.mode


def hbm_bytes(pw: PackedWeight) -> int:
    """Weight bytes as resident in device memory."""
    return pw.wt_packed.numel() * pw.wt_packed.element_size()


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
KernelKey = tuple[str, int, int, str]        # (weight_kind, act_bits, weight_bits, backend)
_REGISTRY: dict[KernelKey, Callable] = {}

ACT_BITS_RANGE = range(0, 9)                 # 0 == float activations


def register_kernel(weight_kind: str, act_bits, w_bits, backend: str):
    """Decorator registering an implementation for one or more keys;
    ``act_bits`` / ``w_bits`` may be ints or iterables of ints."""
    a_list = (act_bits,) if isinstance(act_bits, int) else tuple(act_bits)
    w_list = (w_bits,) if isinstance(w_bits, int) else tuple(w_bits)

    def deco(fn):
        for a in a_list:
            for w in w_list:
                _REGISTRY[(weight_kind, a, w, backend)] = fn
        return fn
    return deco


def resolve_entry(weight_kind: str, act_bits: int, w_bits: int,
                  backend: str) -> tuple[Callable, KernelKey]:
    """Exact key first, then the plain ``torch`` backend (kinds that have
    no CUDA kernel).  Returns ``(fn, matched_key)``."""
    for key in ((weight_kind, act_bits, w_bits, backend),
                (weight_kind, act_bits, w_bits, BACKEND_TORCH)):
        fn = _REGISTRY.get(key)
        if fn is not None:
            return fn, key
    raise KeyError(
        f"no kernel for (weight_kind={weight_kind!r}, act_bits={act_bits}, "
        f"weight_bits={w_bits}, backend={backend!r}); registered: "
        f"{sorted(set((k[0], k[3]) for k in _REGISTRY))}")


def resolve(weight_kind: str, act_bits: int, w_bits: int,
            backend: str) -> Callable:
    return resolve_entry(weight_kind, act_bits, w_bits, backend)[0]


def available_kernels() -> dict[KernelKey, str]:
    return {k: fn.__name__ for k, fn in sorted(_REGISTRY.items())}


def on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, and inside :func:`trace_as_card` for a meta
    tensor (the dry run's stand-in for the card's)."""
    return t.is_cuda or (_AS_CARD[0] and t.is_meta)


def default_backend(t: torch.Tensor) -> str:
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    return BACKEND_CUDA if on_card(t) else BACKEND_TORCH


def _check_backend(backend: str | None, t: torch.Tensor) -> str:
    """The backend for an input on ``t``'s device: the device decides when
    ``backend`` is None; ``"cuda"`` is refused for a host tensor, so a
    dispatch recorded as ``cuda`` always ran on the card (or, in a dry
    run, stood in for a launch on it)."""
    backend = backend or default_backend(t)
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; known: {BACKENDS}")
    if backend == BACKEND_CUDA and not on_card(t):
        raise ValueError(f"backend='cuda' needs CUDA tensors, got one on "
                         f"{t.device} (pass backend='torch' or None)")
    return backend


# ---------------------------------------------------------------------------
# dispatch trace + launch counts
# ---------------------------------------------------------------------------
class DispatchEvent(NamedTuple):
    """One engine dispatch.  ``impl_backend`` is the registry key that
    matched (``torch`` when the kind has no CUDA kernel); ``a_scale_shape``
    is the per-row activation scale's shape (None for float/pre-quantized
    inputs); ``block`` the tuning cache's choice that ran (a packed kernel's
    tile, or B5's plan; None for the automatic plan and for dispatches
    that choose nothing)."""
    op: str                     # "qmatmul" | "qmatmul_experts" |
                                # "ssm_scan" | "act_quant_signed_grouped" |
                                # "decode_attention" | "paged_attention" |
                                # "fused_paged_decode" | "flash_attention"
    kind: str                   # storage kind / attn kind
    requested_backend: str
    impl_backend: str
    a_bits: int                 # act bits (matmul) / kv_bits (attention)
    w_bits: int
    m_rows: int
    a_scale_shape: tuple[int, ...] | None
    block: tuple[int, int, int] | None = None


_DISPATCH_SINK: list | None = None
_DISPATCH_LISTENER: Callable | None = None


@contextlib.contextmanager
def dispatch_trace():
    """Collect every :class:`DispatchEvent` the engine emits inside this
    context.  Nesting restores the previous sink on exit."""
    global _DISPATCH_SINK
    prev, _DISPATCH_SINK = _DISPATCH_SINK, []
    try:
        yield _DISPATCH_SINK
    finally:
        _DISPATCH_SINK = prev


def set_dispatch_listener(cb) -> None:
    """Install a persistent :class:`DispatchEvent` observer (or ``None`` to
    remove it).  Unlike :func:`dispatch_trace`, the listener survives across
    calls: the serving flight recorder (:mod:`repro_torch.runtime.tracing`)
    uses it to put kernel dispatches on the serving timeline.  Eager
    dispatches fire on every call, so the listener sees every one (the
    tracer keeps only the first of each distinct event)."""
    global _DISPATCH_LISTENER
    _DISPATCH_LISTENER = cb


_ACTIVE: list[DispatchEvent] = []     # the dispatches whose work is running
_UNRECORDED = contextlib.nullcontext()


class _Active:
    """Marks its event as running for the ``with`` block of the work."""

    def __init__(self, ev: DispatchEvent):
        self.ev = ev

    def __enter__(self):
        _ACTIVE.append(self.ev)

    def __exit__(self, *exc):
        _ACTIVE.pop()


def active_dispatch() -> DispatchEvent | None:
    """The innermost recorded dispatch whose work is running now (the
    ``with`` block of its dispatch site), else None.  The auditor's op
    walker reads it to attribute an op to the dispatch it ran in."""
    return _ACTIVE[-1] if _ACTIVE else None


def _record_dispatch(**kw):
    """Emit one :class:`DispatchEvent`; returns a context manager for the
    dispatch's work (``with _record_dispatch(...): fn(...)``), during which
    :func:`active_dispatch` names the event.  With nothing recording, a
    shared no-op context."""
    if _DISPATCH_SINK is None and _DISPATCH_LISTENER is None:
        return _UNRECORDED
    ev = DispatchEvent(**kw)
    if _DISPATCH_SINK is not None:
        _DISPATCH_SINK.append(ev)
    if _DISPATCH_LISTENER is not None:
        _DISPATCH_LISTENER(ev)
    return _Active(ev)


def launch_counts() -> dict[str, int]:
    """CUDA kernel launches since the last :func:`reset_launch_counts`, per
    kernel (each wrapper counts where it launches, and nowhere else)."""
    return {name: _build.LAUNCHES[name] for name in KERNELS}


def reset_launch_counts() -> None:
    _build.LAUNCHES.clear()


# ---------------------------------------------------------------------------
# the dry run's stand-in for a launch (meta tensors)
# ---------------------------------------------------------------------------
_TRACED: dict[str, list[int]] = {}     # kernel -> [launches, flops, bytes]
_AS_CARD = [False]


@contextlib.contextmanager
def trace_as_card():
    """Inside: ``meta`` tensors take the card's routes (:func:`on_card`),
    each kernel's launch stood in for (the dry run).  Tensors with data
    are not affected."""
    prev, _AS_CARD[0] = _AS_CARD[0], True
    try:
        yield
    finally:
        _AS_CARD[0] = prev


def _traced(name: str, work: tuple[int, int], *outs):
    """Count one traced launch of kernel ``name`` and its (flops, bytes);
    returns ``outs`` (one tensor, or a tuple of several)."""
    rec = _TRACED.setdefault(name, [0, 0, 0])
    rec[0] += 1
    rec[1] += int(work[0])
    rec[2] += int(work[1])
    return outs[0] if len(outs) == 1 else outs


def traced_work() -> dict[str, dict[str, int]]:
    """The launches a trace on meta tensors stood in for since the last
    :func:`reset_traced_work`, by kernel: ``launches``, ``flops`` and
    ``bytes`` (:mod:`.costs`)."""
    return {name: dict(zip(("launches", "flops", "bytes"), rec))
            for name, rec in sorted(_TRACED.items())}


def reset_traced_work() -> None:
    _TRACED.clear()


def _empty(shape, dtype, like: torch.Tensor) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=like.device)


# ---------------------------------------------------------------------------
# implementations.  Signature:
#     fn(x, pw, scale, bias, *, out_dtype, a_scale=None, block=None) -> (M, N)
# ``x`` is prepared by qmatmul (int8 codes or float); ``scale`` is the (N,)
# weight scale; ``a_scale`` the (M, 1) per-row activation scale (None for
# float/pre-quantized inputs); ``block`` the compiled kernel to run (a tile
# of .tuning; None: the automatic choice; the plain versions ignore it).
# Epilogue order everywhere: acc * w_scale * a_scale + bias -> out_dtype.
# ---------------------------------------------------------------------------
def _row_epilogue(out, a_scale, bias, out_dtype):
    """Per-row dequant applied after the kernel, with the bias held out of
    the kernel so the order matches the plain versions."""
    out = out * a_scale
    if bias is not None:
        out = out + bias[None, :]
    return out.to(out_dtype)


def _kernel_call(kernel, x, pw, scale, bias, out_dtype, a_scale, block,
                 **kw):
    if x.is_meta:
        m, n = x.shape[0], scale.shape[0]
        work = costs.binary_matmul(m, n, pw.k) if kernel is binary_matmul \
            else costs.qmatmul(m, n, pw.k, pw.bits, x.element_size())
        out = _traced(kernel.__name__, work,
                      _empty((m, n), torch.float32, x))
    else:
        out = kernel(x.contiguous(), pw.wt_packed, scale,
                     bias if a_scale is None else None, block=block, **kw)
    if a_scale is not None:
        return _row_epilogue(out, a_scale, bias, out_dtype)
    return out.to(out_dtype)


@register_kernel(W_INT, ACT_BITS_RANGE, (2, 4, 8), BACKEND_CUDA)
def _int_packed_cuda(x, pw, scale, bias, *, out_dtype, a_scale=None,
                     block=None):
    return _kernel_call(packed_matmul, x, pw, scale, bias, out_dtype, a_scale,
                        block, bits=pw.bits)


@register_kernel(W_INT, ACT_BITS_RANGE, tuple(range(1, 9)), BACKEND_TORCH)
def _int_packed_torch(x, pw, scale, bias, *, out_dtype, a_scale=None,
                      block=None):
    return ref.packed_matmul_ref(x, pw.wt_packed, scale, pw.bits, bias=bias,
                                 out_dtype=out_dtype, row_scale=a_scale)


@register_kernel(W_TERNARY, ACT_BITS_RANGE, 2, BACKEND_CUDA)
def _ternary_cuda(x, pw, scale, bias, *, out_dtype, a_scale=None,
                  block=None):
    return _kernel_call(ternary_matmul, x, pw, scale, bias, out_dtype, a_scale,
                        block)


@register_kernel(W_TERNARY, ACT_BITS_RANGE, 2, BACKEND_TORCH)
def _ternary_torch(x, pw, scale, bias, *, out_dtype, a_scale=None,
                   block=None):
    return ref.ternary_matmul_ref(x, pw.wt_packed, scale, bias=bias,
                                  out_dtype=out_dtype, row_scale=a_scale)


def _dequant_dot(x, codes, scale, bias, out_dtype, a_scale):
    """``x @ codes^T * scale (* a_scale) (+ bias)`` on unpacked int8 codes:
    exact integer accumulation for integer x (see ``ref.int_dot``)."""
    if not x.is_floating_point():
        acc = ref.int_dot(x, codes).to(torch.float32)
    else:
        acc = x.to(torch.float32) @ codes.to(torch.float32).T
    out = acc * scale[None, :]
    if a_scale is not None:
        out = out * a_scale
    if bias is not None:
        out = out + bias[None, :]
    return out.to(out_dtype)


@register_kernel(W_BINARY, 1, 1, BACKEND_CUDA)
def _binary_xnor_cuda(x, pw, scale, bias, *, out_dtype, a_scale=None,
                      block=None):
    """x: (M, K/32) int32 +/-1 bits.  The XNOR + popcount kernel; the bias
    goes into the kernel only when no per-row scale follows."""
    return _kernel_call(binary_matmul, x, pw, scale, bias, out_dtype, a_scale,
                        block, k=pw.k)


@register_kernel(W_BINARY, 1, 1, BACKEND_TORCH)
def _binary_xnor_torch(x, pw, scale, bias, *, out_dtype, a_scale=None,
                       block=None):
    out = ref.binary_matmul_ref(x, pw.wt_packed, pw.k, alpha=scale,
                                row_scale=a_scale)
    if bias is not None:
        out = out + bias[None, :]
    return out.to(out_dtype)


@register_kernel(W_BINARY, tuple(a for a in ACT_BITS_RANGE if a != 1), 1,
                 BACKEND_TORCH)
def _binary_dequant_torch(x, pw, scale, bias, *, out_dtype, a_scale=None,
                          block=None):
    """Binary weights with multi-bit/float activations (8xB): decode the
    +/-1 codes and run the plain dot — no XNOR trick applies.  Activations
    that come pre-packed as int32 +/-1 bits take the XNOR semantics."""
    if x.dtype == torch.int32:
        return _binary_xnor_torch(x, pw, scale, bias, out_dtype=out_dtype,
                                  a_scale=a_scale)
    codes = packing.unpack_binary_pm1(pw.wt_packed)            # (N, K) int8
    return _dequant_dot(x, codes, scale, bias, out_dtype, a_scale)


@register_kernel(K_CODES, ACT_BITS_RANGE, tuple(range(1, 9)), BACKEND_TORCH)
def _codes_torch(x, pw, scale, bias, *, out_dtype, a_scale=None,
                 block=None):
    """Unpacked int8 codes storage (3-bit / misaligned K)."""
    return _dequant_dot(x, pw.wt_packed, scale, bias, out_dtype, a_scale)


# ---------------------------------------------------------------------------
# activation preparation
# ---------------------------------------------------------------------------
def _prep_activations(x2: torch.Tensor, pw: PackedWeight, a_bits: int,
                      backend: str):
    """Returns (x_prepped, a_scale or None).  Integer inputs are taken as
    ready-made codes (the caller owns their scale); float inputs are
    quantized symmetric PER ROW: each row's codes and scale depend only on
    that row, so any batch shape gives the same values.  a_scale is (M, 1).
    a_scale is ``max(amax|x[row]|, 1e-8) / qmax`` and the codes are
    ``clip(round(x / a_scale), +-qmax)``, both in the rows' dtype: one
    launch of the row form of the ``act_quant_signed_grouped`` kernel
    (scale and codes together) for the ``cuda`` backend, its plain version
    for ``torch``.

    At 1 bit the codes are the signs (x >= 0 -> +1) with a_scale = mean|x|
    of the row; they are bit-packed for the XNOR kernel only when the
    weights are packed too (int32 storage): the unaligned-K binary fallback
    stores int8 +/-1 codes, which feed the plain integer dot directly."""
    xnor = pw.mode == W_BINARY and pw.wt_packed.dtype == torch.int32
    if not x2.is_floating_point():
        if xnor and a_bits == 1 and x2.dtype != torch.int32:
            return packing.pack_binary_pm1(x2), None
        return x2, None
    if a_bits == 0:
        return x2, None
    if a_bits == 1:
        a_scale = x2.abs().mean(dim=1, keepdim=True).clamp_min(1e-8)
        xq = torch.where(x2 >= 0, 1, -1).to(torch.int8)
        return (packing.pack_binary_pm1(xq) if xnor else xq), a_scale
    bits = min(a_bits, 8)
    if backend == BACKEND_TORCH:
        return ref.act_quant_signed_rows_ref(x2, bits)
    m = int(x2.shape[0])
    with _record_dispatch(op="act_quant_signed_grouped",
                          kind="signed_grouped", requested_backend=backend,
                          impl_backend=backend, a_bits=bits, w_bits=0,
                          m_rows=m, a_scale_shape=(m, 1)):
        if x2.is_meta:
            return _traced("act_quant_signed_grouped", costs.act_quant_rows(
                m, x2.shape[1], x2.element_size()),
                _empty(x2.shape, torch.int8, x2),
                _empty((m, 1), x2.dtype, x2))
        return act_quant_signed_rows(x2.contiguous(), bits=bits)


def _prep_split_activations(x2: torch.Tensor, pw: PackedWeight, a_bits: int,
                            backend: str, reduce):
    """:func:`_prep_activations` for rows whose K axis is split over the
    ranks of ``reduce`` (a row-parallel projection's input): each row's
    scale is the whole row's, from this rank's columns and the others'.

    ``amax`` is local, then an all-reduce max (exact), then ``max(amax,
    1e-8) / qmax`` as the row form computes it, and the codes come from the
    given-scale form of the same kernel (``act_quant_signed_grouped`` with
    one group), which divides as the row form does: the codes equal the row
    form's on the whole row.  At 1 bit the row scale ``mean|x|`` is a local
    float32 sum, an all-reduce sum and one division, which rounds as the
    one-rank mean only up to the order of the sum."""
    if not x2.is_floating_point() or a_bits == 0:
        return _prep_activations(x2, pw, a_bits, backend)
    if a_bits == 1:
        total = reduce.all_reduce_sum(
            x2.abs().to(torch.float32).sum(dim=1, keepdim=True))
        a_scale = (total / (x2.shape[1] * reduce.size)).to(x2.dtype
                                                           ).clamp_min(1e-8)
        xnor = pw.mode == W_BINARY and pw.wt_packed.dtype == torch.int32
        xq = torch.where(x2 >= 0, 1, -1).to(torch.int8)
        return (packing.pack_binary_pm1(xq) if xnor else xq), a_scale
    bits = min(a_bits, 8)
    qmax = (1 << (bits - 1)) - 1
    amax = reduce.all_reduce_max(x2.abs().amax(dim=1, keepdim=True))
    a_scale = true_div(amax.clamp_min(1e-8), qmax)
    if backend == BACKEND_TORCH:
        return ref.act_quant_signed_grouped_ref(
            x2, bits, a_scale, compute_dtype=x2.dtype), a_scale
    with _record_dispatch(op="act_quant_signed_grouped",
                          kind="signed_grouped", requested_backend=backend,
                          impl_backend=backend, a_bits=bits, w_bits=0,
                          m_rows=int(x2.shape[0]),
                          a_scale_shape=tuple(a_scale.shape)):
        if x2.is_meta:
            xq = _traced("act_quant_signed_grouped", costs.act_quant_rows(
                x2.shape[0], x2.shape[1], x2.element_size()),
                _empty(x2.shape, torch.int8, x2))
        else:
            xq = act_quant_signed_grouped(x2.contiguous(),
                                          a_scale.contiguous(), bits=bits,
                                          compute_dtype=x2.dtype)
    return xq, a_scale


# ---------------------------------------------------------------------------
# the single public dispatch point
# ---------------------------------------------------------------------------
def qmatmul(x: torch.Tensor, pw: PackedWeight, cfg: PrecisionConfig, *,
            bias=None, out_dtype=torch.float32,
            backend: str | None = None,
            block: tuple[int, int, int] | None = None,
            reduce=None) -> torch.Tensor:
    """``x @ W`` with quantized/packed ``W`` under ``cfg``.

    x       : (..., K) float activations, int8 codes, or (binary) int32
              +/-1 bits; leading dims are flattened and restored.
    pw      : :func:`pack_weight` / :func:`as_packed_weight` output.
    backend : "cuda" | "torch"; None picks by the device of ``x``.
    block   : the compiled kernel to run, by its tile (a sweep measures
              this way); None consults the tuning cache where a CUDA kernel
              runs integer codes or bits (a miss: the automatic choice,
              never a sweep).  The plain versions ignore it.
    reduce  : a row-parallel projection's model axis
              (:class:`repro_torch.parallel.comm.Axis`): ``x`` and ``pw``
              hold this rank's slice of K.  The rows are quantized at the
              whole row's scale (:func:`_prep_split_activations`), the
              kernel runs with weight scale 1 and no bias into f32
              accumulators (integers, exact below 2**24), those are
              all-reduced, and the epilogue ``acc * w_scale * a_scale +
              bias`` runs once, in the one-rank order: integer activations
              give the one-rank result bit for bit.
    """
    if cfg.w_mode == W_FLOAT:
        raise ValueError("qmatmul needs a quantized-weight config; "
                         "float weights are a plain matmul")
    backend = _check_backend(backend, x)
    a_bits = 0 if (cfg.a_mode == A_FLOAT or cfg.a_bits > 8) else cfg.a_bits
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    split = reduce is not None and reduce.size > 1
    if split:
        xq, a_scale = _prep_split_activations(x2, pw, a_bits, backend, reduce)
    else:
        xq, a_scale = _prep_activations(x2, pw, a_bits, backend)
    # weight scale (N,) and per-row act scale (M, 1) stay separate: folding
    # them would couple the epilogue to the batch
    scale = pw.scale.reshape(-1).to(torch.float32)
    kind = storage_kind(pw)
    fn, matched = resolve_entry(kind, a_bits, pw.bits, backend)
    if block is None and matched[3] == BACKEND_CUDA \
            and not xq.is_floating_point():
        block = tuning.get_block_sizes(
            x2.shape[0], int(scale.shape[0]), pw.k, kind=kind, a_bits=a_bits,
            w_bits=pw.bits, backend=backend)
    with _record_dispatch(op="qmatmul", kind=kind, requested_backend=backend,
                          impl_backend=matched[3], a_bits=a_bits,
                          w_bits=pw.bits, m_rows=int(x2.shape[0]),
                          a_scale_shape=(None if a_scale is None
                                         else tuple(a_scale.shape)),
                          block=None if block is None else tuple(block)):
        if split:
            acc = reduce.all_reduce_sum(fn(
                xq, pw, torch.ones_like(scale), None,
                out_dtype=torch.float32, a_scale=None, block=block))
            out = acc * scale[None, :]
            if a_scale is not None:
                out = out * a_scale
            if bias is not None:
                out = out + bias[None, :]
            out = out.to(out_dtype)
        else:
            out = fn(xq, pw, scale, bias, out_dtype=out_dtype,
                     a_scale=a_scale, block=block)
    return out.reshape(*lead, out.shape[-1])


def qmatmul_experts(x: torch.Tensor, p: dict, cfg: PrecisionConfig, *,
                    backend: str | None = None) -> torch.Tensor:
    """Per-expert serving matmul: x (E, C, K) @ W_e (K, N) with the experts'
    packed storage ``{"wt_packed": (E, N, KW), "scale": (E, N)}``.

    The words are unpacked (signed k-bit fields, or +/-1 at 1 bit; int8
    codes are taken as they are), then one f32 einsum over every expert and
    the per-channel scale.  The activations are not quantized: expert
    buffers are gathered rows, and per-expert scales would change the
    routing semantics.  The reference computes this product outside any
    Pallas kernel, so it is plain PyTorch on every device, and the dispatch
    trace says so (``impl_backend="torch"``)."""
    backend = _check_backend(backend, x)
    wt = p["wt_packed"]
    bits = weight_bits(cfg)
    if wt.dtype == torch.int32:
        codes = (packing.unpack_binary_pm1(wt) if cfg.w_mode == W_BINARY
                 else packing.unpack(wt, bits, signed=True))       # (E, N, K)
    else:
        codes = wt                                                 # int8 codes
    with _record_dispatch(
            op="qmatmul_experts",
            kind=cfg.w_mode if wt.dtype == torch.int32 else K_CODES,
            requested_backend=backend, impl_backend=BACKEND_TORCH, a_bits=0,
            w_bits=bits, m_rows=int(x.shape[0] * x.shape[1]),
            a_scale_shape=None):
        acc = torch.einsum("eck,enk->ecn", x.to(torch.float32),
                           codes.to(torch.float32))
        return (acc * p["scale"][:, None, :]).to(x.dtype)


def record_plain(op: str, kind: str, x: torch.Tensor,
                 backend: str | None = None):
    """Record a dispatch that runs plain PyTorch on every device by the
    reference's design (the Mamba layer's selective scan, ``op``
    "ssm_scan"; full-sequence attention under autograd, ``op``
    "flash_attention"): ``impl_backend="torch"`` whatever was requested, so the
    trace shows the plain piece on the card.  ``x`` gives the device and
    the rows (all but its last axis).  Use it as ``with record_plain(...):``
    around the plain work, as the engine's own dispatch sites do."""
    return _record_dispatch(op=op, kind=kind,
                            requested_backend=_check_backend(backend, x),
                            impl_backend=BACKEND_TORCH, a_bits=0, w_bits=0,
                            m_rows=int(x.numel() // x.shape[-1]),
                            a_scale_shape=None)


def fake_quant_dot(x: torch.Tensor, w: torch.Tensor, cfg: PrecisionConfig, *,
                   axis=0, reduce=None) -> torch.Tensor:
    """QAT-form ``x @ fake_quant(w)`` — the float counterpart of
    :func:`qmatmul`: a float matmul of STE-quantized weights, whose
    gradient reaches ``w`` as the identity (plain PyTorch on every
    device, as the reference's jnp form).  ``reduce``: the mesh axis
    ``w``'s K is split over (a row-parallel projection's partial product;
    the caller sums it), whose statistics the quantizer takes whole."""
    if cfg.w_mode == W_FLOAT:
        return x @ w.to(x.dtype)
    wq = weight_fake_quant(w.to(torch.float32), cfg, axis=axis,
                           reduce=reduce).to(x.dtype)
    return x @ wq


# ---------------------------------------------------------------------------
# attention-kernel registry (serving decode hot path)
# ---------------------------------------------------------------------------
# keyed on (attn_kind, kv_bits, backend); resolution falls back to the
# ``torch`` backend like the matmul registry.  The torch registration
# reproduces the model's in-layer math op-for-op (dequant to the model
# dtype); the dense kv_bits=4 cache has no kernel on either package's
# accelerator, the paged kernels take kv 16/8/4.
ATTN_DECODE = "decode"
ATTN_PAGED = "paged"
ATTN_FUSED = "fused_decode"
AttnKey = tuple[str, int, str]
_ATTN_REGISTRY: dict[AttnKey, Callable] = {}


def register_attention(kind: str, kv_bits, backend: str):
    b_list = (kv_bits,) if isinstance(kv_bits, int) else tuple(kv_bits)

    def deco(fn):
        for b in b_list:
            _ATTN_REGISTRY[(kind, b, backend)] = fn
        return fn
    return deco


def resolve_attention_entry(kind: str, kv_bits: int,
                            backend: str) -> tuple[Callable, AttnKey]:
    for key in ((kind, kv_bits, backend), (kind, kv_bits, BACKEND_TORCH)):
        fn = _ATTN_REGISTRY.get(key)
        if fn is not None:
            return fn, key
    raise KeyError(
        f"no attention kernel for (kind={kind!r}, kv_bits={kv_bits}, "
        f"backend={backend!r}); registered: {sorted(_ATTN_REGISTRY)}")


@register_attention(ATTN_DECODE, (8, 4), BACKEND_TORCH)
def _decode_attn_torch(q, k, ks, v, vs, pos, *, kv_bits, dtype, block=None,
                       lse=False):
    return decode_attention_serving_ref(q, k, ks, v, vs, pos,
                                        kv_bits=kv_bits, dtype=dtype, lse=lse)


@register_attention(ATTN_DECODE, 8, BACKEND_CUDA)
def _decode_attn_cuda(q, k, ks, v, vs, pos, *, kv_bits, dtype, block=None,
                      lse=False):
    if q.is_meta:
        b, kv, g, dh = q.shape
        work = costs.decode_attention(b, k.shape[1], kv, g, dh,
                                      q.element_size(), lse)
        if lse:
            return _traced("decode_attention", work,
                           _empty(q.shape, torch.float32, q),
                           _empty((b, kv, g), torch.float32, q))
        return _traced("decode_attention", work, _empty(q.shape, dtype, q))
    plan = None if block is None else (block[0], block[2])
    out = _decode_attention_kernel(q.contiguous(), k, ks, v, vs, pos,
                                   plan=plan, lse=lse)
    return out if lse else out.to(dtype)


def decode_attention(q, k_codes, k_scale, v_codes, v_scale, pos, *,
                     kv_bits: int = 8, dtype=torch.float32,
                     backend: str | None = None, lse: bool = False):
    """One-step dense-cache decode attention via the registry.

    q: (B, KV, G, Dh); codes (B, S, KV, Dh'); scales (B, S, KV, 1);
    pos scalar or (B,).  Returns (B, KV, G, Dh) in ``dtype``; with ``lse``
    (a sequence-parallel step's partial) the output in float32 and the
    (B, KV, G) float32 log-sum-exp of each head's masked scores (-inf, and
    a zero output, where no position <= pos is in the cache).  The kernel
    reads its launch plan from the tuning cache
    (:func:`autotune_decode_attention` sweeps it offline; a miss runs the
    automatic plan)."""
    backend = _check_backend(backend, q)
    fn, matched = resolve_attention_entry(ATTN_DECODE, kv_bits, backend)
    block = None
    if matched[2] == BACKEND_CUDA:
        b, _, g, dh = q.shape
        block = tuning.resolve(b * g, dh, k_codes.shape[1],
                               kind=tuning.ATTN_DECODE, a_bits=kv_bits,
                               w_bits=8, backend=backend)
    with _record_dispatch(op="decode_attention", kind=ATTN_DECODE,
                          requested_backend=backend, impl_backend=matched[2],
                          a_bits=kv_bits, w_bits=8, m_rows=int(q.shape[0]),
                          a_scale_shape=None, block=block):
        # the lse keyword only when asked: an entry may take no such option
        return fn(q, k_codes, k_scale, v_codes, v_scale, pos,
                  kv_bits=kv_bits, dtype=dtype, block=block,
                  **({"lse": True} if lse else {}))


@register_attention(ATTN_PAGED, (16, 8, 4), BACKEND_TORCH)
def _paged_attn_torch(q, k, ks, v, vs, pt_pos, *, kv_bits, dtype):
    page_table, pos = pt_pos
    return paged_attention_ref(q, k, ks, v, vs, page_table, pos,
                               kv_bits=kv_bits, out_dtype=dtype)


def _paged_work(q, k, ks, page_table) -> tuple[int, int]:
    """B2's work for ``q``'s rows over every position of their page-table
    rows (:func:`costs.paged_attention`)."""
    rows, kv, g, dh = q.shape
    return costs.paged_attention(
        rows, page_table.shape[1] * k.shape[1], kv, g, dh, q.element_size(),
        k.shape[-1] * k.element_size(), ks is not None, page_table.numel())


@register_attention(ATTN_PAGED, (16, 8, 4), BACKEND_CUDA)
def _paged_attn_cuda(q, k, ks, v, vs, pt_pos, *, kv_bits, dtype):
    page_table, pos = pt_pos
    if q.is_meta:
        return _traced("paged_attention", _paged_work(q, k, ks, page_table),
                       _empty(q.shape, dtype, q))
    return _paged_attention_kernel(q.contiguous(), k, ks, v, vs, page_table,
                                   pos, kv_bits=kv_bits).to(dtype)


def paged_attention(q, k_pool, k_scale, v_pool, v_scale, page_table, pos, *,
                    kv_bits: int = 8, dtype=torch.float32,
                    backend: str | None = None) -> torch.Tensor:
    """One-step paged decode attention (block pool + page table) via the
    registry.  Pool leaves (NB, bs, KV, Dh'); page_table (B, n_blocks)
    int32; pos (B,).  Returns (B, KV, G, Dh) in ``dtype``."""
    backend = _check_backend(backend, q)
    fn, matched = resolve_attention_entry(ATTN_PAGED, kv_bits, backend)
    with _record_dispatch(op="paged_attention", kind=ATTN_PAGED,
                          requested_backend=backend, impl_backend=matched[2],
                          a_bits=kv_bits, w_bits=8, m_rows=int(q.shape[0]),
                          a_scale_shape=None):
        return fn(q, k_pool, k_scale, v_pool, v_scale, (page_table, pos),
                  kv_bits=kv_bits, dtype=dtype)


# ---------------------------------------------------------------------------
# full-sequence causal attention (whole-prompt prefill, forward)
# ---------------------------------------------------------------------------
ATTN_FLASH = "flash"
# the dispatch kind of a flash_attention call with probs_bf16 (the same
# registry entries, the kernels' bf16-probabilities flag)
ATTN_FLASH_PROBS_BF16 = "flash_probs_bf16"


@register_attention(ATTN_FLASH, 16, BACKEND_TORCH)
def _flash_attn_torch(q, k, v, *, causal, window, softcap, probs_bf16):
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, probs_bf16=probs_bf16)


@register_attention(ATTN_FLASH, 16, BACKEND_CUDA)
def _flash_attn_cuda(q, k, v, *, causal, window, softcap, probs_bf16):
    if q.is_meta:
        b, sq, kv, g, dh = q.shape
        return _traced("flash_attention", costs.flash_attention(
            b, sq, k.shape[1], kv, g, dh, q.element_size(), causal, window),
            _empty(q.shape, torch.float32, q))
    return _flash_attention_kernel(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=causal,
                                   window=window, softcap=softcap,
                                   probs_bf16=probs_bf16)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, probs_bf16: bool = False,
                    backend: str | None = None) -> torch.Tensor:
    """Full-sequence attention via the registry, query and key positions
    both counted from 0 (prefill and forward, never a chunk at an offset):
    q (B, Sq, KV, G, Dh), k/v (B, Sk, KV, Dh) in the model dtype, causal,
    sliding-window (``window`` > 0) and tanh-softcap (``softcap`` > 0)
    masks, f32 softmax; with ``probs_bf16`` P.V from P and V rounded to
    bf16, in f32 (dispatch kind ``ATTN_FLASH_PROBS_BF16``).  Returns
    (B, Sq, KV, G, Dh) float32."""
    backend = _check_backend(backend, q)
    fn, matched = resolve_attention_entry(ATTN_FLASH, 16, backend)
    kind = ATTN_FLASH_PROBS_BF16 if probs_bf16 else ATTN_FLASH
    with _record_dispatch(op="flash_attention", kind=kind,
                          requested_backend=backend, impl_backend=matched[2],
                          a_bits=16, w_bits=16,
                          m_rows=int(q.shape[0] * q.shape[1]),
                          a_scale_shape=None):
        return fn(q, k, v, causal=causal, window=window, softcap=softcap,
                  probs_bf16=probs_bf16)


# ---------------------------------------------------------------------------
# fused ragged decode: paged attention + output projection, live slots only
# ---------------------------------------------------------------------------
def _project_wo(x, wo_p: dict, pcfg: PrecisionConfig, model_dtype, backend,
                reduce=None):
    """The decode output projection, op for op as the model's
    ``qlinear_apply(p["wo"], x, cfg)``: packed serving weights go through
    :func:`qmatmul` (per-row activation scales, so a gathered sub-batch
    gives the padded batch's rows), float weights of a float config are a
    plain matmul, and float weights of a quantized config (a QAT
    checkpoint before ``to_serving``) take the fake-quant form: the
    activations fake-quantized with one absmax scale over the whole call,
    times :func:`fake_quant_dot`.  With ``reduce`` (the model axis; ``x``
    and ``wo`` hold this rank's heads) the projection is row-parallel:
    :func:`qmatmul`'s split form, or the float partial products summed over
    the axis in f32."""
    if "wt_packed" in wo_p:
        pw = as_packed_weight(wo_p, pcfg)
        return qmatmul(x, pw, pcfg, backend=backend,
                       reduce=reduce).to(model_dtype)
    if pcfg.w_mode == W_FLOAT:
        out = x @ wo_p["qw"].to(x.dtype)
        return out if reduce is None else \
            reduce.all_reduce_sum(out.to(torch.float32)).to(x.dtype)
    if reduce is not None and reduce.size > 1:
        raise ValueError("a row-parallel fake-quant (QAT) projection: serve "
                         "the packed form (to_serving) over a mesh")
    if pcfg.a_mode != A_FLOAT:
        x = act_fake_quant(x.to(torch.float32), pcfg).to(x.dtype)
    return fake_quant_dot(x, wo_p["qw"], pcfg, axis=0)


def _wo_is_float(wo_p: dict, pcfg: PrecisionConfig) -> bool:
    return "wt_packed" not in wo_p and pcfg.w_mode == W_FLOAT


def _live_rows(q, page_table, pos, slot_map):
    sm = slot_map.long()
    return q[sm], page_table[sm], _pos_vector(pos, q.shape[0], q.device)[sm]


@register_attention(ATTN_FUSED, (16, 8, 4), BACKEND_TORCH)
def _fused_decode_torch(q, k, ks, v, vs, extras, *, kv_bits, dtype):
    """Reference composition: gather the live rows -> the paged-attention
    plain version in the model dtype -> the model's wo projection."""
    page_table, pos, slot_map, wo_p, pcfg, reduce = extras
    ql, ptl, posl = _live_rows(q, page_table, pos, slot_map)
    attn = paged_attention_ref(ql, k, ks, v, vs, ptl, posl, kv_bits=kv_bits,
                               out_dtype=dtype)
    flat = attn.reshape(ql.shape[0], 1, -1)              # (L, 1, KV*G*Dh)
    return _project_wo(flat, wo_p, pcfg, dtype, BACKEND_TORCH, reduce)


@register_attention(ATTN_FUSED, (16, 8, 4), BACKEND_CUDA)
def _fused_decode_cuda(q, k, ks, v, vs, extras, *, kv_bits, dtype):
    """One fused kernel launch for float ``wo``; a quantized ``wo``
    composes the paged-attention kernel with :func:`qmatmul`, so the
    per-row requantization of the projection's input never forks from the
    matmul the rest of the model uses (as the reference's Pallas entry)."""
    page_table, pos, slot_map, wo_p, pcfg, reduce = extras
    if not _wo_is_float(wo_p, pcfg):
        ql, ptl, posl = _live_rows(q, page_table, pos, slot_map)
        if q.is_meta:
            attn = _traced("paged_attention", _paged_work(ql, k, ks, ptl),
                           _empty(ql.shape, dtype, q))
        else:
            attn = _paged_attention_kernel(ql.contiguous(), k, ks, v, vs,
                                           ptl.contiguous(), posl,
                                           kv_bits=kv_bits).to(dtype)
        flat = attn.reshape(ql.shape[0], 1, -1)
        return _project_wo(flat, wo_p, pcfg, dtype, BACKEND_CUDA, reduce)
    if q.is_meta:
        rows, (_, kv, g, dh) = slot_map.shape[0], q.shape
        wo = wo_p["qw"]
        flops, nbytes = costs.fused_decode(
            rows, page_table.shape[1] * k.shape[1], kv, g, dh, wo.shape[-1],
            q.element_size(), k.shape[-1] * k.element_size(), ks is not None,
            rows * page_table.shape[1], wo.element_size())
        out = _traced("fused_decode", (flops, nbytes),
                      _empty((rows, wo.shape[-1]), torch.float32, q))
    else:
        out = _fused_decode_kernel(q.contiguous(), k, ks, v, vs, page_table,
                                   pos, slot_map, wo_p["qw"], kv_bits=kv_bits)
    if reduce is not None:
        # row-parallel wo: this rank's heads' partial (L, D) f32 sums
        out = reduce.all_reduce_sum(out.to(torch.float32))
    return out[:, None, :].to(dtype)                      # (L, 1, D)


def fused_paged_decode(q, k_pool, k_scale, v_pool, v_scale, page_table, pos,
                       slot_map, wo_p: dict, pcfg: PrecisionConfig, *,
                       kv_bits: int = 8, dtype=torch.float32,
                       backend: str | None = None,
                       reduce=None) -> torch.Tensor:
    """Fused ragged decode step via the registry: paged attention over the
    slots of ``slot_map`` ((L,) int32 into the padded batch; None = every
    slot) with the ``wo`` projection folded in.  Returns the padded
    (B, 1, D) output: live rows carry the projection, the other rows are
    zeros.  ``slot_map`` may repeat a slot (occupancy padding): duplicates
    compute identical rows, so the scatter writes identical values.

    ``reduce`` (the model axis of a tensor-parallel step: ``q``, the pool
    and ``wo``'s rows hold this rank's heads): ``wo`` stays inside B4 for
    float weights, whose partial (L, D) sums are all-reduced; a quantized
    ``wo`` is :func:`qmatmul`'s row-parallel split form after B2."""
    backend = _check_backend(backend, q)
    b = q.shape[0]
    if slot_map is None:
        slot_map = torch.arange(b, dtype=torch.int32, device=q.device)
    slot_map = torch.as_tensor(slot_map, dtype=torch.int32, device=q.device)
    fn, matched = resolve_attention_entry(ATTN_FUSED, kv_bits, backend)
    with _record_dispatch(op="fused_paged_decode", kind=ATTN_FUSED,
                          requested_backend=backend, impl_backend=matched[2],
                          a_bits=kv_bits, w_bits=8,
                          m_rows=int(slot_map.shape[0]), a_scale_shape=None):
        compact = fn(q, k_pool, k_scale, v_pool, v_scale,
                     (page_table, pos, slot_map, wo_p, pcfg, reduce),
                     kv_bits=kv_bits, dtype=dtype)         # (L, 1, D)
    out = torch.zeros((b, 1, compact.shape[-1]), dtype=compact.dtype,
                      device=q.device)
    out[slot_map.long()] = compact
    return out


# ---------------------------------------------------------------------------
# legacy entry point (pre-engine signature; the reference's raw-kernel tests)
# ---------------------------------------------------------------------------
def quantized_matmul(x, pw: PackedWeight, bias=None, *,
                     out_dtype=torch.float32, backend: str | None = None,
                     block: tuple[int, int, int] | None = None):
    """Pre-engine dispatch (kept for compatibility): binary weights always
    binarize the activations; ``block`` names the kernel to run (None: the
    automatic choice).  The reference's ``use_pallas``/``interpret`` become
    ``backend`` ("cuda" | "torch"; None picks by the device of ``x``).  New
    code should call :func:`qmatmul` with a :class:`PrecisionConfig`."""
    backend = _check_backend(backend, x)
    scale = pw.scale.reshape(-1).to(torch.float32)
    if storage_kind(pw) == K_CODES:
        return _codes_torch(x, pw, scale, bias, out_dtype=out_dtype)
    if pw.mode == W_BINARY:
        a_packed = packing.pack_binary_pm1(x) if x.dtype != torch.int32 else x
        return resolve(W_BINARY, 1, 1, backend)(
            a_packed, pw, scale, bias, out_dtype=out_dtype, block=block)
    return resolve(pw.mode, 8, pw.bits, backend)(
        x, pw, scale, bias, out_dtype=out_dtype, block=block)


# ---------------------------------------------------------------------------
# autotuning entry points: each sweeps the kernel on the card, or its plain
# version for device="cpu" (entries keyed "torch|...", which serving on the
# card never reads)
# ---------------------------------------------------------------------------
def _sweep_device(device) -> tuple[torch.device, str]:
    """The device a sweep runs on (default: the card) and its backend."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a sweep on the card needs a visible CUDA device "
                           "(pass device='cpu' to sweep the plain versions)")
    return dev, BACKEND_CUDA if dev.type == "cuda" else BACKEND_TORCH


def _act_bits(cfg: PrecisionConfig) -> int:
    return 0 if (cfg.a_mode == A_FLOAT or cfg.a_bits > 8) else cfg.a_bits


def _from_numpy(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(a).to(dev)


def autotune_matmul(cfg: PrecisionConfig, m: int, n: int, k: int, *,
                    device=None, candidates=None, iters: int = 2,
                    force: bool = False, seed: int = 0) -> dict:
    """Sweep the compiled kernels of one (M, N, K, precision) shape class
    (:func:`tuning.candidate_blocks`: the decode-rows kernel and the tensor
    cores), each timed through :func:`qmatmul` on integer codes (or packed
    bits at 1x1), and persist the winner.  Returns the cache entry."""
    dev, backend = _sweep_device(device)
    rng = np.random.default_rng(seed)
    pw = pack_weight(_from_numpy(rng.normal(size=(k, n)).astype(np.float32),
                                 dev), cfg)
    kind, a_bits = storage_kind(pw), _act_bits(cfg)
    if kind == K_CODES or a_bits == 0:
        raise ValueError(f"{cfg.name}: unpacked storage and float "
                         "activations run one kernel: nothing to tune")
    if a_bits == 1:
        x = _from_numpy(rng.choice([-1, 1], (m, k)).astype(np.int8), dev)
        if kind == W_BINARY:
            x = packing.pack_binary_pm1(x)        # the XNOR kernel's operand
    else:
        qmax = (1 << (a_bits - 1)) - 1
        x = _from_numpy(rng.integers(-qmax, qmax + 1, (m, k)).astype(np.int8),
                        dev)

    def measure(block):
        return tuning.time_fn(
            lambda: qmatmul(x, pw, cfg, backend=backend, block=block),
            iters=iters)

    return tuning.autotune(m, n, k, kind=kind, a_bits=a_bits, w_bits=pw.bits,
                           backend=backend, measure=measure,
                           candidates=candidates, force=force)


def _kv_cache(rng, shape, kv_bits: int, dev) -> tuple:
    """Random K/V storage of ``shape`` (.., KV, Dh) and its scales: int8
    codes (nibble pairs at kv4) with f32 scales, or f32 values at kv16."""
    if kv_bits == 16:
        mk = lambda: _from_numpy(rng.normal(size=shape).astype(np.float32),
                                 dev)
        return mk(), None, mk(), None
    qmax = (1 << (min(kv_bits, 8) - 1)) - 1
    store = shape[:-1] + (shape[-1] // 2 if kv_bits == 4 else shape[-1],)
    mk = lambda: _from_numpy(
        rng.integers(-qmax, qmax + 1, store).astype(np.int8), dev)
    ms = lambda: _from_numpy(
        rng.uniform(1e-3, 1e-1, shape[:-1] + (1,)).astype(np.float32), dev)
    return mk(), ms(), mk(), ms()


def autotune_decode_attention(*, b: int, s: int, kv: int, g: int, dh: int,
                              kv_bits: int = 8, iters: int = 2,
                              force: bool = False, seed: int = 0,
                              device=None) -> dict:
    """Sweep B5's launch plan (cluster 1/2/4/8 x span limit 8/16/32, and
    the automatic plan as the default) for one cache shape class and
    persist the winner (tuning kind ``attn_decode``, block (cluster, Dh,
    span limit))."""
    if kv_bits != 8:
        raise ValueError(f"kv_bits={kv_bits}: B5 takes int8 codes")
    dev, backend = _sweep_device(device)
    rng = np.random.default_rng(seed)
    q = _from_numpy(rng.normal(size=(b, kv, g, dh)).astype(np.float32), dev)
    kc, ks, vc, vs = _kv_cache(rng, (b, s, kv, dh), kv_bits, dev)
    pos = torch.full((b,), s - 1, dtype=torch.int32, device=dev)

    def measure(block):
        return tuning.time_fn(
            lambda: _decode_attention_kernel(q, kc, ks, vc, vs, pos,
                                             plan=(block[0], block[2])),
            iters=iters)

    default = None
    if dev.type == "cuda":
        auto = decode_launch_plan(q, kc, vc)
        default = (auto["cluster"], dh, auto["span"])
    cands = [(c, dh, sp) for c in tuning.PA_CLUSTERS for sp in (8, 16, 32)]
    return tuning.autotune(b * g, dh, s, kind=tuning.ATTN_DECODE,
                           a_bits=kv_bits, w_bits=8, backend=backend,
                           measure=measure, candidates=cands,
                           default=default, force=force)


def _pool_sweep(kernel, kind: str, *, b, kv, g, dh, s_max, kv_bits,
                candidates, iters, force, seed, device, extra=()):
    """The pool block-size sweep of B2 and B4: for each candidate block size
    that divides ``s_max``, a pool of whole sequences at the last position,
    through a shuffled page table."""
    dev, backend = _sweep_device(device)
    rng = np.random.default_rng(seed)
    q = _from_numpy(rng.normal(size=(b, kv, g, dh)).astype(np.float32), dev)
    pos = torch.full((b,), s_max - 1, dtype=torch.int32, device=dev)

    def measure(block):
        bs = block[2]
        nb = s_max // bs
        pool = _kv_cache(rng, (b * nb + 1, bs, kv, dh), kv_bits, dev)
        pt = _from_numpy(rng.permutation(b * nb).reshape(b, nb)
                         .astype(np.int32) + 1, dev)
        return tuning.time_fn(
            lambda: kernel(q, *pool, pt, pos, *extra, kv_bits=kv_bits),
            iters=iters)

    cands = [(1, dh, bs) for bs in candidates if s_max % bs == 0] \
        or [(1, dh, s_max)]
    return tuning.autotune(b * g, dh, s_max, kind=kind, a_bits=kv_bits,
                           w_bits=8, backend=backend, measure=measure,
                           candidates=cands, force=force)


def autotune_kv_block_size(*, b: int, kv: int, g: int, dh: int, s_max: int,
                           kv_bits: int = 8, candidates=(16, 32, 64, 128),
                           iters: int = 2, force: bool = False,
                           seed: int = 0, device=None) -> dict:
    """Sweep the paged-attention kernel (B2) over candidate KV **block
    sizes** — the pool's block size is the knob, so the sweep recommends the
    block size a deployment should configure (:func:`preferred_kv_block_size`
    reads it back; ``--kv-block-size 0`` in ``launch.serve`` uses it)."""
    return _pool_sweep(_paged_attention_kernel, tuning.ATTN_PAGED, b=b,
                       kv=kv, g=g, dh=dh, s_max=s_max, kv_bits=kv_bits,
                       candidates=candidates, iters=iters, force=force,
                       seed=seed, device=device)


def preferred_kv_block_size(*, b: int, kv: int, g: int, dh: int, s_max: int,
                            kv_bits: int = 8, default: int = 16,
                            device=None) -> int:
    """Tuned pool block size for a cache shape class on ``device`` (default:
    the card) — cache lookup only: ``default`` on a cold cache or when the
    entry's size does not divide ``s_max``; never sweeps."""
    backend = BACKEND_CUDA if torch.device(
        device if device is not None else "cuda").type == "cuda" \
        else BACKEND_TORCH
    entry = tuning.lookup(b * g, dh, s_max, kind=tuning.ATTN_PAGED,
                          a_bits=kv_bits, w_bits=8, backend=backend)
    if entry is None:
        return default
    bs = int(entry["block"][2])
    return bs if s_max % bs == 0 else default


def autotune_fused_block_size(*, b: int, kv: int, g: int, dh: int, d: int,
                              s_max: int, kv_bits: int = 8,
                              candidates=(16, 32, 64, 128), iters: int = 2,
                              force: bool = False, seed: int = 0,
                              device=None) -> dict:
    """Sweep the fused decode kernel (B4) over candidate pool block sizes,
    persisted under tuning kind ``attn_fused_decode`` next to ``attn_paged``
    (the two dispatch shapes may prefer different block sizes)."""
    dev = _sweep_device(device)[0]
    rng = np.random.default_rng(seed + 1)
    wo = _from_numpy((rng.normal(size=(kv * g * dh, d)) * dh ** -0.5)
                     .astype(np.float32), dev)
    slot_map = torch.arange(b, dtype=torch.int32, device=dev)
    return _pool_sweep(_fused_decode_kernel, tuning.ATTN_FUSED, b=b, kv=kv,
                       g=g, dh=dh, s_max=s_max, kv_bits=kv_bits,
                       candidates=candidates, iters=iters, force=force,
                       seed=seed, device=device, extra=(slot_map, wo))


def model_matmul_shapes(model_cfg, tp: int = 1) -> set:
    """(N, K) pairs of every qlinear in a transformer-family ModelConfig —
    the shapes serving will hit (attention projections + FFN).

    ``tp`` > 1 yields the per-device shard shapes of the reference's
    model-axis sharding policy: output-sharded projections (wq/wk/wv,
    w_up/w_gate) shrink N -> N/tp, contraction-sharded ones (wo, w_down)
    shrink K -> K/tp — each only when the head count / hidden dim divides
    tp (otherwise that matrix replicates and keeps its global shape)."""
    shapes = set()
    d = getattr(model_cfg, "d_model", None)
    if not d:
        return shapes
    h = getattr(model_cfg, "n_heads", 0)
    kv = getattr(model_cfg, "n_kv_heads", h)
    dh = getattr(model_cfg, "dh", 0)
    f = getattr(model_cfg, "d_ff", 0)

    def div(n):
        return tp > 1 and n > 0 and n % tp == 0

    if h and dh:
        q_n = h * dh // tp if div(h) else h * dh          # wq: N-sharded
        kv_n = kv * dh // tp if div(kv) else kv * dh      # wk/wv: N-sharded
        o_k = h * dh // tp if div(h) else h * dh          # wo: K-sharded
        shapes |= {(q_n, d), (kv_n, d), (d, o_k)}
    if f:
        f_loc = f // tp if div(f) else f
        shapes |= {(f_loc, d), (d, f_loc)}                # w_up/gate | w_down
    return shapes


def _tunable_k(pcfg: PrecisionConfig, k: int) -> bool:
    """Whether a matmul with contraction length ``k`` has a kernel choice to
    tune under ``pcfg``: packed int32 storage, integer activations and a
    CUDA kernel for the key (unpacked int8-codes storage, float weights and
    float activations run one implementation)."""
    if pcfg.w_mode == W_FLOAT:
        return False
    bits = weight_bits(pcfg)
    packable = ((pcfg.pack_weights or pcfg.w_mode == W_BINARY)
                and 32 % bits == 0)
    a_bits = _act_bits(pcfg)
    return (packable and k % (32 // bits) == 0 and a_bits > 0
            and (pcfg.w_mode, a_bits, bits, BACKEND_CUDA) in _REGISTRY)


# ---------------------------------------------------------------------------
# precision-variant registry (adaptive serving)
# ---------------------------------------------------------------------------
class PrecisionVariant(NamedTuple):
    """One precision variant of a model's weights held for runtime precision
    switching: the serving-form params and the PrecisionConfig their
    matmuls dispatch under.  The speculative batcher and the adaptive
    server register their variants here, so tuning plans and tests can list
    what a server holds."""
    name: str                  # variant key, e.g. "primary", "2xT"
    pcfg: PrecisionConfig
    params: object             # serving-form param tree


# model name -> variant name -> PrecisionVariant
_VARIANTS: dict[str, dict[str, PrecisionVariant]] = {}


def register_variant(model_name: str, name: str, pcfg: PrecisionConfig,
                     params) -> PrecisionVariant:
    """Register (or replace) a named precision variant of one model's
    weights; re-registration overwrites, so rebuilding a batcher keeps no
    stale param tree."""
    var = PrecisionVariant(name, pcfg, params)
    _VARIANTS.setdefault(model_name, {})[name] = var
    return var


def registered_variants(model_name: str) -> dict[str, PrecisionVariant]:
    """The variants registered for ``model_name`` (possibly {})."""
    return dict(_VARIANTS.get(model_name, {}))


def clear_variants(model_name: str | None = None) -> None:
    """Drop registered variants (every model's when ``model_name`` is None),
    releasing the param trees they hold."""
    if model_name is None:
        _VARIANTS.clear()
    else:
        _VARIANTS.pop(model_name, None)


def variant_tune_plans(model_cfg, *, n_slots: int, chunk_size: int,
                       draft_window: int = 0, mesh=None) -> dict:
    """:func:`serving_tune_plan` of every variant registered under
    ``model_cfg.name``.  ``draft_window`` > 0 adds the speculative verify
    window's rows (``n_slots * (draft_window + 1)``: the (B, W) window
    flattens into the matmul M axis) to every plan."""
    extra = (int(n_slots) * (int(draft_window) + 1),) if draft_window else ()
    return {name: serving_tune_plan(model_cfg, var.pcfg, n_slots=n_slots,
                                    chunk_size=chunk_size, mesh=mesh,
                                    extra_m=extra)
            for name, var in registered_variants(model_cfg.name).items()}


def serving_tune_plan(model_cfg, pcfg: PrecisionConfig, *, n_slots: int,
                      chunk_size: int, mesh=None, extra_m=()) -> list:
    """The (M, N, K) shape classes the continuous batcher will dispatch —
    what :func:`tune_serving_shapes` sweeps: ``chunk_size`` rows per prefill
    chunk, ``n_slots`` rows per decode step and ``extra_m`` (such as the
    paged batcher's occupancy buckets), against the model's (N, K) grid.
    With a mesh the plan ADDS each rank's shapes
    (``parallel.sharding.serving_shard_factors``): the decode batch shards
    over the data axes (local M = n_slots / dp; the batch-1 admission chunk
    stays M = chunk_size), and tensor-parallel layers hold local N or K
    divided by the model-axis size (pure-DP models keep tp = 1)."""
    m_rows = (int(chunk_size), int(n_slots)) + tuple(int(m) for m in extra_m)
    plan = {(m, n, k) for (n, k) in model_matmul_shapes(model_cfg)
            for m in m_rows}
    if mesh is not None:
        from repro_torch.parallel.sharding import serving_shard_factors
        dp, tp = serving_shard_factors(model_cfg, mesh, n_slots)
        local_m = (int(chunk_size), max(1, int(n_slots) // dp)) + \
            tuple(int(m) for m in extra_m)
        plan |= {(m, n, k) for (n, k) in model_matmul_shapes(model_cfg, tp=tp)
                 for m in local_m}
    return sorted(plan)


def tune_serving_shapes(model_cfg, pcfg: PrecisionConfig, *, n_slots: int,
                        chunk_size: int, mesh=None, extra_m=(), device=None,
                        candidates=None, iters: int = 2) -> list:
    """Pre-tune the exact M-row buckets the continuous batcher dispatches
    (:func:`serving_tune_plan`), so the serving loop never misses.  Returns
    the cache entries of the tunable classes."""
    return [autotune_matmul(pcfg, m, n, k, device=device,
                            candidates=candidates, iters=iters)
            for (m, n, k) in serving_tune_plan(
                model_cfg, pcfg, n_slots=n_slots, chunk_size=chunk_size,
                mesh=mesh, extra_m=extra_m)
            if _tunable_k(pcfg, k)]


def prime_serving_shapes(model_cfg, pcfg: PrecisionConfig, *, n_slots: int,
                         chunk_size: int, mesh=None, extra_m=(),
                         backend: str | None = None) -> int:
    """Insert default-block cache entries (``tuning.prime``, no measuring)
    for every tunable shape class of :func:`serving_tune_plan`.  Returns the
    number of shape classes primed or present."""
    backend = backend or BACKEND_CUDA
    n = 0
    for (m, nn, k) in serving_tune_plan(model_cfg, pcfg, n_slots=n_slots,
                                        chunk_size=chunk_size, mesh=mesh,
                                        extra_m=extra_m):
        if not _tunable_k(pcfg, k):
            continue
        # packed storage: the cache kind is the weight mode
        tuning.prime(m, nn, k, kind=pcfg.w_mode, a_bits=_act_bits(pcfg),
                     w_bits=weight_bits(pcfg), backend=backend,
                     persist=False)
        n += 1
    return n


def tune_model_shapes(model_cfg, pcfg: PrecisionConfig, *, m_rows=(8, 128),
                      device=None, candidates=None, iters: int = 2) -> list:
    """Pre-tune every (M, N, K) of ``m_rows`` against a model's matmul
    shapes.  Returns the entries."""
    return [autotune_matmul(pcfg, m, n, k, device=device,
                            candidates=candidates, iters=iters)
            for (n, k) in sorted(model_matmul_shapes(model_cfg))
            if _tunable_k(pcfg, k) for m in m_rows]
