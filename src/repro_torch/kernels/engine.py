"""Precision-dispatch kernel engine — the counterpart of
``repro.kernels.engine``.

A kernel **registry** keyed on ``(weight_kind, act_bits, weight_bits,
backend)`` behind one entry point, :func:`qmatmul`, which

  1. prepares activations for the config (dynamic symmetric PER-ROW
     quantization to int8 codes, or float passthrough),
  2. resolves the implementation: the exact key first, then the plain
     ``torch`` backend (keys with no CUDA kernel, such as the unpacked
     int8-codes storage, are registered for ``torch`` only),
  3. applies the epilogue ``acc * w_scale * a_scale + bias`` in that order.

Backends: ``"cuda"`` (the hand-written kernels of ``csrc/``) and
``"torch"`` (their plain versions).  With ``backend=None`` a CUDA tensor
goes to the kernel and a CPU tensor to the plain version; ``"cuda"`` with a
CPU tensor raises; nothing switches to the plain path while a card is
present unless the caller passes ``backend="torch"``.

A second registry keyed on ``(attn_kind, kv_bits, backend)`` serves the
dense-cache decode attention (:func:`decode_attention`).

``weight_kind`` is the *storage* kind: "int" / "ternary" / "binary" for
bit-packed int32 words, "codes" for the unpacked int8 fallback (3-bit,
misaligned K).  ``act_bits == 0`` means float activations.
"""
from __future__ import annotations

import contextlib
from collections.abc import Callable
from typing import NamedTuple

import torch

from repro_torch.core import packing
from repro_torch.core.precision import (A_FLOAT, PrecisionConfig, W_BINARY,
                                        W_FLOAT, W_INT, W_TERNARY)
from repro_torch.core.quantize import weight_quant

from . import _build, ref
from .decode_attention import (decode_attention as _decode_attention_kernel,
                               decode_attention_serving_ref)
from .packed_matmul import packed_matmul
from .ternary_matmul import ternary_matmul

BACKEND_CUDA = "cuda"
BACKEND_TORCH = "torch"
BACKENDS = (BACKEND_CUDA, BACKEND_TORCH)

# storage kind for the unpacked int8-codes fallback (3-bit, misaligned K)
K_CODES = "codes"

# the hand-written kernels, by launch-counter name
KERNELS = ("ternary_matmul", "packed_matmul", "decode_attention")


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


def default_backend(t: torch.Tensor) -> str:
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    return BACKEND_CUDA if t.is_cuda else BACKEND_TORCH


def _check_backend(backend: str | None, t: torch.Tensor) -> str:
    """The backend for an input on ``t``'s device: the device decides when
    ``backend`` is None; ``"cuda"`` is refused for a host tensor, so a
    dispatch recorded as ``cuda`` always ran on the card."""
    backend = backend or default_backend(t)
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; known: {BACKENDS}")
    if backend == BACKEND_CUDA and not t.is_cuda:
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
    inputs)."""
    op: str                     # "qmatmul" | "decode_attention"
    kind: str                   # storage kind / attn kind
    requested_backend: str
    impl_backend: str
    a_bits: int                 # act bits (matmul) / kv_bits (attention)
    w_bits: int
    m_rows: int
    a_scale_shape: tuple[int, ...] | None


_DISPATCH_SINK: list | None = None


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


def _record_dispatch(**kw) -> None:
    if _DISPATCH_SINK is not None:
        _DISPATCH_SINK.append(DispatchEvent(**kw))


def launch_counts() -> dict[str, int]:
    """CUDA kernel launches since the last :func:`reset_launch_counts`, per
    kernel (each wrapper counts where it launches, and nowhere else)."""
    return {name: _build.LAUNCHES[name] for name in KERNELS}


def reset_launch_counts() -> None:
    _build.LAUNCHES.clear()


# ---------------------------------------------------------------------------
# implementations.  Signature:
#     fn(x, pw, scale, bias, *, out_dtype, a_scale=None) -> (M, N)
# ``x`` is prepared by qmatmul (int8 codes or float); ``scale`` is the (N,)
# weight scale; ``a_scale`` the (M, 1) per-row activation scale (None for
# float/pre-quantized inputs).  Epilogue order everywhere:
# acc * w_scale * a_scale + bias -> out_dtype.
# ---------------------------------------------------------------------------
def _row_epilogue(out, a_scale, bias, out_dtype):
    """Per-row dequant applied after the kernel, with the bias held out of
    the kernel so the order matches the plain versions."""
    out = out * a_scale
    if bias is not None:
        out = out + bias[None, :]
    return out.to(out_dtype)


def _kernel_call(kernel, x, pw, scale, bias, out_dtype, a_scale, **kw):
    out = kernel(x.contiguous(), pw.wt_packed, scale,
                 bias if a_scale is None else None, **kw)
    if a_scale is not None:
        return _row_epilogue(out, a_scale, bias, out_dtype)
    return out.to(out_dtype)


@register_kernel(W_INT, ACT_BITS_RANGE, (2, 4, 8), BACKEND_CUDA)
def _int_packed_cuda(x, pw, scale, bias, *, out_dtype, a_scale=None):
    return _kernel_call(packed_matmul, x, pw, scale, bias, out_dtype, a_scale,
                        bits=pw.bits)


@register_kernel(W_INT, ACT_BITS_RANGE, tuple(range(1, 9)), BACKEND_TORCH)
def _int_packed_torch(x, pw, scale, bias, *, out_dtype, a_scale=None):
    return ref.packed_matmul_ref(x, pw.wt_packed, scale, pw.bits, bias=bias,
                                 out_dtype=out_dtype, row_scale=a_scale)


@register_kernel(W_TERNARY, ACT_BITS_RANGE, 2, BACKEND_CUDA)
def _ternary_cuda(x, pw, scale, bias, *, out_dtype, a_scale=None):
    return _kernel_call(ternary_matmul, x, pw, scale, bias, out_dtype, a_scale)


@register_kernel(W_TERNARY, ACT_BITS_RANGE, 2, BACKEND_TORCH)
def _ternary_torch(x, pw, scale, bias, *, out_dtype, a_scale=None):
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


@register_kernel(W_BINARY, tuple(a for a in ACT_BITS_RANGE if a != 1), 1,
                 BACKEND_TORCH)
def _binary_dequant_torch(x, pw, scale, bias, *, out_dtype, a_scale=None):
    """Binary weights with multi-bit/float activations (8xB): decode the
    +/-1 codes and run the plain dot — no XNOR trick applies."""
    codes = packing.unpack_binary_pm1(pw.wt_packed)            # (N, K) int8
    return _dequant_dot(x, codes, scale, bias, out_dtype, a_scale)


@register_kernel(K_CODES, ACT_BITS_RANGE, tuple(range(1, 9)), BACKEND_TORCH)
def _codes_torch(x, pw, scale, bias, *, out_dtype, a_scale=None):
    """Unpacked int8 codes storage (3-bit / misaligned K)."""
    return _dequant_dot(x, pw.wt_packed, scale, bias, out_dtype, a_scale)


# ---------------------------------------------------------------------------
# activation preparation
# ---------------------------------------------------------------------------
def _prep_activations(x2: torch.Tensor, a_bits: int):
    """Returns (x_prepped, a_scale or None).  Integer inputs are taken as
    ready-made codes (the caller owns their scale); float inputs are
    quantized symmetric PER ROW: each row's codes and scale depend only on
    that row, so any batch shape gives the same values.  a_scale is (M, 1).
    """
    if not x2.is_floating_point() or a_bits == 0:
        return x2, None
    qmax = (1 << (min(a_bits, 8) - 1)) - 1
    a_scale = x2.abs().amax(dim=1, keepdim=True).clamp_min(1e-8) / qmax
    xq = torch.clamp(torch.round(x2 / a_scale), -qmax, qmax).to(torch.int8)
    return xq, a_scale


# ---------------------------------------------------------------------------
# the single public dispatch point
# ---------------------------------------------------------------------------
def qmatmul(x: torch.Tensor, pw: PackedWeight, cfg: PrecisionConfig, *,
            bias=None, out_dtype=torch.float32,
            backend: str | None = None) -> torch.Tensor:
    """``x @ W`` with quantized/packed ``W`` under ``cfg``.

    x       : (..., K) float activations or int8 codes; leading dims are
              flattened and restored.
    pw      : :func:`pack_weight` / :func:`as_packed_weight` output.
    backend : "cuda" | "torch"; None picks by the device of ``x``.
    """
    if cfg.w_mode == W_FLOAT:
        raise ValueError("qmatmul needs a quantized-weight config; "
                         "float weights are a plain matmul")
    backend = _check_backend(backend, x)
    a_bits = 0 if (cfg.a_mode == A_FLOAT or cfg.a_bits > 8) else cfg.a_bits
    if a_bits == 1:
        raise NotImplementedError(
            f"{cfg.name}: 1-bit activations (the XNOR-popcount path) are not "
            "ported yet")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    xq, a_scale = _prep_activations(x2, a_bits)
    # weight scale (N,) and per-row act scale (M, 1) stay separate: folding
    # them would couple the epilogue to the batch
    scale = pw.scale.reshape(-1).to(torch.float32)
    kind = storage_kind(pw)
    fn, matched = resolve_entry(kind, a_bits, pw.bits, backend)
    _record_dispatch(op="qmatmul", kind=kind, requested_backend=backend,
                     impl_backend=matched[3], a_bits=a_bits, w_bits=pw.bits,
                     m_rows=int(x2.shape[0]),
                     a_scale_shape=(None if a_scale is None
                                    else tuple(a_scale.shape)))
    out = fn(xq, pw, scale, bias, out_dtype=out_dtype, a_scale=a_scale)
    return out.reshape(*lead, out.shape[-1])


# ---------------------------------------------------------------------------
# attention-kernel registry (serving decode hot path)
# ---------------------------------------------------------------------------
# keyed on (attn_kind, kv_bits, backend); resolution falls back to the
# ``torch`` backend like the matmul registry.  The torch registration
# reproduces the model's in-layer math op-for-op (dequant to the model
# dtype); kv_bits=4 has no kernel on either package's accelerator.
ATTN_DECODE = "decode"
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
def _decode_attn_torch(q, k, ks, v, vs, pos, *, kv_bits, dtype):
    return decode_attention_serving_ref(q, k, ks, v, vs, pos,
                                        kv_bits=kv_bits, dtype=dtype)


@register_attention(ATTN_DECODE, 8, BACKEND_CUDA)
def _decode_attn_cuda(q, k, ks, v, vs, pos, *, kv_bits, dtype):
    return _decode_attention_kernel(q.contiguous(), k, ks, v, vs,
                                    pos).to(dtype)


def decode_attention(q, k_codes, k_scale, v_codes, v_scale, pos, *,
                     kv_bits: int = 8, dtype=torch.float32,
                     backend: str | None = None) -> torch.Tensor:
    """One-step dense-cache decode attention via the registry.

    q: (B, KV, G, Dh); codes (B, S, KV, Dh'); scales (B, S, KV, 1);
    pos scalar or (B,).  Returns (B, KV, G, Dh) in ``dtype``."""
    backend = _check_backend(backend, q)
    fn, matched = resolve_attention_entry(ATTN_DECODE, kv_bits, backend)
    _record_dispatch(op="decode_attention", kind=ATTN_DECODE,
                     requested_backend=backend, impl_backend=matched[2],
                     a_bits=kv_bits, w_bits=8, m_rows=int(q.shape[0]),
                     a_scale_shape=None)
    return fn(q, k_codes, k_scale, v_codes, v_scale, pos, kv_bits=kv_bits,
              dtype=dtype)
