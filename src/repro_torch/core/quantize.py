"""Quantizers — the schemes of ``repro.core.quantize``.

Weights:
  * ternary (TWN): w_q = alpha * sign(w) * 1{|w| > delta},
    delta = 0.7 * mean|w|, alpha = mean |w| over the retained entries;
  * binary (XNOR-net): w_q = alpha * sign(w), alpha = mean |w|;
  * k-bit signed ints with a per-output-channel scale (symmetric).

Activations (paper eq. 4, k bits): post-ReLU values clip to [0, 1] and round
to 2^k - 1 uniform levels; signed k-bit values round to a symmetric grid
with a per-tensor scale; 1-bit signed values are sign(x).  The integer-code
quantizers (:func:`act_quant_codes_unsigned`, :func:`act_quant_codes_signed`)
run the activation-quantizer kernels (``kernels/act_quant.py``) on the card.

The fake-quant (quantize -> dequantize) functions are the reference's
straight-through estimators, value for value and gradient for gradient: the
reference computes ``w + stop_gradient(wq - w)``, and the port computes
``w + (wq - w).detach()``, the same sum in the same order (not plain ``wq``,
which can differ by one rounding) with the identity gradient.  Every
``stop_gradient`` of the reference is a ``.detach()`` here.  ``torch.round``
and ``jnp.round`` both round half to even.
"""
from __future__ import annotations

import torch

from .precision import (A_FLOAT, A_SIGNED, A_UNSIGNED, PrecisionConfig,
                        W_BINARY, W_FLOAT, W_INT, W_TERNARY)


# true_div's divisors on the card, one 0-dim tensor a (device, dtype, n)
_DIVISORS: dict[tuple, torch.Tensor] = {}


def true_div(t: torch.Tensor, n) -> torch.Tensor:
    """``t / n`` for a Python number ``n``, a true quotient on every device.
    PyTorch's CUDA division by a Python number multiplies by its rounded
    reciprocal, which differs from the quotient in one ulp for some 5% (n =
    127) to 55% (n = 7) of values; the CPU divides.  ``n`` is a tensor on
    t's device in t's dtype, so both devices divide.  On the card it is
    made once (outside a CUDA-graph capture; a capture that finds none
    fills its own) and kept, so the quotient is one launch, as ``t / n``
    was.  Every quantizer scale ``amax / qmax`` of the port's PyTorch code
    goes through here; the kernels divide with ``__fdiv_rn``."""
    if not t.is_cuda:
        return t / t.new_full((), n)
    key = (t.device, t.dtype, n)
    d = _DIVISORS.get(key)
    if d is None:
        if torch.cuda.is_current_stream_capturing():
            return t / t.new_full((), n)
        with torch.inference_mode(False):     # usable under autograd too
            d = t.new_full((), n)
        # filled before any stream reads it
        torch.cuda.current_stream(t.device).synchronize()
        _DIVISORS[key] = d
    return t / d


def _rows(x: torch.Tensor) -> torch.Tensor:
    """x as contiguous (rows, last dim) for the elementwise kernels."""
    return x.reshape(-1, x.shape[-1] if x.dim() else 1).contiguous()


def act_quant_codes_unsigned(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Paper eq. (4): integer codes 0..2^k-1 for post-ReLU activations,
    ``floor(min(1, x) * (2^k - 1) + 0.5)`` with x clamped below at 0, as
    int8 of x's shape, computed in x's dtype (float32 or bfloat16).  Codes
    saturate at 127, as the reference's int8 conversion does."""
    from repro_torch.kernels.act_quant import act_quant  # kernels import core
    codes = act_quant(_rows(x), bits=bits, compute_dtype=x.dtype)
    return codes.reshape(x.shape)


def act_quant_codes_signed(x: torch.Tensor, bits: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric signed k-bit codes with a per-tensor scale: returns (codes
    in [-(2^(k-1)-1), 2^(k-1)-1] as int8 of x's shape, scale as a float32
    scalar) with dequant = codes * scale.  The scale is max|x| / qmax
    (floored at 1e-8, a true quotient) in x's dtype, which the codes are
    computed in; on the card scale and codes come from one launch
    (``act_quant_signed_tensor``)."""
    from repro_torch.kernels.act_quant import act_quant_signed_tensor
    codes, scale = act_quant_signed_tensor(_rows(x), bits=bits)
    return codes.reshape(x.shape), scale


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """clamp(x, lo, hi) with the reference's ``jnp.clip`` gradient: an entry
    equal to a bound gets half the gradient (``maximum`` / ``minimum`` split
    ties in both packages; ``torch.clamp`` would pass all of it).  The
    bounds are filled on x's device (``new_tensor`` would copy them from
    the host and wait for the device's queue)."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                         x.new_full((), hi))


def _round_ste(x: torch.Tensor) -> torch.Tensor:
    """round(x) with identity gradient, as the reference's
    ``x + stop_gradient(round(x) - x)``."""
    return x + (torch.round(x) - x).detach()


def act_fake_quant(x: torch.Tensor, cfg: PrecisionConfig,
                   reduce=None) -> torch.Tensor:
    """Fake-quantized activations with STE, for QAT and the plain paths:
    unsigned eq. (4) levels, signed k-bit with a per-tensor absmax scale
    (no gradient through the scale), or sign(x) at 1 bit, whose gradient
    is zero, as the reference's ``sign(x) + stop_gradient(0 x)``.

    ``reduce``: the mesh axis (``parallel.comm.Axis``) ``x`` is split over
    (its rows, or its K): the absmax is the max over the axis of each
    rank's, so the scale is the whole tensor's."""
    if cfg.a_mode == A_FLOAT:
        return x
    bits = cfg.a_bits
    if cfg.a_mode == A_UNSIGNED:
        levels = (1 << bits) - 1
        return _round_ste(_clip(x, 0.0, 1.0) * levels) / levels
    if cfg.a_mode == A_SIGNED:
        if bits == 1:
            return torch.sign(x) + 0.0 * x          # XNOR-net binary activations
        qmax = (1 << (bits - 1)) - 1
        amax = x.abs().amax().detach()
        if reduce is not None:
            amax = reduce.all_reduce_max(amax)
        scale = true_div(amax.clamp_min(1e-8), qmax)
        return _round_ste(_clip(x / scale, -qmax, qmax)) * scale
    raise ValueError(cfg.a_mode)


def ternary_quant(w: torch.Tensor, axis=0) -> tuple[torch.Tensor, torch.Tensor]:
    """TWN ternarization.  Returns (codes in {-1,0,1} int8, alpha f32);
    ``axis`` is the reduction axis (w shaped [in, out] -> per-out alpha)."""
    a = w.abs()
    delta = 0.7 * a.mean(dim=axis, keepdim=True)
    mask = a > delta
    codes = torch.where(mask, torch.sign(w), torch.zeros_like(w))
    denom = mask.sum(dim=axis, keepdim=True).clamp_min(1)
    alpha = (a * mask).sum(dim=axis, keepdim=True) / denom
    return codes.to(torch.int8), alpha.to(torch.float32)


def binary_quant(w: torch.Tensor, axis=0) -> tuple[torch.Tensor, torch.Tensor]:
    """XNOR-net binarization: codes {-1,+1}, alpha = mean|w|."""
    alpha = w.abs().mean(dim=axis, keepdim=True)
    codes = torch.where(w >= 0, 1, -1)
    return codes.to(torch.int8), alpha.to(torch.float32)


def int_quant(w: torch.Tensor, bits: int, axis=0) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric k-bit signed weight quantization with per-channel scale."""
    qmax = (1 << (bits - 1)) - 1
    absmax = w.abs().amax(dim=axis, keepdim=True).clamp_min(1e-8)
    scale = true_div(absmax, qmax)
    codes = torch.clamp(torch.round(w / scale), -qmax, qmax).to(torch.int8)
    return codes, scale.to(torch.float32)


def _split_quant(w: torch.Tensor, cfg: PrecisionConfig, axis: int, reduce
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`weight_quant` of a weight whose reduction ``axis`` (its K) is
    split over the mesh axis ``reduce``: each per-channel statistic is the
    sum (the max for ints) over the axis of each rank's, so codes and scale
    are the whole weight's (within the sums' rounding)."""
    a = w.abs()
    n = w.shape[axis] * reduce.size
    if cfg.w_mode == W_INT:
        qmax = (1 << (cfg.w_bits - 1)) - 1
        absmax = reduce.all_reduce_max(a.amax(dim=axis, keepdim=True))
        scale = true_div(absmax.clamp_min(1e-8), qmax)
        codes = torch.clamp(torch.round(w / scale), -qmax, qmax)
        return codes.to(torch.int8), scale.to(torch.float32)
    mean = reduce.all_reduce_sum(a.sum(dim=axis, keepdim=True)) / n
    if cfg.w_mode == W_BINARY:
        return torch.where(w >= 0, 1, -1).to(torch.int8), \
            mean.to(torch.float32)
    if cfg.w_mode != W_TERNARY:
        raise ValueError(cfg.w_mode)
    mask = a > 0.7 * mean
    sums = reduce.all_reduce_sum(torch.stack([
        mask.sum(dim=axis, keepdim=True).to(a.dtype),
        (a * mask).sum(dim=axis, keepdim=True)]))
    alpha = sums[1] / sums[0].clamp_min(1)
    codes = torch.where(mask, torch.sign(w), torch.zeros_like(w))
    return codes.to(torch.int8), alpha.to(torch.float32)


def weight_quant(w: torch.Tensor, cfg: PrecisionConfig, axis=0, reduce=None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dispatch by config.  Returns (int8 codes, float32 per-channel scale).
    ``reduce``: the mesh axis ``w``'s reduction ``axis`` is split over
    (:func:`_split_quant`)."""
    if cfg.w_mode == W_FLOAT:
        raise ValueError("float weights are not quantized")
    if reduce is not None and reduce.size > 1:
        return _split_quant(w, cfg, axis, reduce)
    if cfg.w_mode == W_TERNARY:
        return ternary_quant(w, axis=axis)
    if cfg.w_mode == W_BINARY:
        return binary_quant(w, axis=axis)
    if cfg.w_mode == W_INT:
        return int_quant(w, cfg.w_bits, axis=axis)
    raise ValueError(cfg.w_mode)


def weight_fake_quant(w: torch.Tensor, cfg: PrecisionConfig, axis=0,
                      reduce=None) -> torch.Tensor:
    """Quantize -> dequantize weights with STE (the QAT forward, identity
    gradient; float configs pass through).  ``reduce``: as
    :func:`weight_quant`'s."""
    if cfg.w_mode == W_FLOAT:
        return w
    codes, alpha = weight_quant(w.detach(), cfg, axis=axis, reduce=reduce)
    wq = codes.to(w.dtype) * alpha.to(w.dtype)
    return w + (wq - w).detach()
