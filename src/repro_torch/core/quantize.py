"""Weight quantizers — the ternary/binary/k-bit schemes of ``repro.core.quantize``.

  * ternary (TWN): w_q = alpha * sign(w) * 1{|w| > delta},
    delta = 0.7 * mean|w|, alpha = mean |w| over the retained entries;
  * binary (XNOR-net): w_q = alpha * sign(w), alpha = mean |w|;
  * k-bit signed ints with a per-output-channel scale (symmetric).

Serving needs only the integer codes and their scales; the straight-through
(QAT) forms are not ported yet.
"""
from __future__ import annotations

import torch

from .precision import PrecisionConfig, W_BINARY, W_FLOAT, W_INT, W_TERNARY


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
    scale = absmax / qmax
    codes = torch.clamp(torch.round(w / scale), -qmax, qmax).to(torch.int8)
    return codes, scale.to(torch.float32)


def weight_quant(w: torch.Tensor, cfg: PrecisionConfig, axis=0
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dispatch by config.  Returns (int8 codes, float32 per-channel scale)."""
    if cfg.w_mode == W_FLOAT:
        raise ValueError("float weights are not quantized")
    if cfg.w_mode == W_TERNARY:
        return ternary_quant(w, axis=axis)
    if cfg.w_mode == W_BINARY:
        return binary_quant(w, axis=axis)
    if cfg.w_mode == W_INT:
        return int_quant(w, cfg.w_bits, axis=axis)
    raise ValueError(cfg.w_mode)
