"""Plain PyTorch versions of the kernels — the semantics of
``repro.kernels.ref`` (integer paths match exactly, float paths to a
tolerance): the packed and binary matmuls, the activation quantizers and
full-sequence flash attention.  They run on any device: the CPU path of
every wrapper, and the yardstick the CUDA kernels are held against on the
card.

Integer products accumulate in float64, which holds every int8 x int8 sum
these shapes produce exactly (|acc| < 2^53), so the result equals an int32
accumulation on CPU and CUDA alike (CUDA has no integer ``matmul``).
"""
from __future__ import annotations

import torch

from repro_torch.core import packing
from repro_torch.core.quantize import true_div


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


def binary_matmul_ref(x_packed, wt_packed, k: int, alpha=None,
                      out_dtype=torch.float32, row_scale=None):
    """1-bit x 1-bit dot products over +/-1 values stored as {1, 0} bits,
    32 per int32 word: x_packed (M, K/32), wt_packed (N, K/32); ``k`` is
    the unpacked K.  out[m, n] = sum_k a[m, k] * w[n, k]
    = K - 2 * popcount(a XOR w), exact, then ``* alpha`` (N,) and
    ``* row_scale`` (M, 1) in f32."""
    if x_packed.shape[-1] * 32 != k or wt_packed.shape[-1] * 32 != k:
        raise ValueError(f"K mismatch: {k} against words {x_packed.shape[-1]}"
                         f" and {wt_packed.shape[-1]}")
    a = packing.unpack_binary_pm1(x_packed)                   # (M, K) int8
    w = packing.unpack_binary_pm1(wt_packed)                  # (N, K) int8
    acc = int_dot(a, w).to(torch.float32)
    if alpha is not None:
        acc = acc * alpha[None, :]
    if row_scale is not None:
        acc = acc * row_scale
    return acc.to(out_dtype)


# ---------------------------------------------------------------------------
# activation quantizers (paper eq. 4 and the signed symmetric grid)
# ---------------------------------------------------------------------------
def _saturate_int8(v: torch.Tensor) -> torch.Tensor:
    """Integral floats -> int8, saturating at [-128, 127] as the reference's
    float -> int8 conversion does (a bare torch cast wraps): 8-bit unsigned
    codes above 127 come out as 127."""
    return torch.clamp(v, -128, 127).to(torch.int8)


def act_quant_ref(x, bits: int, *, compute_dtype=torch.float32):
    """Paper eq. (4): ``floor(clip(x, 0, 1) * (2^k - 1) + 0.5)`` as int8
    codes, half rounded up.  ``compute_dtype`` float32 is the TPU kernel's
    arithmetic; bfloat16 rounds the product and the sum to bf16 each, as the
    same expression on bf16 rows does."""
    levels = (1 << bits) - 1
    v = torch.clamp(x.to(compute_dtype), 0.0, 1.0) * levels
    return _saturate_int8(torch.floor(v + 0.5))


def act_quant_signed_ref(x, bits: int, scale, *, compute_dtype=torch.float32):
    """Symmetric signed k-bit codes ``clip(round(x / scale), +-qmax)``, half
    to even, with ``scale`` broadcasting against x (a scalar: per-tensor).
    A quotient, never a product with 1/scale; in bfloat16 the quotient is
    rounded to bf16 before ``round``."""
    qmax = (1 << (bits - 1)) - 1
    s = torch.as_tensor(scale, device=x.device).to(compute_dtype)
    q = x.to(compute_dtype) / s
    return _saturate_int8(torch.clamp(torch.round(q), -qmax, qmax))


def act_quant_signed_grouped_ref(x, bits: int, scale, *,
                                 compute_dtype=torch.float32):
    """Fine-grained signed codes: x (M, F), scale (M, G) with G | F,
    scale[i, g] covering columns [g*F/G, (g+1)*F/G).  G = 1 is the engine's
    per-row quantizer."""
    m, f = x.shape
    g = scale.shape[1]
    if scale.shape[0] != m or f % g:
        raise ValueError(f"scale {tuple(scale.shape)} does not group x "
                         f"{tuple(x.shape)}")
    qmax = (1 << (bits - 1)) - 1
    q = x.to(compute_dtype).reshape(m, g, f // g) / \
        scale.to(compute_dtype)[:, :, None]
    return _saturate_int8(torch.clamp(torch.round(q), -qmax, qmax)
                          ).reshape(m, f)


def act_quant_signed_rows_ref(x, bits: int):
    """The engine's per-row quantizer in x's dtype: ``a_scale = max(amax
    |x[row]|, 1e-8) / qmax`` (M, 1), then
    :func:`act_quant_signed_grouped_ref` with that scale.  Returns (codes,
    a_scale).  The quotient is a true one on every device (``true_div``)."""
    qmax = (1 << (bits - 1)) - 1
    a_scale = true_div(x.abs().amax(dim=1, keepdim=True).clamp_min(1e-8), qmax)
    return act_quant_signed_grouped_ref(x, bits, a_scale,
                                        compute_dtype=x.dtype), a_scale


def act_quant_signed_tensor_ref(x, bits: int):
    """``core.act_quant_codes_signed`` on rows x: one scale ``max(amax|x|,
    1e-8) / qmax`` in x's dtype (a true quotient, ``true_div``), then
    :func:`act_quant_signed_ref` in x's dtype.  Returns (codes, the scale
    as a float32 scalar)."""
    scale = true_div(x.abs().amax().clamp_min(1e-8), (1 << (bits - 1)) - 1)
    return act_quant_signed_ref(x, bits, scale, compute_dtype=x.dtype), \
        scale.to(torch.float32)


# ---------------------------------------------------------------------------
# full-sequence flash attention
# ---------------------------------------------------------------------------
# keys a tile of the bf16 and the f32 flash kernels (csrc/flash_attention.cu)
FLASH_TILE = {torch.bfloat16: 64, torch.float32: 32}


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, probs_bf16: bool = False):
    """Full-materialization softmax, in f32, with the flash kernel's
    semantics: q (B, Sq, KV, G, Dh), k/v (B, Sk, KV, Dh), query and key
    positions both counted from 0; ``k_pos <= q_pos`` when causal,
    ``k_pos > q_pos - window`` when window > 0, scores
    ``softcap * tanh(s / softcap)`` when softcap > 0; a row with no key
    left is 0.  Returns (B, Sq, KV, G, Dh) float32.

    ``probs_bf16``: the kernel's arithmetic of the flag, tile for tile:
    an online softmax over tiles of ``FLASH_TILE[q.dtype]`` keys (aligned
    from key 0), each tile's ``p = exp(s - m)`` rounded to bf16 against the
    running max and multiplied by V rounded to bf16, the tile's sum in f32
    added to ``acc * corr``; ``l`` sums the unrounded p."""
    dh = q.shape[-1]
    sq, sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqkgd,bskd->bkgqs", q.to(torch.float32),
                     k.to(torch.float32)) * (dh ** -0.5)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    if probs_bf16:
        return _flash_bf16_probs(s, mask, v, FLASH_TILE[q.dtype])
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(-1)[:, None], p, torch.zeros_like(p))
    out = torch.einsum("bkgqs,bskd->bkgqd", p, v.to(torch.float32))
    return out.permute(0, 3, 1, 2, 4)


def _flash_bf16_probs(s, mask, v, tile: int):
    """The online softmax of :func:`flash_attention_ref` with bf16 P and V
    over key tiles of ``tile``: s (B, KV, G, Sq, Sk) f32 scores, -1e30
    where masked; mask (Sq, Sk); v (B, Sk, KV, Dh)."""
    vb = v.to(torch.bfloat16).to(torch.float32)
    m = torch.full(s.shape[:-1], -1e30, dtype=torch.float32, device=s.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(s.shape[:-1] + (v.shape[-1],), dtype=torch.float32,
                      device=s.device)
    for k0 in range(0, s.shape[-1], tile):
        st, mt = s[..., k0:k0 + tile], mask[:, k0:k0 + tile]
        m_new = torch.maximum(m, st.amax(dim=-1))
        p = torch.where(mt, torch.exp(st - m_new[..., None]),
                        torch.zeros_like(st))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pb = p.to(torch.bfloat16).to(torch.float32)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", pb, vb[:, k0:k0 + tile])
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.permute(0, 3, 1, 2, 4)
