"""Plain PyTorch of the paper's quantized CNN datapath: the benchmark's
reference, written from the paper and the configuration, with no kernel,
no cache and nothing of the program.

A quantized layer (paper section III, eqs. 1-4):

1. im2col: every output position's receptive field, flattened in
   (kernel row, kernel column, channel) order, zero padding;
2. the activation codes, per row: ``scale = max(max|row|, 1e-8) / qmax``
   with ``qmax = 2**(bits-1) - 1``, ``codes = clip(round(row / scale),
   -qmax, qmax)`` (round half to even), a true quotient;
3. ternary weights (TWN) per output channel over K: ``delta = 0.7 *
   mean|w|``, codes ``sign(w)`` where ``|w| > delta`` else 0, ``alpha =
   mean |w|`` over the kept entries;
4. the integer product of the codes (exact: integers below 2**24 in f32),
   then ``acc * alpha * scale`` in f32, in that order;
5. BNS, the fused scale and shift ``y * gamma + beta``, ReLU, and the eq.
   (4) re-quantization to ``2**bits - 1`` levels of [0, 1].

Every float product is f32 with TF32 off.  ``tf32=True`` rounds the
operands of every product to TF32 (10 mantissa bits, round to nearest
even) first: the control, the nearest precision below the configuration's.
"""
from __future__ import annotations

import torch


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32's 10 mantissa bits, to nearest even."""
    bits = t.contiguous().view(torch.int32)
    keep = (bits >> 13) & 1
    bits = (bits + 0xFFF + keep) & ~0x1FFF
    return bits.view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    if tf32:
        a, b = to_tf32(a), to_tf32(b)
    return a @ b


def im2col(x: torch.Tensor, kernel: int, stride: int, pad: int):
    """(B, H, W, C) -> (B, P, Q, kernel * kernel * C), each field in
    (row, column, channel) order."""
    b, h, w, c = x.shape
    xp = torch.zeros((b, h + 2 * pad, w + 2 * pad, c), dtype=x.dtype,
                     device=x.device)
    xp[:, pad:pad + h, pad:pad + w] = x
    p = (h + 2 * pad - kernel) // stride + 1
    q = (w + 2 * pad - kernel) // stride + 1
    fields = [xp[:, r:r + stride * (p - 1) + 1:stride,
                 s:s + stride * (q - 1) + 1:stride]
              for r in range(kernel) for s in range(kernel)]
    return torch.stack(fields, dim=3).reshape(b, p, q, kernel * kernel * c)


def max_pool(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """VALID max pooling over H and W of (B, H, W, C)."""
    _, h, w, _ = x.shape
    p = (h - kernel) // stride + 1
    q = (w - kernel) // stride + 1
    out = None
    for r in range(kernel):
        for s in range(kernel):
            v = x[:, r:r + stride * (p - 1) + 1:stride,
                  s:s + stride * (q - 1) + 1:stride]
            out = v if out is None else torch.maximum(out, v)
    return out


def act_codes(rows: torch.Tensor, bits: int):
    """Per-row symmetric codes of (M, K) f32 rows: (codes, (M, 1) scale)."""
    qmax = float((1 << (bits - 1)) - 1)
    amax = rows.abs().amax(dim=1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / torch.full_like(amax, qmax)
    codes = torch.clamp(torch.round(rows / scale), -qmax, qmax)
    return codes, scale


def ternarize(w: torch.Tensor):
    """TWN of a (K, N) f32 weight: (codes in {-1, 0, 1} as f32, (N,) alpha)."""
    a = w.abs()
    delta = 0.7 * a.mean(dim=0, keepdim=True)
    keep = a > delta
    codes = torch.where(keep, torch.sign(w), torch.zeros_like(w))
    alpha = (a * keep).sum(dim=0) / keep.sum(dim=0).clamp_min(1)
    return codes, alpha


def levels(y: torch.Tensor, bits: int) -> torch.Tensor:
    """Paper eq. (4): ``round(clip(y, 0, 1) * L) / L``, L = 2**bits - 1."""
    n = (1 << bits) - 1
    return torch.round(torch.clamp(y, 0.0, 1.0) * n) / n


def qdense(rows: torch.Tensor, w: torch.Tensor, gamma, beta, bits: int,
           requant: bool, tf32: bool) -> torch.Tensor:
    """Steps 2-5 on (M, K) rows: (M, N)."""
    codes, scale = act_codes(rows, bits)
    wcodes, alpha = ternarize(w)
    acc = mm(codes, wcodes, tf32)
    y = torch.relu(acc * alpha[None, :] * scale * gamma + beta)
    return levels(y, bits) if requant else y


def qconv(x: torch.Tensor, w: torch.Tensor, gamma, beta, kernel: int,
          stride: int, pad: int, bits: int, requant: bool = True,
          tf32: bool = False) -> torch.Tensor:
    """A quantized conv of (B, H, W, C) with a (kernel*kernel*C, N) weight."""
    cols = im2col(x, kernel, stride, pad)
    b, p, q, k = cols.shape
    y = qdense(cols.reshape(-1, k), w, gamma, beta, bits, requant, tf32)
    return y.reshape(b, p, q, -1)


def layer(params: dict, key: str):
    """The float weight, gamma and beta of the layer ``key``."""
    return (params[f"{key}.qw"], params[f"{key}.bns_gamma"],
            params[f"{key}.bns_beta"])


def in_chunks(fn, x: torch.Tensor, chunk: int) -> torch.Tensor:
    """``fn`` over blocks of ``chunk`` images, concatenated."""
    return torch.cat([fn(x[i:i + chunk]) for i in range(0, x.shape[0], chunk)])
