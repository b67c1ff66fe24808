"""Bit packing — k-bit codes in int32 words, identical to ``repro.core.packing``.

k-bit codes (k in {1, 2, 4, 8}) are packed little-endian into int32 words:
32/k codes per word.  Signed codes are stored in two's complement within
their k-bit field; binary {-1,+1} is stored as the 1-bit field {0,1}.

torch has no uint32 arithmetic and ``>>`` on int32 is an arithmetic shift,
so words are widened to int64 before shifting and every field is masked:
the resulting int32 words are bit-identical to the JAX package's.
"""
from __future__ import annotations

import torch

PACK_DTYPE = torch.int32
WORD_BITS = 32


def codes_per_word(bits: int) -> int:
    if bits not in (1, 2, 4, 8):
        raise ValueError(f"packable bit-widths are 1/2/4/8, got {bits}")
    return WORD_BITS // bits


def _shifts(n: int, bits: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device) * bits


def pack(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack integer codes along the LAST axis into int32 words.

    Values must fit in ``bits`` signed (or {0,1} for bits == 1); the last
    axis must be a multiple of 32/bits."""
    n = codes_per_word(bits)
    *lead, k = codes.shape
    if k % n:
        raise ValueError(f"last axis {k} not a multiple of {n} for {bits}-bit packing")
    mask = (1 << bits) - 1
    c = codes.to(torch.int64) & mask                      # two's-complement field
    c = c.reshape(*lead, k // n, n)
    word = (c << _shifts(n, bits, codes.device)).sum(dim=-1)  # disjoint fields
    # fold the unsigned 32-bit word into int32's range (two's complement)
    word = torch.where(word >= (1 << 31), word - (1 << 32), word)
    return word.to(PACK_DTYPE)


def unpack(words: torch.Tensor, bits: int, signed: bool = True) -> torch.Tensor:
    """Inverse of :func:`pack`: int8 codes, last axis expanded 32/bits.
    ``signed`` sign-extends each field (two's complement)."""
    n = codes_per_word(bits)
    mask = (1 << bits) - 1
    w = words.to(torch.int64) & 0xFFFFFFFF
    fields = (w.unsqueeze(-1) >> _shifts(n, bits, words.device)) & mask
    fields = fields.reshape(*words.shape[:-1], words.shape[-1] * n)
    if signed and bits > 1:
        sign_bit = 1 << (bits - 1)
        fields = torch.where(fields >= sign_bit, fields - (1 << bits), fields)
    return fields.to(torch.int8)


def pack_binary_pm1(codes_pm1: torch.Tensor) -> torch.Tensor:
    """Binary weights {-1,+1} -> 1-bit fields {0,1} packed into int32."""
    return pack((codes_pm1 > 0).to(torch.int8), 1)


def unpack_binary_pm1(words: torch.Tensor) -> torch.Tensor:
    """Inverse: 1-bit {0,1} -> {-1,+1} int8."""
    b = unpack(words, 1, signed=False)
    return (2 * b.to(torch.int16) - 1).to(torch.int8)


def pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """int8 codes in [-7, 7], even last dim -> int8 bytes holding two
    codes (two's-complement 4-bit fields, low nibble first) — the 4-bit
    KV-cache layout."""
    lo = codes[..., 0::2].to(torch.int16) & 0xF
    hi = (codes[..., 1::2].to(torch.int16) & 0xF) << 4
    b = lo | hi
    return torch.where(b >= 128, b - 256, b).to(torch.int8)


def unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_nibbles`: sign-extended int8 codes, last
    axis doubled."""
    b = packed.to(torch.int16) & 0xFF
    lo = b & 0xF
    hi = b >> 4
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    out = torch.stack([lo, hi], dim=-1).to(torch.int8)
    return out.reshape(*packed.shape[:-1], packed.shape[-1] * 2)



def packed_last_dim(k: int, bits: int) -> int:
    """Length of the packed last axis for an unpacked length k."""
    n = codes_per_word(bits)
    if k % n:
        raise ValueError(f"{k} not a multiple of {n}")
    return k // n
