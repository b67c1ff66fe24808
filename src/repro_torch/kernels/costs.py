"""The work of one launch of each CUDA kernel: (FLOPs, bytes).

These are the counts of the bound column of ``PERF.md`` §6 (and of
``chip_smoke.py``'s ``bound_ms``): each input read once and each output
written once, and the arithmetic the kernel does on them (2 M N K for a
matmul; 4 Dh a visible (query head, key) pair for attention, q.k and p.v;
3 an element for the activation quantizers).  The matmuls (B1, B3, B6) and
flash attention (B8) are bound by their operations, the rest by their
bytes.  The engine's dry-run branch (``engine`` on a fake tensor) adds
them up for the launches it stands in for; a benchmark reads the same
functions.

Where the work depends on the data (the positions a decode step reads),
these take the most it could need: every position of the cache or of the
page table's blocks is read.
"""
from __future__ import annotations

F32 = 4


def qmatmul(m: int, n: int, k: int, w_bits: int, a_bytes: float
            ) -> tuple[int, int]:
    """B1 ``ternary_matmul`` (``w_bits`` 2) and B3 ``packed_matmul``: x
    (M, K) codes or floats of ``a_bytes`` each, the (N, K) packed weight,
    its (N,) f32 scale, the f32 (M, N) output."""
    nbytes = m * k * a_bytes + n * k * w_bits / 8 + F32 * n + F32 * m * n
    return 2 * m * n * k, int(nbytes)


def binary_matmul(m: int, n: int, k: int) -> tuple[int, int]:
    """B6: x and w as bits (K / 8 bytes a row), the (N,) f32 scale, the f32
    (M, N) output."""
    return 2 * m * n * k, int(m * k / 8 + n * k / 8 + F32 * n + F32 * m * n)


def _attention_rows(rows: int, positions: int, kv: int, g: int, dh: int,
                    q_bytes: int, row_bytes: int, scaled: bool,
                    extra: int = 0) -> tuple[int, int]:
    """One query token of ``rows`` rows over ``positions`` positions each:
    q, K and V rows (and their f32 scales), the f32 output."""
    kv_row = row_bytes + (F32 if scaled else 0)
    nbytes = (rows * kv * g * dh * q_bytes + rows * positions * kv * 2 * kv_row
              + F32 * rows * kv * g * dh + extra)
    return rows * positions * kv * g * 4 * dh, nbytes


def decode_attention(b: int, s: int, kv: int, g: int, dh: int, q_bytes: int,
                     lse: bool = False) -> tuple[int, int]:
    """B5 over a dense int8 cache of ``s`` positions a row (every one read),
    the (B,) positions; with ``lse`` the (B, KV, G) f32 log-sum-exp too."""
    return _attention_rows(b, s, kv, g, dh, q_bytes, dh, True,
                           extra=F32 * b + (F32 * b * kv * g if lse else 0))


def paged_attention(rows: int, positions: int, kv: int, g: int, dh: int,
                    q_bytes: int, row_bytes: int, scaled: bool,
                    table: int) -> tuple[int, int]:
    """B2: ``rows`` rows over the ``positions`` of their page tables'
    blocks; ``table`` int32 page-table entries and the (rows,) positions."""
    return _attention_rows(rows, positions, kv, g, dh, q_bytes, row_bytes,
                           scaled, extra=F32 * (table + rows))


def fused_decode(rows: int, positions: int, kv: int, g: int, dh: int,
                 d: int, q_bytes: int, row_bytes: int, scaled: bool,
                 table: int, wo_bytes: int) -> tuple[int, int]:
    """B4: B2 plus the float ``wo`` (KV G Dh, D) of ``wo_bytes`` an element
    read once and its product, the f32 (rows, D) output in place of B2's."""
    flops, nbytes = paged_attention(rows, positions, kv, g, dh, q_bytes,
                                    row_bytes, scaled, table)
    k = kv * g * dh
    return (flops + 2 * rows * k * d,
            nbytes - F32 * rows * k + k * d * wo_bytes + F32 * rows * d)


def causal_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """Visible (query, key) pairs a head: queries and keys both at
    positions 0.. (the full-sequence attention of B8)."""
    if not causal:
        return sq * sk
    if window <= 0 or window >= sq:
        return sq * (sq + 1) // 2
    return window * (window + 1) // 2 + (sq - window) * window


def flash_attention(b: int, sq: int, sk: int, kv: int, g: int, dh: int,
                    in_bytes: int, causal: bool, window: int
                    ) -> tuple[int, int]:
    """B8: q (B, Sq, KV, G, Dh), k and v (B, Sk, KV, Dh) read once, the f32
    output written once; 4 Dh operations a visible pair, q.k and p.v, with
    or without ``probs_bf16`` (P and V rounded to bf16 first: the same
    products; :func:`flash_attention_mma` counts the product terms the
    tensor cores issue)."""
    pairs = causal_pairs(sq, sk, causal, window)
    nbytes = (b * sq * kv * g * dh * in_bytes + 2 * b * sk * kv * dh * in_bytes
              + F32 * b * sq * kv * g * dh)
    return 4 * dh * b * kv * g * pairs, nbytes


def flash_attention_mma(b: int, sq: int, sk: int, kv: int, g: int, dh: int,
                        in_bytes: int, causal: bool, window: int,
                        probs_bf16: bool = False) -> tuple[int, int]:
    """B8's tensor-core operations, (q.k, p.v), 2 Dh a visible pair a
    product term.  bf16 inputs: one bf16 term for q.k and two for p.v (P
    split into bf16 hi and lo), one with ``probs_bf16``.  f32 inputs: three
    TF32 terms for q.k and three for p.v; with ``probs_bf16`` p.v is one
    product of bf16 values, which bf16 tensor cores take exactly (the bf16
    peak applies to it, the TF32 peak to q.k)."""
    pairs = causal_pairs(sq, sk, causal, window)
    qk, pv = (1, 2) if in_bytes == 2 else (3, 3)
    if probs_bf16:
        pv = 1
    term = 2 * dh * b * kv * g * pairs
    return term * qk, term * pv


def act_quant_rows(m: int, f: int, in_bytes: int) -> tuple[int, int]:
    """B7c: x (M, F) read, int8 codes written, and the (M, 1) scale in x's
    dtype written (the row form) or read (the given-scale form)."""
    return 3 * m * f, in_bytes * m * f + m * f + in_bytes * m
