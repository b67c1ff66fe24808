"""Paged flash-decode attention — gather K/V through a page table.

The KV cache lives in a pool of fixed-size blocks (``runtime.kvcache``):
each request's blocks are named by its page-table row, so memory is
allocated per block and blocks can be shared between requests (radix prefix
cache).  One new token's query per sequence attends over that sequence's
blocks.

  q          : (B, KV, G, Dh)    f32/bf16
  k_pool     : (NB, bs, KV, Dh') int8 codes (kv_bits 8; Dh' = Dh/2 nibble
                                 pairs for 4) or float (kv_bits 16)
  k_scale    : (NB, bs, KV, 1)   f32 per-(position, head) (None for 16)
  v_pool     : (NB, bs, KV, Dh') like k_pool
  v_scale    : (NB, bs, KV, 1)   like k_scale
  page_table : (B, n_blocks)     int32 physical block ids
  pos        : (B,)              int32 (mask: s <= pos[b])
  out        : (B, KV, G, Dh)    f32

On a CUDA tensor :func:`paged_attention` launches the hand-written kernel
in ``csrc/paged_attention.cu`` (it replaces the TPU kernel
``repro/kernels/paged_attention.py:paged_attention``); on a CPU tensor it
runs :func:`paged_attention_ref` with ``out_dtype=float32``.  The kernel
runs one thread-block cluster per (sequence, KV head): one block of eight
warps while spans of 16 positions give each warp at most one (``n_blocks *
bs`` <= 128 at bs 16), eight blocks above that; the warps take spans of
whole pool blocks with 16-byte loads and their partials merge in a fixed
order (``csrc/paged_common.cuh``).  :func:`launch_plan` reports the choice
for a set of operands.

:func:`paged_attention_ref` has two roles, as in the reference: with
``out_dtype=float32`` it has the kernel's semantics (K/V dequantized in
f32); with the model dtype it is the serving path's ``torch`` backend.
"""
from __future__ import annotations

import torch

from . import _build
from .decode_attention import (_Q_KINDS, _pos_vector, check_smem,
                               decode_attention_serving_ref)

KV_BITS = (16, 8, 4)
_CODE_KINDS = {8: 0, 4: 1}                    # int codes + f32 scales
_RAW_KINDS = {torch.float32: 2, torch.bfloat16: 3}


def gather_pool(pool_leaf, page_table):
    """Dense (B, n_blocks*bs, ...) view of a pooled leaf (NB, bs, ...)
    through ``page_table`` (B, n_blocks)."""
    g = pool_leaf[page_table.long()]             # (B, n_blocks, bs, ...)
    return g.reshape(g.shape[0], g.shape[1] * g.shape[2], *g.shape[3:])


def paged_attention_ref(q, k_pool, k_scale, v_pool, v_scale, page_table,
                        pos, *, kv_bits: int = 8, out_dtype=torch.float32):
    """Plain version: gather the blocks dense, then the serving model's
    dense decode attention (``decode_attention_serving_ref``) over the
    view, op for op as ``repro.kernels.paged_attention.paged_attention_ref``.
    """
    def gather(leaf):
        return None if leaf is None else gather_pool(leaf, page_table)
    return decode_attention_serving_ref(
        q, gather(k_pool), gather(k_scale), gather(v_pool), gather(v_scale),
        pos, kv_bits=kv_bits, dtype=out_dtype)


def pool_operands(q, k_pool, k_scale, v_pool, v_scale, page_table, pos,
                  kv_bits: int):
    """Check the operands of a paged kernel on the card and return
    ``(kv_kind, NB, bs, n_blocks, pos (B,) int32)``; raises on anything
    the kernels do not take."""
    if q.dim() != 4 or q.dtype not in _Q_KINDS:
        raise TypeError(f"q must be (B, KV, G, Dh) in {list(_Q_KINDS)}, got "
                        f"{q.dtype} {tuple(q.shape)}")
    b, kv, g, dh = q.shape
    if kv_bits not in KV_BITS:
        raise ValueError(f"kv_bits must be one of {KV_BITS}, got {kv_bits}")
    if (k_scale is None) != (kv_bits == 16) or \
            (v_scale is None) != (kv_bits == 16):
        raise ValueError("k_scale/v_scale must be None iff kv_bits == 16")
    nb_pool, bs = k_pool.shape[0], k_pool.shape[1]
    if kv_bits == 16:
        if k_pool.dtype not in _RAW_KINDS:
            raise TypeError(f"kv16 pool dtype {k_pool.dtype} not in "
                            f"{list(_RAW_KINDS)}")
        kind, pool_dt, dh_store = _RAW_KINDS[k_pool.dtype], k_pool.dtype, dh
    else:
        if kv_bits == 4 and dh % 2:
            raise ValueError(f"kv4 needs an even Dh, got {dh}")
        kind, pool_dt = _CODE_KINDS[kv_bits], torch.int8
        dh_store = dh // 2 if kv_bits == 4 else dh
    expect = [("k_pool", k_pool, (nb_pool, bs, kv, dh_store), pool_dt),
              ("v_pool", v_pool, (nb_pool, bs, kv, dh_store), pool_dt)]
    if kv_bits < 16:
        expect += [("k_scale", k_scale, (nb_pool, bs, kv, 1), torch.float32),
                   ("v_scale", v_scale, (nb_pool, bs, kv, 1), torch.float32)]
    if page_table.dim() != 2 or page_table.shape[0] != b:
        raise ValueError(f"page_table must be (B={b}, n_blocks), got "
                         f"{tuple(page_table.shape)}")
    expect.append(("page_table", page_table, tuple(page_table.shape),
                   torch.int32))
    for name, t, shape, dt in expect:
        if tuple(t.shape) != shape or t.dtype != dt:
            raise ValueError(f"{name}: expected {dt} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    pos_v = _pos_vector(pos, b, q.device)
    for t in (q, pos_v) + tuple(t for _, t, _, _ in expect):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"all operands must be contiguous on {q.device}")
    return kind, nb_pool, bs, page_table.shape[1], pos_v


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def launch_plan(kv_kind: int, b: int, kv: int, g: int, dh: int, bs: int,
                n_blocks: int, k_pool, v_pool) -> dict:
    """The paged kernels' launch plan for these operands: ``vector`` (16-byte
    loads; else scalar loads), ``cluster`` (blocks a (sequence, KV head))
    and ``span`` (positions a warp's span)."""
    import ctypes
    plan = (ctypes.c_int * 3)()
    _build.library("paged_attention").paged_attention_plan(
        kv_kind, b, kv, g, dh, bs, n_blocks, _ptr(k_pool), _ptr(v_pool), plan)
    return {"vector": bool(plan[0]), "cluster": plan[1], "span": plan[2]}


def paged_attention(q, k_pool, k_scale, v_pool, v_scale, page_table, pos, *,
                    kv_bits: int = 8) -> torch.Tensor:
    """Kernel wrapper: (B, KV, G, Dh) float32 attention output."""
    if not q.is_cuda:
        return paged_attention_ref(q, k_pool, k_scale, v_pool, v_scale,
                                   page_table, pos, kv_bits=kv_bits,
                                   out_dtype=torch.float32)
    kind, nb_pool, bs, n_blocks, pos_v = pool_operands(
        q, k_pool, k_scale, v_pool, v_scale, page_table, pos, kv_bits)
    b, kv, g, dh = q.shape
    lib = _build.library("paged_attention")
    check_smem(lib.paged_attention_smem_bytes(kind, b, kv, g, dh, bs, n_blocks,
                                              k_pool.data_ptr(), v_pool.data_ptr()),
               f"G={g}, Dh={dh}, bs={bs}")
    out = torch.empty((b, kv, g, dh), dtype=torch.float32, device=q.device)
    err = lib.paged_attention(
        q.data_ptr(), _Q_KINDS[q.dtype], k_pool.data_ptr(), _ptr(k_scale),
        v_pool.data_ptr(), _ptr(v_scale), kind, page_table.data_ptr(),
        pos_v.data_ptr(), out.data_ptr(), b, nb_pool, bs, n_blocks, kv, g, dh,
        _build.stream_ptr(q))
    _build.check(err, "paged_attention")
    _build.LAUNCHES["paged_attention"] += 1
    return out
