"""Fused ragged decode: page-table gather + KV dequant + flash-decode +
output projection in one kernel launch per layer, over live slots only.

  q          : (B, KV, G, Dh)    padded batch of current-token queries
  k/v pool   : (NB, bs, KV, Dh') int8 codes (kv_bits<=8) or float (16)
  k/v scale  : (NB, bs, KV, 1)   f32 per-(position, head) (None for 16)
  page_table : (B, n_blocks)     int32
  pos        : (B,)              int32
  slot_map   : (L,)              int32 live slot ids (may repeat a slot)
  wo         : (KV*G*Dh, D)      output-projection weight, read in f32
  out        : (L, D)            f32, compact over live slots

On a CUDA tensor :func:`fused_decode` launches the hand-written kernel in
``csrc/decode_fused.cu`` (it replaces the TPU kernel
``repro/kernels/decode_fused.py:fused_decode``); on a CPU tensor it runs
:func:`fused_decode_ref` with ``out_dtype=float32``.  Callers scatter the
compact rows back to the padded batch.  The kernel runs one cluster of
eight blocks per live slot: each (slot, KV head) attention is computed once
(the paged core of ``csrc/paged_common.cuh``) and shared through
distributed shared memory; each block projects one eighth of ``wo``'s rows
(copied into its shared memory while the attention runs) onto all columns,
and the blocks' sums of a column add in a fixed order.
"""
from __future__ import annotations

import torch

from . import _build
from .decode_attention import _Q_KINDS, _pos_vector, check_smem
from .paged_attention import _ptr, paged_attention_ref, pool_operands


def fused_decode_ref(q, k_pool, k_scale, v_pool, v_scale, page_table, pos,
                     slot_map, wo, *, kv_bits: int = 8,
                     out_dtype=torch.float32):
    """Plain version: gather the live rows, run the paged-attention plain
    version in f32, project through ``wo`` in f32 — op for op as
    ``repro.kernels.decode_fused.fused_decode_ref``."""
    sm = slot_map.long()
    ql = q[sm]
    pos_b = _pos_vector(pos, q.shape[0], q.device)
    attn = paged_attention_ref(ql, k_pool, k_scale, v_pool, v_scale,
                               page_table[sm], pos_b[sm], kv_bits=kv_bits,
                               out_dtype=torch.float32)
    flat = attn.reshape(ql.shape[0], -1)
    return (flat @ wo.to(torch.float32)).to(out_dtype)


def fused_decode(q, k_pool, k_scale, v_pool, v_scale, page_table, pos,
                 slot_map, wo, *, kv_bits: int = 8) -> torch.Tensor:
    """Kernel wrapper: compact (L, D) float32 projected attention of the
    slots in ``slot_map``."""
    if not q.is_cuda:
        return fused_decode_ref(q, k_pool, k_scale, v_pool, v_scale,
                                page_table, pos, slot_map, wo,
                                kv_bits=kv_bits, out_dtype=torch.float32)
    kind, nb_pool, bs, n_blocks, pos_v = pool_operands(
        q, k_pool, k_scale, v_pool, v_scale, page_table, pos, kv_bits)
    b, kv, g, dh = q.shape
    wo = wo.to(torch.float32).contiguous()          # read in f32, as the TPU wrapper
    if wo.dim() != 2 or wo.shape[0] != kv * g * dh:
        raise ValueError(f"wo must be ({kv * g * dh}, D), got {tuple(wo.shape)}")
    if slot_map.dim() != 1 or slot_map.dtype != torch.int32 or \
            slot_map.numel() == 0:
        raise ValueError(f"slot_map must be a non-empty (L,) int32 tensor, got "
                         f"{slot_map.dtype} {tuple(slot_map.shape)}")
    for t in (wo, slot_map):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"all operands must be contiguous on {q.device}")
    n_live, d = slot_map.shape[0], wo.shape[1]
    lib = _build.library("decode_fused")
    check_smem(lib.fused_decode_smem_bytes(kind, kv, g, dh, d, bs, n_blocks,
                                           k_pool.data_ptr(), v_pool.data_ptr(),
                                           wo.data_ptr()),
               f"KV={kv}, G={g}, Dh={dh}, D={d}, bs={bs}")
    out = torch.empty((n_live, d), dtype=torch.float32, device=q.device)
    err = lib.fused_decode(
        q.data_ptr(), _Q_KINDS[q.dtype], k_pool.data_ptr(), _ptr(k_scale),
        v_pool.data_ptr(), _ptr(v_scale), kind, page_table.data_ptr(),
        pos_v.data_ptr(), slot_map.data_ptr(), wo.data_ptr(), out.data_ptr(),
        b, n_live, nb_pool, bs, n_blocks, kv, g, dh, d, _build.stream_ptr(q))
    _build.check(err, "fused_decode")
    _build.LAUNCHES["fused_decode"] += 1
    return out
