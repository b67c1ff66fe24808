"""Flash-decode attention over an int8-quantized dense KV cache — the
serving decode hot spot.

One new token's query attends to a seq_len cache of int8 codes with
per-(position, head) f32 scales; G = H/KV query heads share each KV head.

  q        : (B, KV, G, Dh)   bf16/f32
  k_codes  : (B, S, KV, Dh)   int8
  k_scale  : (B, S, KV, 1)    f32
  v_codes  : (B, S, KV, Dh)   int8
  v_scale  : (B, S, KV, 1)    f32
  pos      : int scalar or (B,) positions (mask: s <= pos[b])
  out      : (B, KV, G, Dh)   f32

On a CUDA tensor :func:`decode_attention` launches the hand-written kernel
in ``csrc/decode_attention.cu`` (it replaces the TPU kernel
``repro/kernels/decode_attention.py:decode_attention``); on a CPU tensor it
runs the plain version :func:`decode_attention_ref`.
"""
from __future__ import annotations

import torch

from repro_torch.core.packing import unpack_nibbles

from . import _build

_Q_KINDS = {torch.float32: 1, torch.bfloat16: 2}
_TS = 32                  # positions per tile in the kernel
_SMEM_LIMIT = 48 * 1024   # default dynamic shared memory per block


def _pos_vector(pos, b: int, device) -> torch.Tensor:
    return torch.as_tensor(pos, dtype=torch.int32, device=device
                           ).reshape(-1).expand(b).contiguous()


def smem_bytes(g: int, dh: int) -> int:
    """Dynamic shared memory of one kernel block (mirrors the .cu)."""
    return 4 * (_TS * (dh + 1) + _TS * dh + 2 * g * dh + g * _TS + 3 * g)


def decode_attention(q, k_codes, k_scale, v_codes, v_scale, pos
                     ) -> torch.Tensor:
    """Kernel wrapper: (B, KV, G, Dh) float32 attention output."""
    if not q.is_cuda:
        return decode_attention_ref(q, k_codes, k_scale, v_codes, v_scale, pos)
    b, kv, g, dh = q.shape
    s = k_codes.shape[1]
    if q.dtype not in _Q_KINDS:
        raise TypeError(f"q dtype {q.dtype} not in {list(_Q_KINDS)}")
    for name, t, shape, dt in (("k_codes", k_codes, (b, s, kv, dh), torch.int8),
                               ("v_codes", v_codes, (b, s, kv, dh), torch.int8),
                               ("k_scale", k_scale, (b, s, kv, 1), torch.float32),
                               ("v_scale", v_scale, (b, s, kv, 1), torch.float32)):
        if tuple(t.shape) != shape or t.dtype != dt:
            raise ValueError(f"{name}: expected {dt} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if smem_bytes(g, dh) > _SMEM_LIMIT:
        raise ValueError(f"G={g}, Dh={dh} needs {smem_bytes(g, dh)} B of shared "
                         f"memory per block (limit {_SMEM_LIMIT})")
    pos_v = _pos_vector(pos, b, q.device)
    for t in (q, k_codes, k_scale, v_codes, v_scale, pos_v):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"all operands must be contiguous on {q.device}")
    out = torch.empty((b, kv, g, dh), dtype=torch.float32, device=q.device)
    lib = _build.library("decode_attention")
    err = lib.decode_attention_int8(
        q.data_ptr(), _Q_KINDS[q.dtype], k_codes.data_ptr(), k_scale.data_ptr(),
        v_codes.data_ptr(), v_scale.data_ptr(), pos_v.data_ptr(), out.data_ptr(),
        b, s, kv, g, dh, dh ** -0.5, _build.stream_ptr(q))
    _build.check(err, "decode_attention")
    _build.LAUNCHES["decode_attention"] += 1
    return out


def decode_attention_ref(q, k_codes, k_scale, v_codes, v_scale, pos):
    """Plain version of the kernel: f32 dequant, masked softmax, weighted
    sum (the semantics of the Pallas kernel and its oracle)."""
    b, kv, g, dh = q.shape
    s = k_codes.shape[1]
    pos_b = _pos_vector(pos, b, q.device)
    k = k_codes.to(torch.float32) * k_scale                  # (B,S,KV,Dh)
    v = v_codes.to(torch.float32) * v_scale
    scores = torch.einsum("bkgd,bskd->bkgs", q.to(torch.float32), k) \
        * (dh ** -0.5)
    mask = (torch.arange(s, device=q.device)[None, :]
            <= pos_b[:, None])[:, None, None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgs,bskd->bkgd", probs, v)


def decode_attention_serving_ref(q, k_codes, k_scale, v_codes, v_scale,
                                 pos, *, kv_bits: int = 8,
                                 dtype=torch.float32):
    """The serving model's dense one-step decode attention, op-for-op as
    ``repro.kernels.decode_attention.decode_attention_serving_ref``: K/V are
    dequantized to the MODEL dtype, the grouped einsum and ``/ sqrt(dh)``
    follow ``layers._attend``, -1e30 mask fill, f32 softmax.  kv_bits=4
    nibble-unpacks the codes.  Returns (B, KV, G, Dh) in ``dtype``."""
    b, kv, g, dh = q.shape
    if kv_bits == 4:
        k_codes, v_codes = unpack_nibbles(k_codes), unpack_nibbles(v_codes)
    kk = (k_codes.to(torch.float32) * k_scale).to(dtype)
    vv = (v_codes.to(torch.float32) * v_scale).to(dtype)
    s = kk.shape[1]
    pos_b = _pos_vector(pos, b, q.device)
    qg = q.reshape(b, 1, kv, g, dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.to(torch.float32),
                          kk.to(torch.float32)) / (dh ** 0.5)
    mask = (torch.arange(s, device=q.device)[None, :]
            <= pos_b[:, None])[:, None, None, None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, vv.to(torch.float32))
    return out[:, 0].to(dtype)
