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
  lse      : (B, KV, G)       f32, with ``lse=True``: each head's
             log-sum-exp of its masked scores (-inf, and out 0, where no
             position is valid), what a sequence-parallel decode step
             combines the ranks' partial outputs by

On a CUDA tensor :func:`decode_attention` launches the hand-written kernel
in ``csrc/decode_attention.cu`` (it replaces the TPU kernel
``repro/kernels/decode_attention.py:decode_attention``); on a CPU tensor it
runs the plain version :func:`decode_attention_ref`.  The kernel is the
paged flash-decode core of ``paged_attention`` over the dense cache viewed
as a pool of B blocks of S positions (sequence b's one block is block b):
one block of eight warps per (sequence, KV head) while S <= 128, an 8-block
cluster above that (``csrc/paged_common.cuh``).  :func:`launch_plan`
reports the choice for a set of operands; ``plan=(cluster, span_max)``
launches another one through ``decode_attention_config`` (0 keeps the
automatic value), which is how the tuning cache's B5 plans run.
"""
from __future__ import annotations

import torch

from repro_torch.core.packing import unpack_nibbles

from . import _build

_Q_KINDS = {torch.float32: 1, torch.bfloat16: 2}
# dynamic shared memory a block of the flash-decode kernels (B5, B2, B4)
# may take: an H100's 227 KB (PA_SMEM_LIMIT of csrc/paged_common.cuh)
SMEM_LIMIT = 227 * 1024
# the C entry's answer to a plan above SMEM_LIMIT (cudaErrorLaunchOutOfResources)
_OUT_OF_SMEM = 701


def _pos_vector(pos, b: int, device) -> torch.Tensor:
    return torch.as_tensor(pos, dtype=torch.int32, device=device
                           ).reshape(-1).expand(b).contiguous()


def check_smem(nbytes: int, what: str) -> None:
    """Refuse a block that needs more shared memory than the kernels take."""
    if nbytes > SMEM_LIMIT:
        raise ValueError(f"{what} needs {nbytes} B of shared memory per block "
                         f"(limit {SMEM_LIMIT})")


def _plan(b: int, s: int, kv: int, g: int, dh: int, k_codes, v_codes):
    import ctypes
    plan = (ctypes.c_int * 4)()
    _build.library("decode_attention").decode_attention_plan(
        b, s, kv, g, dh, k_codes.data_ptr(), v_codes.data_ptr(), plan)
    return plan


def launch_plan(q, k_codes, v_codes) -> dict:
    """The kernel's launch plan for these operands: ``vector`` (16-byte
    loads; else scalar loads), ``cluster`` (blocks a (sequence, KV head)),
    ``span`` (positions a warp's span) and ``smem`` (bytes of one block)."""
    b, kv, g, dh = q.shape
    plan = _plan(b, k_codes.shape[1], kv, g, dh, k_codes, v_codes)
    return {"vector": bool(plan[0]), "cluster": plan[1], "span": plan[2],
            "smem": plan[3]}


def decode_attention(q, k_codes, k_scale, v_codes, v_scale, pos, *,
                     plan: tuple[int, int] | None = None, lse: bool = False):
    """Kernel wrapper: (B, KV, G, Dh) float32 attention output, and with
    ``lse`` the (B, KV, G) float32 log-sum-exp beside it (a tuple).
    ``plan`` is (cluster size 0..8, span limit 0..32), 0 the automatic
    value (None: both automatic); the plain version ignores it."""
    if not q.is_cuda:
        return decode_attention_ref(q, k_codes, k_scale, v_codes, v_scale,
                                    pos, lse=lse)
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
    pos_v = _pos_vector(pos, b, q.device)
    for t in (q, k_codes, k_scale, v_codes, v_scale, pos_v):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"all operands must be contiguous on {q.device}")
    cluster, span_max = plan if plan is not None else (0, 0)
    if not (0 <= cluster <= 8 and 0 <= span_max <= 32):
        raise ValueError(f"plan {plan}: cluster 0..8, span limit 0..32")
    out = torch.empty((b, kv, g, dh), dtype=torch.float32, device=q.device)
    lse_t = torch.empty((b, kv, g), dtype=torch.float32, device=q.device) \
        if lse else None
    err = _build.library("decode_attention").decode_attention_config(
        q.data_ptr(), _Q_KINDS[q.dtype], k_codes.data_ptr(), k_scale.data_ptr(),
        v_codes.data_ptr(), v_scale.data_ptr(), pos_v.data_ptr(), out.data_ptr(),
        None if lse_t is None else lse_t.data_ptr(), b, s, kv, g, dh, cluster,
        span_max, _build.stream_ptr(q))
    if err == _OUT_OF_SMEM:
        if cluster or span_max:
            raise ValueError(f"plan {plan} needs more than {SMEM_LIMIT} B of "
                             f"shared memory per block (G={g}, Dh={dh}, S={s})")
        check_smem(_plan(b, s, kv, g, dh, k_codes, v_codes)[3],
                   f"G={g}, Dh={dh}, S={s}")
    _build.check(err, "decode_attention")
    _build.LAUNCHES["decode_attention"] += 1
    return (out, lse_t) if lse else out


def masked_lse(scores, mask, out):
    """(``out`` with rows of no valid position zeroed, the log-sum-exp of
    ``scores`` over ``mask``'s true entries along the last dim, -inf where
    there is none): the kernel's lse output in plain PyTorch.  ``out`` has
    the scores' leading dims and one more."""
    lse = torch.logsumexp(torch.where(mask, scores, torch.full_like(
        scores, float("-inf"))), dim=-1)
    out = torch.where(torch.isneginf(lse)[..., None], torch.zeros_like(out),
                      out)
    return out, lse


def decode_attention_ref(q, k_codes, k_scale, v_codes, v_scale, pos, *,
                         lse: bool = False):
    """Plain version of the kernel: f32 dequant, masked softmax, weighted
    sum (the semantics of the Pallas kernel and its oracle); with ``lse``
    also the log-sum-exp (:func:`masked_lse`)."""
    b, kv, g, dh = q.shape
    s = k_codes.shape[1]
    pos_b = _pos_vector(pos, b, q.device)
    k = k_codes.to(torch.float32) * k_scale                  # (B,S,KV,Dh)
    v = v_codes.to(torch.float32) * v_scale
    scores = torch.einsum("bkgd,bskd->bkgs", q.to(torch.float32), k) \
        * (dh ** -0.5)
    mask = (torch.arange(s, device=q.device)[None, :]
            <= pos_b[:, None])[:, None, None, :]
    probs = torch.softmax(torch.where(mask, scores,
                                      torch.full_like(scores, -1e30)), dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v)
    return masked_lse(scores, mask, out) if lse else out


def decode_attention_serving_ref(q, k_codes, k_scale, v_codes, v_scale,
                                 pos, *, kv_bits: int = 8,
                                 dtype=torch.float32, lse: bool = False):
    """The serving model's dense one-step decode attention, op-for-op as
    ``repro.kernels.decode_attention.decode_attention_serving_ref``: K/V are
    dequantized to the MODEL dtype, the grouped einsum and ``/ sqrt(dh)``
    follow ``layers._attend``, -1e30 mask fill, f32 softmax.  kv_bits=4
    nibble-unpacks the codes; the scales are None iff kv_bits=16 (raw
    model-dtype storage).  Returns (B, KV, G, Dh) in ``dtype``; with
    ``lse`` (the partial of a sequence-parallel step) the output in f32
    and the (B, KV, G) log-sum-exp (:func:`masked_lse`)."""
    b, kv, g, dh = q.shape
    if kv_bits == 4:
        k_codes, v_codes = unpack_nibbles(k_codes), unpack_nibbles(v_codes)
    if k_scale is None:
        kk, vv = k_codes.to(dtype), v_codes.to(dtype)
    else:
        kk = (k_codes.to(torch.float32) * k_scale).to(dtype)
        vv = (v_codes.to(torch.float32) * v_scale).to(dtype)
    s = kk.shape[1]
    pos_b = _pos_vector(pos, b, q.device)
    qg = q.reshape(b, 1, kv, g, dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.to(torch.float32),
                          kk.to(torch.float32)) / (dh ** 0.5)
    mask = (torch.arange(s, device=q.device)[None, :]
            <= pos_b[:, None])[:, None, None, None, :]
    probs = torch.softmax(torch.where(mask, scores,
                                      torch.full_like(scores, -1e30)), dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, vv.to(torch.float32))
    if lse:
        o, l = masked_lse(scores[:, :, :, 0], mask[:, :, :, 0], out[:, 0])
        return o, l
    return out[:, 0].to(dtype)
