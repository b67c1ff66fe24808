"""Full-sequence flash attention — whole-prompt prefill and the forward.

  q   : (B, Sq, KV, G, Dh)  f32 or bf16 (G query heads share a KV head)
  k, v: (B, Sk, KV, Dh)     the same type
  out : (B, Sq, KV, G, Dh)  f32

Query and key positions both count from 0; causal (``k_pos <= q_pos``),
sliding-window (``k_pos > q_pos - window``) and tanh-softcap masks, or with
``causal=False`` none (Sq and Sk independent: an encoder's self-attention,
a cross-attention); f32 softmax.  ``probs_bf16`` (the reference's
``attn_probs_bf16``) rounds P and V to bf16 for P.V, accumulated in f32,
with the running max over the kernel's own key tiles (64 keys for bf16
inputs, 32 for f32; ``ref.flash_attention_ref`` repeats them).  On a CUDA
tensor :func:`flash_attention` launches the hand-written kernel in
``csrc/flash_attention.cu`` (it replaces the TPU kernel
``repro/kernels/flash_attention.py:flash_attention``); on a CPU tensor it
runs the plain version, :func:`repro_torch.kernels.ref.flash_attention_ref`.
The kernel is chosen by dtype: bf16 inputs run on the bf16 tensor cores
(``mma.sync`` bf16, P split into two bf16 terms), f32 inputs on the TF32
tensor cores in three products (every operand split into two TF32 terms,
hi.hi + hi.lo + lo.hi); neither falls back to the other.  With
``probs_bf16`` the bf16 kernel takes P as one bf16 term and the f32 kernel
runs P.V as one TF32 product of bf16 values (both template flags of the
same kernels).  q, k and v must start on a 16-byte boundary (both kernels
copy rows with 16-byte ``cp.async``); fresh allocations do.

The TPU kernel has no backward, so neither has this one: the wrapper
refuses CUDA inputs that require a gradient rather than return a result
that silently carries none.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import flash_attention_ref

_KINDS = {torch.float32: 1, torch.bfloat16: 2}
HEAD_DIMS = (32, 64, 96, 112, 128)  # Dh the kernel is built for


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0,
                    probs_bf16: bool = False) -> torch.Tensor:
    """(B, Sq, KV, G, Dh) float32 attention output."""
    if not q.is_cuda:
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, probs_bf16=probs_bf16)
    if q.dim() != 5 or k.dim() != 4:
        raise ValueError(f"q must be (B, Sq, KV, G, Dh) and k/v (B, Sk, KV, "
                         f"Dh); got {tuple(q.shape)}, {tuple(k.shape)}")
    b, sq, kv, g, dh = q.shape
    sk = k.shape[1]
    if tuple(k.shape) != (b, sk, kv, dh) or k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if q.dtype not in _KINDS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of {list(_KINDS)}; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"Dh={dh}: the kernel takes Dh in {HEAD_DIMS}")
    for t in (q, k, v):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"q, k, v must be contiguous on {q.device}")
        if t.data_ptr() % 16:
            raise ValueError("q, k, v must start on a 16-byte boundary (the "
                             "kernels copy rows with 16-byte cp.async)")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention has no backward (neither has the "
                           "TPU kernel it ports); call it under "
                           "torch.no_grad() or on tensors that need no grad")
    out = torch.empty((b, sq, kv, g, dh), dtype=torch.float32, device=q.device)
    if out.numel() == 0 or sk == 0:
        return out.zero_()
    lib = _build.library("flash_attention")
    err = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _KINDS[q.dtype],
        out.data_ptr(), b, sq, sk, kv, g, dh, int(causal), int(window),
        int(probs_bf16), float(softcap), dh ** -0.5, _build.stream_ptr(q))
    _build.check(err, "flash_attention")
    _build.LAUNCHES["flash_attention"] += 1
    return out
