"""Layer library — the LM layers of ``repro.models.layers`` in PyTorch:
attention, the dense FFN, the token-choice MoE FFN and the Mamba-1 mixer.

Params are plain nested dicts of tensors.  A quantized linear ("qlinear")
has two forms:

  init/float : {"qw": (K, N) float}
  serving    : {"wt_packed": (N, KW) int32   — bit-packed W^T (or int8 codes
                "scale": (N,) f32}             when K doesn't pack), produced
                                               by convert.to_serving()

Serving matmuls go through the precision-dispatch engine; the dense KV
cache is int8/int4 codes with per-(position, head) scales, or the model
dtype when ``kv_bits`` is 0.  Full-sequence attention (a whole-prompt
prefill, the forward) goes through ``engine.flash_attention`` on the card
and through the reference's ``_attend`` / ``_attend_flash`` on the CPU,
causal (``_attend_full``) or with no mask (``_attend_all``: the enc-dec
encoder and cross-attention).  Under autograd (gradients enabled and an
input that requires one) both take the reference's training attention,
``_attend`` / ``_attend_flash``, on every device: the reference trains
through its jnp attention and never through its flash kernel, and the
port's kernel has no backward.

Unlike the JAX package, the cached attention paths update the cache (and
the paged block pool) IN PLACE and return the same dict: a serving step
never copies the cache.  The MoE and Mamba layers return new values as the
reference does (``moe_apply`` its auxiliary loss, ``mamba_apply`` its
recurrent state); the model copies a state into its cache.

The expert product (``engine.qmatmul_experts``) and the selective scan are
plain PyTorch on every device: the reference computes both outside any
Pallas kernel.

Over a mesh (``shard``, a :class:`repro_torch.parallel.comm.StepSharding`,
passed down with each call as ``backend`` is) the params hold this rank's
slices under ``parallel.sharding.param_specs``: a column-parallel
projection (``wq``, ``wk``, ``wv``, ``w_gate``, ``w_up``) yields this
rank's heads or hidden units, a row-parallel one (``wo``, ``w_down``)
takes them and ends in one all-reduce over the model axis
(:func:`qlinear_apply`'s ``reduce``), heads are counted from the weights,
the MoE layer computes this rank's experts and a Mamba layer its slice of
d_inner.  A decode step over a cache cut over its sequence
(``shard.seq``) attends this rank's positions and combines the partials
by their log-sum-exp (:func:`_decode_seq_parallel`); expert weights whose
K the FSDP rule cuts over data (``shard.fsdp``) are gathered where they
are used, and gathered again in the backward (:func:`_fsdp_experts`).
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from repro_torch.core.packing import pack_nibbles, unpack_nibbles
from repro_torch.core.precision import A_FLOAT, W_FLOAT, get_precision, signed
from repro_torch.core.quantize import (act_fake_quant, true_div,
                                       weight_fake_quant)
from repro_torch.kernels import engine
from repro_torch.kernels.decode_attention import masked_lse
from repro_torch.kernels.paged_attention import gather_pool

from .config import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def pdtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _randn(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Standard normal f32 drawn on the generator's device, then moved; on
    the meta device an empty tensor of the shape, nothing drawn (the
    params' global shapes: ``init(generator, "meta")``)."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=generator.device).to(device)


# ---------------------------------------------------------------------------
# qlinear
# ---------------------------------------------------------------------------
def qlinear_init(generator, k: int, n: int, cfg: ModelConfig, device):
    return {"qw": (_randn(generator, (k, n), device) * k ** -0.5
                   ).to(pdtype(cfg))}


def qlinear_apply(p, x, cfg: ModelConfig, backend: str | None = None,
                  reduce=None, shard=None):
    """x @ W under the model's PrecisionConfig.  Dispatches on param form:
    packed serving weights go through ``engine.qmatmul``; float weights of a
    float config are a plain matmul; float weights of a quantized config
    take the reference's fake-quant (QAT) forward, plain on every device:
    activations fake-quantized with ONE absmax scale over the whole tensor
    (so a row's result depends on the other rows of the call), times the
    fake-quantized weights.  Gradients pass straight through (STE).

    ``reduce``: the model axis of a row-parallel projection (``x`` and the
    weight hold this rank's slice of K): packed weights take
    ``engine.qmatmul``'s split form (the one-rank result bit for bit at
    integer activations), float weights sum their partial products over the
    axis in f32 (the fake-quant form with the weight's per-channel
    statistics and the activation scale taken over the whole K).
    ``shard``: the call's :class:`~repro_torch.parallel.comm.StepSharding`;
    in a train step (``global_rows``) the fake-quant activation scale is
    the max over every rank, the whole global batch's."""
    pcfg = signed(get_precision(cfg.precision))
    if "wt_packed" in p:
        pw = engine.as_packed_weight(p, pcfg)
        return engine.qmatmul(x, pw, pcfg, backend=backend,
                              reduce=reduce).to(pdtype(cfg))
    if pcfg.w_mode == W_FLOAT:
        out = x @ p["qw"].to(x.dtype)
    else:
        if pcfg.a_mode != A_FLOAT:
            every = shard.every() if shard is not None and \
                shard.global_rows else reduce
            kw = {} if every is None else {"reduce": every}
            x = act_fake_quant(x.to(torch.float32), pcfg, **kw).to(x.dtype)
        out = engine.fake_quant_dot(x, p["qw"], pcfg, axis=0, reduce=reduce)
    return out if reduce is None else \
        reduce.all_reduce_sum(out.to(torch.float32)).to(out.dtype)


def _column_split(shard, p, full_n: int):
    """The model axis when projection ``p`` holds a column slice of its
    ``full_n`` outputs (``param_specs`` cut its N), else None."""
    if shard is None or shard.tp is None or shard.tp.size == 1:
        return None
    n = p["qw"].shape[-1] if "qw" in p else p["wt_packed"].shape[-2]
    return shard.tp if n != full_n else None


def _row_parallel(shard, x, full_k: int):
    """The model axis when ``x`` holds a slice of a row-parallel
    projection's K of ``full_k`` (its weight K-sharded by ``param_specs``),
    else None (one device, or the projection replicated)."""
    if shard is None or shard.tp is None or x.shape[-1] == full_k:
        return None
    return shard.tp


# ---------------------------------------------------------------------------
# norms / rope / activations
# ---------------------------------------------------------------------------
def rmsnorm_init(d: int, device):
    return {"g": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(p, x, eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["g"]).to(x.dtype)


def _act(x, kind: str):
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default
    raise ValueError(kind)


def rope(x, positions, theta: float):
    """x: (B, S, H, Dh); positions: (B, S) int."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].to(torch.float32) * freqs       # (B,S,half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _softcap(x, cap: float):
    if cap <= 0:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# attention (GQA + RoPE + sliding window + softcap + quantized KV cache)
# ---------------------------------------------------------------------------
def attn_init(generator, cfg: ModelConfig, device):
    """With ``cfg.post_norms``, an RMSNorm on the sub-block's output
    (gemma2)."""
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh
    p = {
        "norm": rmsnorm_init(d, device),
        "wq": qlinear_init(generator, d, h * dh, cfg, device),
        "wk": qlinear_init(generator, d, kv * dh, cfg, device),
        "wv": qlinear_init(generator, d, kv * dh, cfg, device),
        "wo": qlinear_init(generator, h * dh, d, cfg, device),
    }
    if cfg.post_norms:
        p["post_norm"] = rmsnorm_init(d, device)
    return p


def _post_norm(p, out, cfg: ModelConfig):
    """The sub-block's post-norm where its params carry one (gemma2)."""
    if "post_norm" in p:
        return rmsnorm(p["post_norm"], out, cfg.norm_eps)
    return out


def _kv_quantize(k, v, bits: int):
    """Symmetric per-(token, head) KV quantization; scales are per position
    so appends never re-scale history.  bits=4 nibble-packs along Dh.  The
    scale is a true quotient on every device (:func:`true_div`)."""
    qmax = (1 << (bits - 1)) - 1

    def q(t):
        s = true_div(t.abs().amax(dim=3, keepdim=True).clamp_min(1e-6), qmax)
        codes = torch.clamp(torch.round(t / s), -qmax, qmax).to(torch.int8)
        if bits == 4:
            codes = pack_nibbles(codes)
        return codes, s.to(torch.float32)

    kq, ks = q(k.to(torch.float32))
    vq, vs = q(v.to(torch.float32))
    return kq, ks, vq, vs


def _kv_dequant(codes, s, dtype, bits: int = 8):
    if bits == 4:
        codes = unpack_nibbles(codes)
    return (codes.to(torch.float32) * s).to(dtype)


def _attend(q, k, v, mask, cfg: ModelConfig):
    """q: (B,Sq,H,Dh) k/v: (B,Sk,KV,Dh); mask: (B,1,Sq,Sk)."""
    b, sq, h, dh = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, sq, kv, h // kv, dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.to(torch.float32),
                          k.to(torch.float32)) / (dh ** 0.5)
    scores = _softcap(scores, cfg.attn_softcap)
    scores = torch.where(mask[:, :, None], scores,
                         torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.to(torch.float32))
    return out.reshape(b, sq, h * dh).to(q.dtype)


ATTN_KV_CHUNK = 1024      # flash-style blocking threshold & block size


def _attend_flash(q, k, v, pos_q, pos_k, cfg: ModelConfig, *, causal: bool,
                  local: bool, kv_chunk: int = ATTN_KV_CHUNK):
    """Blockwise (FlashAttention-semantics) attention in plain PyTorch: KV
    in chunks of ``kv_chunk`` with a running (max, denominator, weighted
    sum), so (Sq, Sk) scores never exist at once; the same f32 softmax as
    :func:`_attend`.  q: (B,Sq,H,Dh); k/v: (B,Sk,KV,Dh); pos_q: (B,Sq);
    pos_k: (B,Sk); Sk a multiple of ``kv_chunk``."""
    b, sq, h, dh = q.shape
    kv, sk = k.shape[2], k.shape[1]
    g = h // kv
    n_chunks = sk // kv_chunk
    if n_chunks * kv_chunk != sk:
        raise ValueError(f"Sk={sk} is not a multiple of kv_chunk={kv_chunk}")
    qg = q.reshape(b, sq, kv, g, dh).to(torch.float32)
    scale = dh ** -0.5
    m = torch.full((b, kv, g, sq), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, kv, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kv, g, sq, dh), dtype=torch.float32, device=q.device)
    pq = pos_q[:, None, None, :, None]
    for c in range(n_chunks):
        lo, hi = c * kv_chunk, (c + 1) * kv_chunk
        k_c, v_c = k[:, lo:hi], v[:, lo:hi]
        p_c = pos_k[:, lo:hi][:, None, None, None, :]
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, k_c.to(torch.float32)) * scale
        s = _softcap(s, cfg.attn_softcap)
        mask = torch.ones((b, 1, 1, sq, kv_chunk), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask = mask & (p_c <= pq)
        if local:
            mask = mask & (p_c > pq - cfg.window)
        s_for_max = torch.where(mask, s, torch.full_like(s, -1e30))
        m_new = torch.maximum(m, s_for_max.amax(dim=-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]),
                        torch.zeros_like(s))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        if cfg.attn_probs_bf16:
            pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(torch.bfloat16),
                              v_c.to(torch.bfloat16)).to(torch.float32)
        else:
            pv = torch.einsum("bkgqs,bskd->bkgqd", p, v_c.to(torch.float32))
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h * dh).to(q.dtype)


def _training(q, k, v) -> bool:
    """True when autograd records this attention call (gradients enabled
    and an input requires one): it then runs the reference's training
    attention, on the card too, recorded as a plain dispatch."""
    return torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)


def _plain_on_card(q, backend: str | None):
    """The recorded plain ``flash_attention`` dispatch of a training
    attention on the card (a ``with`` around its work); nothing on the
    host, where the plain attention is the path itself."""
    return engine.record_plain("flash_attention", engine.ATTN_FLASH, q,
                               backend) if engine.on_card(q) else \
        contextlib.nullcontext()


def _blockwise(sk: int) -> bool:
    """The reference's choice of ``_attend_flash`` over ``_attend``: more
    than ATTN_KV_CHUNK keys, in whole chunks."""
    return sk > ATTN_KV_CHUNK and sk % ATTN_KV_CHUNK == 0


def _probs_bf16(cfg: ModelConfig, sk: int) -> bool:
    """Whether the reference rounds this attention's probabilities to bf16:
    ``attn_probs_bf16`` where it takes ``_attend_flash`` (``_attend``
    keeps f32 P)."""
    return cfg.attn_probs_bf16 and _blockwise(sk)


def _attend_full(q, k, v, positions, cfg: ModelConfig, local: bool,
                 backend: str | None):
    """Causal attention of a whole sequence over itself (no cache): a
    whole-prompt prefill or the forward, whose positions are
    ``arange(S)``.  On the card without autograd: ``engine.flash_attention``
    (the kernel, or its plain version for ``backend="torch"``), whose
    positions count from 0, with bf16 probabilities where the reference
    rounds them (:func:`_probs_bf16`).  On the CPU, and under autograd on
    every device: the reference's choice, ``_attend_flash`` for
    Sq > ATTN_KV_CHUNK in whole chunks, else ``_attend``."""
    b, sq, h, dh = q.shape
    kvh = k.shape[2]
    if engine.on_card(q) and not _training(q, k, v):
        out = engine.flash_attention(
            q.reshape(b, sq, kvh, h // kvh, dh), k, v, causal=True,
            window=cfg.window if local else 0, softcap=cfg.attn_softcap,
            probs_bf16=_probs_bf16(cfg, sq), backend=backend)
        return out.reshape(b, sq, h * dh).to(q.dtype)
    with _plain_on_card(q, backend):
        if _blockwise(sq):
            return _attend_flash(q, k, v, positions, positions, cfg,
                                 causal=True, local=local)
        i = positions[:, :, None]               # (B,Sq,1) query pos
        j = positions[:, None, :]               # (B,1,Sk) key pos
        mask = j <= i
        if local:
            mask &= j > i - cfg.window
        return _attend(q, k, v, mask[:, None], cfg)


def _attend_all(q, k, v, cfg: ModelConfig, backend: str | None):
    """Attention with no mask: every query sees every key (the enc-dec
    encoder's self-attention and the cross-attention; Sq may differ from
    Sk).  On the card without autograd: ``engine.flash_attention`` with
    ``causal=False`` (bf16 probabilities as :func:`_probs_bf16` says).  On
    the CPU, and under autograd on every device: the reference's choice,
    ``_attend_flash`` for Sk > ATTN_KV_CHUNK in whole chunks, else
    ``_attend`` with an all-true mask."""
    b, sq, h, dh = q.shape
    kvh, sk = k.shape[2], k.shape[1]
    if engine.on_card(q) and not _training(q, k, v):
        out = engine.flash_attention(
            q.reshape(b, sq, kvh, h // kvh, dh), k, v, causal=False,
            softcap=cfg.attn_softcap, probs_bf16=_probs_bf16(cfg, sk),
            backend=backend)
        return out.reshape(b, sq, h * dh).to(q.dtype)
    with _plain_on_card(q, backend):
        if _blockwise(sk):
            pos_q, pos_k = (torch.zeros((b, n), dtype=torch.int64,
                                        device=q.device) for n in (sq, sk))
            return _attend_flash(q, k, v, pos_q, pos_k, cfg, causal=False,
                                 local=False)
        mask = torch.ones((1, 1, sq, sk), dtype=torch.bool, device=q.device)
        return _attend(q, k, v, mask, cfg)


def _project_qkv(p, x, cfg: ModelConfig, positions, backend, shard=None):
    """Normed x through wq/wk/wv, with RoPE: q (B, S, H, Dh), k and v
    (B, S, KV, Dh), with H and KV this rank's heads (every head on one
    device).  Under tensor parallelism the normed x enters the
    column-parallel projections (``Axis.enter``); where the query heads are
    cut and the KV heads whole, k and v enter instead (this rank's groups
    use some of their heads)."""
    b, dh = x.shape[0], cfg.dh
    xn = rmsnorm(p["norm"], x, cfg.norm_eps)
    q_split = _column_split(shard, p["wq"], cfg.n_heads * dh)
    kv_split = _column_split(shard, p["wk"], cfg.n_kv_heads * dh)
    xs = q_split.enter(xn) if q_split is not None else xn
    q = qlinear_apply(p["wq"], xs, cfg, backend, shard=shard)
    xkv = xs if kv_split is not None else xn
    k = qlinear_apply(p["wk"], xkv, cfg, backend, shard=shard)
    v = qlinear_apply(p["wv"], xkv, cfg, backend, shard=shard)
    if q_split is not None and kv_split is None:
        k, v = q_split.enter(k), q_split.enter(v)
    q = q.reshape(b, -1, q.shape[-1] // dh, dh)
    k = k.reshape(b, -1, k.shape[-1] // dh, dh)
    v = v.reshape(b, -1, v.shape[-1] // dh, dh)
    return rope(q, positions, cfg.rope_theta), rope(k, positions,
                                                    cfg.rope_theta), v


def _kv_span(shard, cfg: ModelConfig, h: int, kvh: int) -> tuple[int, int]:
    """[lo, hi) of the KV heads this rank's ``h`` query heads attend with:
    all ``kvh`` of them, unless tensor parallelism cut the query heads and
    left the KV heads whole (``param_specs``: heads divide the model axis,
    KV heads do not); then the KV heads of this rank's GQA groups."""
    if shard is None or shard.tp is None or h == cfg.n_heads \
            or kvh != cfg.n_kv_heads:
        return 0, kvh
    g = cfg.n_heads // cfg.n_kv_heads
    first = shard.tp.index * h
    lo, hi = first // g, (first + h - 1) // g + 1
    if h % (hi - lo):
        raise ValueError(f"{cfg.name}: {h} query heads a rank over KV heads "
                         f"[{lo}, {hi}) do not form whole groups")
    return lo, hi


def _heads(t, lo: int, hi: int):
    """KV heads [lo, hi) of a (..., KV, Dh) tensor (contiguous when cut)."""
    if lo == 0 and hi == t.shape[-2]:
        return t
    return t[..., lo:hi, :].contiguous()


def attn_apply(p, x, cfg: ModelConfig, positions, *, local: bool,
               cache=None, cache_pos=None, return_kv: bool = False,
               backend: str | None = None, shard=None):
    """Full-sequence prefill or forward when cache is None (positions
    ``arange(S)``), else cached.

    cache: dict {"k","v"[, "ks","vs"]} with k/v (B, S_max, KV, Dh') (int8
    codes + f32 scales when cfg.kv_bits); updated in place.  With a cache
    and Sq > 1 this is the chunk-append path: the chunk's KV is written at
    [cache_pos, cache_pos + Sq) (cache_pos an int) and the queries attend
    causally over the cache.  With Sq == 1 it is the batched decode step:
    cache_pos is an int or a (B,) per-slot position tensor.
    Returns (out, cache_or_kv)."""
    b, dh = x.shape[0], cfg.dh
    q, k, v = _project_qkv(p, x, cfg, positions, backend, shard)
    h, kvh = q.shape[2], k.shape[2]
    lo, hi = _kv_span(shard, cfg, h, kvh)
    bits = cfg.kv_bits

    if cache is None:
        out = _attend_full(q, _heads(k, lo, hi), _heads(v, lo, hi),
                           positions, cfg, local, backend)
        new = (k, v) if return_kv else None
    elif x.shape[1] > 1:
        s_max = cache["k"].shape[1]
        start, stop = int(cache_pos), int(cache_pos) + x.shape[1]
        if bits:
            kq, ks, vq, vs = _kv_quantize(k, v, bits)
            for name, upd in (("k", kq), ("v", vq), ("ks", ks), ("vs", vs)):
                cache[name][:, start:stop] = upd
            kk = _kv_dequant(cache["k"], cache["ks"], x.dtype, bits)
            vv = _kv_dequant(cache["v"], cache["vs"], x.dtype, bits)
        else:
            cache["k"][:, start:stop] = k.to(cache["k"].dtype)
            cache["v"][:, start:stop] = v.to(cache["v"].dtype)
            kk, vv = cache["k"], cache["v"]
        j = torch.arange(s_max, device=x.device)[None, None, :]     # (1,1,S)
        qpos = positions[:, :, None]                                # (B,Sq,1)
        mask = (j <= qpos)[:, None]                                 # (B,1,Sq,S)
        if local:
            mask &= (j > qpos - cfg.window)[:, None]
        out = _attend(q, _heads(kk, lo, hi), _heads(vv, lo, hi), mask, cfg)
        new = cache
    elif shard is not None and shard.seq is not None:
        out = _decode_seq_parallel(q, k, v, cache, cache_pos, cfg, local,
                                   lo, hi, backend, shard)
        new = cache
    else:
        s_max = cache["k"].shape[1]
        pos_b = torch.as_tensor(cache_pos, device=x.device).to(
            torch.int64).reshape(-1).expand(b)
        bidx = torch.arange(b, device=x.device)
        if bits:
            kq, ks, vq, vs = _kv_quantize(k, v, bits)
            for name, upd in (("k", kq), ("v", vq), ("ks", ks), ("vs", vs)):
                cache[name][bidx, pos_b] = upd[:, 0]
        else:
            cache["k"][bidx, pos_b] = k[:, 0].to(cache["k"].dtype)
            cache["v"][bidx, pos_b] = v[:, 0].to(cache["v"].dtype)
        new = cache
        if bits and not local and cfg.attn_softcap <= 0:
            # the serving hot path: engine-dispatched flash-decode over the
            # quantized cache (the CUDA kernel for a kv8 cache on the card)
            q4 = q[:, 0].reshape(b, hi - lo, h // (hi - lo), dh)
            out = engine.decode_attention(
                q4, *(_heads(cache[n], lo, hi) for n in ("k", "ks", "v", "vs")),
                pos_b, kv_bits=bits, dtype=x.dtype, backend=backend)
            out = out.reshape(b, 1, h * dh)
        else:
            if bits:
                kk = _kv_dequant(cache["k"], cache["ks"], x.dtype, bits)
                vv = _kv_dequant(cache["v"], cache["vs"], x.dtype, bits)
            else:
                kk, vv = cache["k"], cache["v"]
            j = torch.arange(s_max, device=x.device)[None, :]          # (1,S)
            mask = (j <= pos_b[:, None])[:, None, None]                # (B,1,1,S)
            if local:
                mask &= (j > pos_b[:, None] - cfg.window)[:, None, None]
            out = _attend(q, _heads(kk, lo, hi), _heads(vv, lo, hi), mask,
                          cfg)

    out = qlinear_apply(p["wo"], out, cfg, backend,
                        _row_parallel(shard, out, cfg.n_heads * dh),
                        shard=shard)
    return _post_norm(p, out, cfg), new


def _attend_partial(q, k, v, mask, cfg: ModelConfig):
    """:func:`_attend` of one query token over a slice of the positions,
    as a partial of a sequence-parallel step: q (B, 1, H, Dh), k/v
    (B, S, KV, Dh), mask (B, 1, 1, S).  Returns the f32 output (B, KV, G,
    Dh) normalized over the slice and the (B, KV, G) log-sum-exp of its
    masked scores (-inf, and a zero output, where the slice holds no
    valid position)."""
    b, _, h, dh = q.shape
    kv = k.shape[2]
    qg = q[:, 0].reshape(b, kv, h // kv, dh)
    scores = torch.einsum("bkgd,bskd->bkgs", qg.to(torch.float32),
                          k.to(torch.float32)) / (dh ** 0.5)
    scores = _softcap(scores, cfg.attn_softcap)
    probs = torch.softmax(torch.where(mask, scores,
                                      torch.full_like(scores, -1e30)), dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v.to(torch.float32))
    return masked_lse(scores, mask, out)


def _decode_seq_parallel(q, k, v, cache, cache_pos, cfg: ModelConfig,
                         local: bool, lo: int, hi: int, backend, shard):
    """One decode step over a cache whose SEQUENCE is cut over
    ``shard.seq`` (``cache_specs``: this rank holds the S_local positions
    [index S_local, (index + 1) S_local)).

    The new token's K/V goes to the rank that holds ``pos``: every rank
    writes at its clamped local position, keeping the old row where it
    does not hold it (a static-shape masked write).  Each rank attends its
    own positions under the global mask (gemma2's window may straddle
    ranks): the kv8 cache through ``engine.decode_attention`` with the
    log-sum-exp (B5 on the card), the float cache, windowed and softcap
    layers through :func:`_attend_partial`.  The partials combine as
    flash-decode does: M = the all-reduced max of the lse, then one
    all-reduce sum of ``exp(lse - M) o`` and ``exp(lse - M)`` packed
    together.  Where the sequence axis is also the tensor-parallel axis
    (``kv_seq_shard``: the query heads cut over 'model', the KV heads and
    the cache's positions not), this rank's query heads are all-gathered
    first, every head attends, and the rank keeps its own heads' output.
    Returns (B, 1, H_local Dh) in q's dtype."""
    seq, tp = shard.seq, shard.tp
    b, _, h, dh = q.shape
    s_loc, bits = cache["k"].shape[1], cfg.kv_bits
    pos_b = torch.as_tensor(cache_pos, device=q.device).to(
        torch.int64).reshape(-1).expand(b)
    first = seq.index * s_loc
    at = pos_b - first
    mine = (at >= 0) & (at < s_loc)
    at = at.clamp(0, s_loc - 1)
    bidx = torch.arange(b, device=q.device)
    if bits:
        kq, ks, vq, vs = _kv_quantize(k, v, bits)
        upd = {"k": kq, "v": vq, "ks": ks, "vs": vs}
    else:
        upd = {"k": k.to(cache["k"].dtype), "v": v.to(cache["v"].dtype)}
    for name, val in upd.items():
        old = cache[name][bidx, at]
        cache[name][bidx, at] = torch.where(
            mine.view(-1, *(1,) * (old.dim() - 1)), val[:, 0], old)

    gather = tp is not None and tp.size > 1 and bool(
        set(seq.names) & set(tp.names))
    if gather:
        q = tp.all_gather(q, dim=2)
        lo, hi = 0, cache["k"].shape[2]
    hq = q.shape[2]
    if bits == 8 and not local and cfg.attn_softcap <= 0:
        q4 = q[:, 0].reshape(b, hi - lo, hq // (hi - lo), dh)
        o, lse = engine.decode_attention(
            q4, *(_heads(cache[n], lo, hi) for n in ("k", "ks", "v", "vs")),
            pos_b - first, kv_bits=bits, dtype=q.dtype, backend=backend,
            lse=True)
    else:
        if bits:
            kk = _kv_dequant(cache["k"], cache["ks"], q.dtype, bits)
            vv = _kv_dequant(cache["v"], cache["vs"], q.dtype, bits)
        else:
            kk, vv = cache["k"], cache["v"]
        j = first + torch.arange(s_loc, device=q.device)[None, :]     # (1,S)
        mask = j <= pos_b[:, None]
        if local:
            mask &= j > pos_b[:, None] - cfg.window
        o, lse = _attend_partial(q, _heads(kk, lo, hi), _heads(vv, lo, hi),
                                 mask[:, None, None], cfg)
    top = seq.all_reduce_max(lse)
    w = torch.exp(lse - top)
    both = seq.all_reduce_sum(torch.cat(
        [(o * w[..., None]).reshape(b, -1), w.reshape(b, -1)], dim=1))
    n = o[0].numel()
    out = (both[:, :n].view(o.shape) / both[:, n:].view(w.shape)[..., None]
           ).reshape(b, 1, hq * dh).to(q.dtype)
    if gather:
        out = out.narrow(2, tp.index * h * dh, h * dh)
    return out


def make_kv_cache(cfg: ModelConfig, b: int, s_max: int, device,
                  stacked: int | None = None):
    """Cache dict for one layer (or with a stacked leading dim).  Scales
    start at 1e-6 (positions never written stay masked anyway)."""
    kvh, dh = cfg.n_kv_heads, cfg.dh
    lead = (stacked,) if stacked else ()
    if cfg.kv_bits:
        dh_store = dh // 2 if cfg.kv_bits == 4 else dh
        codes = lead + (b, s_max, kvh, dh_store)
        scales = lead + (b, s_max, kvh, 1)
        return {
            "k": torch.zeros(codes, dtype=torch.int8, device=device),
            "v": torch.zeros(codes, dtype=torch.int8, device=device),
            "ks": torch.full(scales, 1e-6, dtype=torch.float32, device=device),
            "vs": torch.full(scales, 1e-6, dtype=torch.float32, device=device),
        }
    shape = lead + (b, s_max, kvh, dh)
    return {"k": torch.zeros(shape, dtype=pdtype(cfg), device=device),
            "v": torch.zeros(shape, dtype=pdtype(cfg), device=device)}


def attn_apply_paged(p, x, cfg: ModelConfig, positions, *, local: bool,
                     pool, page_table, kv_bits: int, slot_map=None,
                     fused: bool = True, backend: str | None = None,
                     shard=None):
    """Attention over a block-paged KV pool (``runtime.kvcache``) instead
    of a per-slot dense cache.

    pool: one layer's block storage ``{"k","v"[,"ks","vs"]}`` with leaves
    (NB, bs, KV, Dh'), shared by every request; block 0 is the null block.
    page_table: (B, n_blocks) int32, each sequence's logical block j ->
    physical block.  positions: (B, Sq) — Sq > 1 is a B=1 prefill-chunk
    append, Sq == 1 the batched decode step.  Both write their KV into the
    owning blocks (``positions // bs`` -> page-table row -> block, IN PLACE)
    with out-of-range positions and zeroed page-table rows deflected to the
    null block, then attend: a chunk over the gathered (B, n_blocks*bs)
    view with the causal mask, a decode step through the engine.

    Decode steps (global, no softcap) take the **fused** path by default:
    one engine dispatch for paged attention and the ``wo`` projection over
    ``slot_map`` (None = all slots).  ``fused=False`` keeps the two-dispatch
    path.  Returns (out, pool)."""
    b, dh = x.shape[0], cfg.dh
    nb, bs = page_table.shape[1], pool["k"].shape[1]
    s_pad = nb * bs
    q, k, v = _project_qkv(p, x, cfg, positions, backend)
    h, kvh = q.shape[2], k.shape[2]
    lo, hi = _kv_span(shard, cfg, h, kvh)
    wo_reduce = _row_parallel(shard, q.reshape(b, -1, h * dh),
                              cfg.n_heads * dh)
    sq = x.shape[1]

    # ---- block writes: (b, sq) positions -> (physical block, offset) -----
    pos = positions.to(torch.int64)                              # (B, Sq)
    lb = torch.clamp(pos // bs, 0, nb - 1)
    phys = torch.gather(page_table.to(torch.int64), 1, lb)
    phys = torch.where(pos < s_pad, phys, torch.zeros_like(phys))  # OOB -> null
    pi, oi = phys.reshape(-1), (pos % bs).reshape(-1)

    def write(name, upd):
        # duplicate (block, offset) pairs come from occupancy padding (the
        # same values) or from dead rows aimed at the null block
        pool[name][pi, oi] = upd.reshape(b * sq, *upd.shape[2:]).to(
            pool[name].dtype)

    if kv_bits < 16:
        kq, ks, vq, vs = _kv_quantize(k, v, kv_bits)
        for name, upd in (("k", kq), ("v", vq), ("ks", ks), ("vs", vs)):
            write(name, upd)
    else:
        write("k", k)
        write("v", v)

    pt32 = page_table.to(torch.int32)
    if sq == 1 and not local and cfg.attn_softcap <= 0:
        q4 = q[:, 0].reshape(b, hi - lo, h // (hi - lo), dh)
        kv = [None if pool.get(n) is None else _heads(pool[n], lo, hi)
              for n in ("k", "ks", "v", "vs")]
        if fused:
            # attention + wo in one engine dispatch over the live slots;
            # rows outside slot_map come back as zeros
            pcfg = signed(get_precision(cfg.precision))
            out = engine.fused_paged_decode(
                q4, *kv, pt32, pos[:, 0], slot_map, p["wo"], pcfg,
                kv_bits=kv_bits, dtype=x.dtype, backend=backend,
                reduce=wo_reduce)
            return _post_norm(p, out, cfg), pool
        out = engine.paged_attention(
            q4, *kv, pt32, pos[:, 0], kv_bits=kv_bits, dtype=x.dtype,
            backend=backend)
        out = out.reshape(b, 1, h * dh)
    else:
        # prefill-chunk append (or local/softcap attention): attend over the
        # gathered dense (B, s_pad) page-table view
        def gather(leaf):
            return gather_pool(leaf, page_table)
        if kv_bits < 16:
            kk = _kv_dequant(gather(pool["k"]), gather(pool["ks"]), x.dtype,
                             kv_bits)
            vv = _kv_dequant(gather(pool["v"]), gather(pool["vs"]), x.dtype,
                             kv_bits)
        else:
            kk, vv = gather(pool["k"]), gather(pool["v"])
        j = torch.arange(s_pad, device=x.device)[None, None, :]     # (1,1,S)
        qpos = pos[:, :, None]                                      # (B,Sq,1)
        mask = (j <= qpos)[:, None]                                 # (B,1,Sq,S)
        if local:
            mask &= (j > qpos - cfg.window)[:, None]
        out = _attend(q, _heads(kk, lo, hi), _heads(vv, lo, hi), mask, cfg)

    out = qlinear_apply(p["wo"], out, cfg, backend, wo_reduce)
    return _post_norm(p, out, cfg), pool


def make_kv_pool(cfg: ModelConfig, num_blocks: int, block_size: int,
                 kv_bits: int, device, stacked: int | None = None):
    """Block pool for one attention layer (or with a stacked leading dim):
    ``num_blocks`` physical blocks of ``block_size`` positions.  Block 0 is
    the reserved null block (never allocated)."""
    kvh, dh = cfg.n_kv_heads, cfg.dh
    lead = (stacked,) if stacked else ()
    if kv_bits < 16:
        dh_store = dh // 2 if kv_bits == 4 else dh
        codes = lead + (num_blocks, block_size, kvh, dh_store)
        scales = lead + (num_blocks, block_size, kvh, 1)
        return {
            "k": torch.zeros(codes, dtype=torch.int8, device=device),
            "v": torch.zeros(codes, dtype=torch.int8, device=device),
            "ks": torch.full(scales, 1e-6, dtype=torch.float32, device=device),
            "vs": torch.full(scales, 1e-6, dtype=torch.float32, device=device),
        }
    shape = lead + (num_blocks, block_size, kvh, dh)
    return {"k": torch.zeros(shape, dtype=pdtype(cfg), device=device),
            "v": torch.zeros(shape, dtype=pdtype(cfg), device=device)}


# ---------------------------------------------------------------------------
# dense FFN (gated SwiGLU or plain 2-matrix)
# ---------------------------------------------------------------------------
def ffn_init(generator, cfg: ModelConfig, device, gated: bool = True):
    d, f = cfg.d_model, cfg.d_ff
    p = {"norm": rmsnorm_init(d, device)}
    if gated:
        p["w_gate"] = qlinear_init(generator, d, f, cfg, device)
    p["w_up"] = qlinear_init(generator, d, f, cfg, device)
    p["w_down"] = qlinear_init(generator, f, d, cfg, device)
    if cfg.post_norms:
        p["post_norm"] = rmsnorm_init(d, device)
    return p


def ffn_apply(p, x, cfg: ModelConfig, backend: str | None = None,
              shard=None):
    xn = rmsnorm(p["norm"], x, cfg.norm_eps)
    split = _column_split(shard, p["w_up"], cfg.d_ff)
    if split is not None:
        xn = split.enter(xn)
    up = qlinear_apply(p["w_up"], xn, cfg, backend, shard=shard)
    if "w_gate" in p:
        up = _act(qlinear_apply(p["w_gate"], xn, cfg, backend, shard=shard),
                  cfg.act_fn) * up
    else:
        up = _act(up, cfg.act_fn)
    down = qlinear_apply(p["w_down"], up, cfg, backend,
                         _row_parallel(shard, up, cfg.d_ff), shard=shard)
    return _post_norm(p, down, cfg)


# ---------------------------------------------------------------------------
# MoE (token-choice top-k, capacity + slot-map dispatch)
# ---------------------------------------------------------------------------
def moe_init(generator, cfg: ModelConfig, device):
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    dt = pdtype(cfg)
    return {
        "norm": rmsnorm_init(d, device),
        "w_router": _randn(generator, (d, e), device) * d ** -0.5,
        "w_gate": (_randn(generator, (e, d, f), device) * d ** -0.5).to(dt),
        "w_up": (_randn(generator, (e, d, f), device) * d ** -0.5).to(dt),
        "w_down": (_randn(generator, (e, f, d), device) * f ** -0.5).to(dt),
    }


def _expert_matmul(w, x, cfg: ModelConfig, backend: str | None = None):
    """x: (E, C, K) @ w: (E, K, N) per expert; serving weights are packed
    per expert (``engine.qmatmul_experts``).  Float weights of a quantized
    config take the reference's fake-quant (QAT) form: each expert's
    weights STE-quantized per output channel (reduced over K, axis 1),
    the activations left in float, as the reference does."""
    pcfg = signed(get_precision(cfg.precision))
    if isinstance(w, dict):
        return engine.qmatmul_experts(x, w, pcfg, backend=backend)
    if pcfg.w_mode != W_FLOAT:
        w = weight_fake_quant(w.to(torch.float32), pcfg, axis=1).to(x.dtype)
    return torch.einsum("eck,ekn->ecn", x, w.to(x.dtype))


def _fsdp_experts(w, x, cfg: ModelConfig, backend, fsdp):
    """:func:`_expert_matmul` with float weights ``w`` of which this rank
    holds a slice of K over ``fsdp`` (the FSDP rule of ``param_specs``):
    the weight is all-gathered here, where its layer uses it, and under
    autograd gathered again in the backward (``torch.utils.checkpoint``
    around gather-and-use): the gathered weight is not kept for the
    backward, so one layer's full weights are live at a time, not every
    layer's.  Its gradient is this rank's slice of the gradient summed over
    ``fsdp`` (the gather's ``reduce_grad``: a reduce-scatter)."""
    def use(w_local, x_):
        return _expert_matmul(fsdp.all_gather(w_local, dim=-2,
                                              reduce_grad=True),
                              x_, cfg, backend)
    if torch.is_grad_enabled() and (w.requires_grad or x.requires_grad):
        from torch.utils.checkpoint import checkpoint
        return checkpoint(use, w, x, use_reentrant=False)
    return use(w, x)


def _n_experts_held(p) -> int:
    """Experts in this rank's MoE params (all of them on one device)."""
    w = p["w_gate"]
    return (w["wt_packed"] if isinstance(w, dict) else w).shape[0]


def moe_partial(p, x, cfg: ModelConfig, backend: str | None = None, *,
                first_expert: int = 0, enter=None, fsdp=None):
    """The slot-map MoE over the experts held in ``p``, numbered from
    ``first_expert`` (all of them on one device): returns (out, probs,
    top_i), ``out`` (T, D) f32 the tokens' gated outputs summed over the
    held experts only (every expert outside the range a zero row), probs
    (T, E) and top_i (T, k) for the load-balance terms.

    Capacity depends on the call's rows: ``cap = int(T k / E *
    capacity_factor)`` or 1, and entries claim slots in token-major order,
    so a token's experts depend on the other rows of the call (dead decode
    slots included).  Over-capacity entries are dropped.  Each token's
    expert outputs are summed in ascending expert order, one add at a time
    (the order of the reference's scatter-add on XLA's CPU), never by
    atomics.

    ``enter``: the model axis the experts are cut over, under autograd:
    the normed tokens and the gate weights (replicated) enter the held
    experts through ``Axis.enter``, whose backward sums their cotangents
    over the axis (each rank holds its experts' part); the router's
    load-balance path stays replicated.

    ``fsdp``: the data axis whose ranks each hold a slice of the expert
    weights' K (``param_specs(fsdp=True)``); such a weight is gathered
    where it is used (:func:`_fsdp_experts`)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    e_held = _n_experts_held(p)
    cap = int(t * k / e * cfg.capacity_factor) or 1

    xin = rmsnorm(p["norm"], x, cfg.norm_eps).reshape(t, d)
    # f32 with TF32 off (PyTorch's default, which the port never changes):
    # a router logit rounded through TF32 can flip a token's experts
    logits = xin.to(torch.float32) @ p["w_router"]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, k, dim=-1)                  # (T, k)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)

    flat_e = top_i.reshape(-1)                                    # (T*k,)
    onehot = F.one_hot(flat_e, e).to(torch.int32)                 # (T*k, E)
    pos = (onehot.cumsum(0) - 1).gather(1, flat_e[:, None])[:, 0]
    keep = pos < cap
    tok = torch.arange(t, device=x.device).repeat_interleave(k)

    # (E, cap) slot maps: token index (t = the zero row) and gate weight;
    # a kept entry's slot is its own, a dropped entry writes the spare slot
    # e * cap, cut off after (static shapes, no host read: a dry run traces
    # this)
    slot_of = torch.where(keep, flat_e * cap + pos, e * cap)
    tok_map = torch.full((e * cap + 1,), t, dtype=torch.int64,
                         device=x.device).scatter(0, slot_of, tok)
    tok_map = tok_map[:e * cap].view(e, cap)
    gate_map = torch.zeros((e * cap + 1,), dtype=torch.float32,
                           device=x.device).scatter(0, slot_of,
                                                    top_p.reshape(-1))
    gate_map = gate_map[:e * cap].view(e, cap)
    held = slice(first_expert, first_expert + e_held)

    x_pad = torch.cat([xin, xin.new_zeros((1, d))])
    if enter is not None:
        x_pad, gate_map = enter.enter(x_pad), enter.enter(gate_map)
    # F.embedding: its backward adds a token's k slots in slot order (an
    # indexing's backward adds them with atomics on several CPU threads)
    buf = F.embedding(tok_map[held], x_pad)                       # (Eh, cap, D)

    def experts(w, xe):
        if fsdp is not None and not isinstance(w, dict) and \
                w.shape[-2] != xe.shape[-1]:
            return _fsdp_experts(w, xe, cfg, backend, fsdp)
        return _expert_matmul(w, xe, cfg, backend)
    h = _act(experts(p["w_gate"], buf), cfg.act_fn) * experts(p["w_up"], buf)
    y = experts(p["w_down"], h)                                   # (Eh, cap, D)

    # combine: each token's kept slots in ascending expert order (a zero
    # row for a dropped entry or an expert held elsewhere), left to right
    contrib = torch.zeros((e * cap + 1, d), dtype=torch.float32,
                          device=x.device)
    contrib[first_expert * cap:(first_expert + e_held) * cap] = (
        y.to(torch.float32) * gate_map[held, :, None]).reshape(-1, d)
    slot = torch.where(keep, flat_e * cap + pos, e * cap).reshape(t, k)
    slot = slot.gather(1, torch.argsort(top_i, dim=1))
    parts = contrib[slot]                                         # (T, k, D)
    out = parts[:, 0]
    for j in range(1, k):
        out = out + parts[:, j]
    return out, probs, top_i


def moe_apply(p, x, cfg: ModelConfig, backend: str | None = None,
              shard=None):
    """Token-choice top-k MoE with capacity, slot-map dispatch: an
    (E, cap) slot -> token map gathers each expert's rows, and each token
    sums its experts' gated outputs (:func:`moe_partial`).  Returns (out,
    aux load-balance loss).

    ``moe_ep_constraints`` are layout hints of the reference's partitioner
    (sharding constraints on the dispatch buffers) that change no value:
    the same slot map computes.  Over a mesh with tensor parallelism
    (``shard.tp``), ``moe_impl="shard_map"`` takes
    :func:`repro_torch.parallel.moe_shard_map.moe_apply_shard_map`, in
    serving and in a train step alike (each rank routes its own rows with
    the per-shard capacity, as the reference's ``shard_map`` MoE); the
    slot-map path keeps the global slot map (the rows of every data shard,
    gathered first when the call's rows are split), computes this rank's
    experts and sums the partial outputs over the model axis.  Without
    tensor parallelism (one device, or pure DP: ``shard.tp`` None) the call
    routes its own rows, as the reference's shard-local pure-DP step; in a
    train step (``shard.global_rows``) every mesh gathers the rows, so the
    capacity and the load-balance terms are the global batch's, as the
    reference's one-device step computes them (the gather's backward sums
    the rows' cotangents over the row axes)."""
    tp = None if shard is None else shard.tp
    if tp is not None and cfg.moe_impl == "shard_map":
        from repro_torch.parallel.moe_shard_map import moe_apply_shard_map
        return moe_apply_shard_map(p, x, cfg, shard, backend=backend)
    e_held = _n_experts_held(p)
    split = tp is not None and e_held < cfg.n_experts
    rows = shard.rows if tp is not None or \
        (shard is not None and shard.global_rows) else None
    xg = x if rows is None else rows.all_gather(x, dim=0, reduce_grad=True)
    out, probs, top_i = moe_partial(
        p, xg, cfg, backend, first_expert=tp.index * e_held if split else 0,
        enter=tp if split else None,
        fsdp=None if shard is None else shard.fsdp)
    if split:
        out = tp.all_reduce_sum(out)
    b, s, d = xg.shape
    out = out.reshape(b, s, d)
    if rows is not None:
        out = out.narrow(0, rows.index * x.shape[0], x.shape[0])
    e = cfg.n_experts
    me = probs.mean(dim=0)
    ce = F.one_hot(top_i[:, 0], e).to(torch.float32).mean(dim=0)
    aux = e * torch.sum(me * ce)
    return out.to(x.dtype), aux


# ---------------------------------------------------------------------------
# Mamba-1 (chunked selective scan; O(1) decode state)
# ---------------------------------------------------------------------------
def mamba_init(generator, cfg: ModelConfig, device):
    d, di, r, n = cfg.d_model, cfg.d_inner, cfg.dt_rank_, cfg.ssm_state
    dt = pdtype(cfg)
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = torch.rand((di,), generator=generator, dtype=torch.float32,
                   device=generator.device).to(device)
    return {
        "norm": rmsnorm_init(d, device),
        "w_in": qlinear_init(generator, d, 2 * di, cfg, device),
        "conv_w": (_randn(generator, (cfg.ssm_conv, di), device) * 0.2
                   ).to(dt),
        "conv_b": torch.zeros((di,), dtype=torch.float32, device=device),
        "w_x": qlinear_init(generator, di, r + 2 * n, cfg, device),
        "w_dt": qlinear_init(generator, r, di, cfg, device),
        "dt_bias": torch.log(torch.expm1(torch.exp(lo + (hi - lo) * u))),
        "A_log": torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                        device=device).repeat(di, 1)),
        "D": torch.ones((di,), dtype=torch.float32, device=device),
        "w_out": qlinear_init(generator, di, d, cfg, device),
    }


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv over the sequence.  x: (B,S,Di), w: (K,Di).
    With ``state`` ((B, K-1, Di)) it continues from it: one-step decode for
    S == 1, chunk continuation for S > 1.  Returns (out, new state)."""
    kk = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, kk - 1, 0))
        out = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(kk))
        return out + b, xp[:, -(kk - 1):, :] if kk > 1 else None
    if x.shape[1] > 1:                                        # chunk append
        xp = torch.cat([state.to(x.dtype), x], dim=1)
        out = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(kk))
        return out + b, xp[:, -(kk - 1):, :] if kk > 1 else state
    xs = torch.cat([state, x], dim=1)                         # (B, K, Di)
    out = torch.einsum("bkd,kd->bd", xs.to(torch.float32),
                       w.to(torch.float32))[:, None, :].to(x.dtype)
    return out + b, xs[:, 1:, :]


def _scan_inclusive(a, b):
    """Inclusive scan over axis 1 of the pairs (a_t, b_t) under
    (l, r) -> (r.a * l.a, r.a * l.b + r.b), in log2(L) doubling steps:
    a_t becomes the product of a_0..a_t, b_t the recurrence h_t = a_t h_{t-1}
    + b_t started from 0."""
    off, length = 1, a.shape[1]
    while off < length:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]],
                      dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return a, b


def _ssm_scan_chunked(dt, xs, bmat, cmat, a_mat, h0, chunk: int):
    """Selective scan h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t ; y_t = C_t.h_t.

    dt, xs: (B,S,Di); bmat, cmat: (B,S,N); a_mat: (Di,N); h0: (B,Di,N).
    The sequence is cut into nc = max(S // chunk, 1) pieces of S // nc
    positions, and the (B, piece, Di, N) decay and drive tensors exist for
    one piece at a time.  As in the reference, S >= 2 * chunk must be a
    multiple of S // chunk.  Returns (y (B,S,Di) f32, h_last (B,Di,N))."""
    b, s, di = dt.shape
    nc = max(s // chunk, 1)
    lc = s // nc
    if nc * lc != s:
        raise ValueError(
            f"selective scan: a sequence of {s} positions does not split "
            f"into {nc} pieces of {lc} (chunk {chunk}): the reference "
            "reshapes to (nc, S // nc) and refuses such lengths too")
    h, ys = h0, []
    for c in range(nc):
        sl = slice(c * lc, (c + 1) * lc)
        dtk, xsk, bk, ck = dt[:, sl], xs[:, sl], bmat[:, sl], cmat[:, sl]
        decay = torch.exp(dtk[..., None] * a_mat[None, None])     # (B,lc,Di,N)
        drive = (dtk * xsk)[..., None] * bk[:, :, None, :]
        aa, bb = _scan_inclusive(decay, drive)
        h_all = aa * h[:, None] + bb
        ys.append(torch.einsum("bldn,bln->bld", h_all, ck))
        h = h_all[:, -1]
    return torch.cat(ys, dim=1), h


def mamba_apply(p, x, cfg: ModelConfig, state=None,
                backend: str | None = None, shard=None):
    """state: None (forward / whole prefill) or {"conv": (B,K-1,Di), "ssm":
    (B,Di,N)}.  Returns (out, new_state): the final state for a prefill
    (S > 1), a chunk or a decode step; None for a forward of one position
    with no state (the reference's own rule).

    On a model axis (``shard.tp``, the d_inner leaves cut by
    ``param_specs``) rank r computes channels [r Di/tp, (r+1) Di/tp):
    ``w_in`` is column-parallel, but ``param_specs`` cuts its 2 Di columns
    contiguously (on tp 2 rank 0 holds the x half, rank 1 the z half), so
    the xz rows are all-gathered over the axis (one gather a layer) and
    the rank takes its channels of x and of z; ``w_x`` and ``w_out`` are
    row-parallel (split qmatmul: a max for the row scale and a sum of the
    partial products, the one-device result bit for bit at integer
    activations), so (dt_r, B, C) is whole on every rank; ``w_dt`` is
    column-parallel from the whole dt_r; the conv, the scan and the state
    (``cache_specs``' local shapes) are the rank's channels.  Under
    autograd the whole tensors entering a split region (the normed x,
    (dt_r, B, C)) sum their cotangents over the axis."""
    b = x.shape[0]
    di, n, r = cfg.d_inner, cfg.ssm_state, cfg.dt_rank_
    di_loc = p["D"].shape[-1]
    tp = shard.tp if di_loc != di else None
    xn = rmsnorm(p["norm"], x, cfg.norm_eps)
    if tp is not None:
        xn = tp.enter(xn)
    xz = qlinear_apply(p["w_in"], xn, cfg, backend, shard=shard)
    if tp is None:
        xs, z = xz.chunk(2, dim=-1)                            # (B,S,Di) each
    else:
        xz = tp.all_gather(xz, dim=-1, reduce_grad=True)       # (B,S,2Di)
        lo = tp.index * di_loc
        xs, z = xz[..., lo:lo + di_loc], xz[..., di + lo:di + lo + di_loc]

    conv_state = state["conv"] if state is not None else None
    xs, new_conv = _causal_conv(xs, p["conv_w"].to(torch.float32),
                                p["conv_b"], conv_state)
    xs = F.silu(xs.to(torch.float32)).to(x.dtype)

    dbc = qlinear_apply(p["w_x"], xs, cfg, backend,
                        _row_parallel(shard, xs, di), shard=shard)
    if tp is not None:
        dbc = tp.enter(dbc)
    dt_r, b_, c_ = torch.split(dbc, [r, n, n], dim=-1)
    dt = F.softplus(qlinear_apply(p["w_dt"], dt_r, cfg, backend,
                                  shard=shard).to(torch.float32)
                    + p["dt_bias"])
    a_mat = -torch.exp(p["A_log"])                             # (Di,N)

    scan = state is None or xs.shape[1] > 1
    with engine.record_plain("ssm_scan", "chunked" if scan else "step", dt,
                             backend):
        if scan:
            h0 = state["ssm"] if state is not None else torch.zeros(
                (b, di_loc, n), dtype=torch.float32, device=x.device)
            y, h_last = _ssm_scan_chunked(dt, xs.to(torch.float32),
                                          b_.to(torch.float32),
                                          c_.to(torch.float32), a_mat, h0,
                                          cfg.ssm_chunk)
        else:                                                   # one-step decode
            decay = torch.exp(dt[:, 0, :, None] * a_mat[None])  # (B,Di,N)
            drive = (dt[:, 0] * xs[:, 0].to(torch.float32))[..., None] * \
                b_[:, 0].to(torch.float32)[:, None, :]
            h_last = decay * state["ssm"] + drive
            y = torch.einsum("bdn,bn->bd", h_last,
                             c_[:, 0].to(torch.float32))[:, None]  # (B,1,Di)

    y = y + p["D"] * xs.to(torch.float32)
    y = (y * F.silu(z.to(torch.float32))).to(x.dtype)
    out = qlinear_apply(p["w_out"], y, cfg, backend,
                        _row_parallel(shard, y, di), shard=shard)
    new_state = None
    if state is not None or xs.shape[1] > 1:
        new_state = {"conv": new_conv if new_conv is not None else
                     torch.zeros((b, cfg.ssm_conv - 1, di_loc), dtype=x.dtype,
                                 device=x.device),
                     "ssm": h_last}
    return out, new_state


def make_ssm_state(cfg: ModelConfig, b: int, device,
                   stacked: int | None = None):
    lead = (stacked,) if stacked else ()
    return {"conv": torch.zeros(lead + (b, cfg.ssm_conv - 1, cfg.d_inner),
                                dtype=pdtype(cfg), device=device),
            "ssm": torch.zeros(lead + (b, cfg.d_inner, cfg.ssm_state),
                               dtype=torch.float32, device=device)}
