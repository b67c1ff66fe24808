"""Layer library — the dense-LM layers of ``repro.models.layers`` in PyTorch.

Params are plain nested dicts of tensors.  A quantized linear ("qlinear")
has two forms:

  init/float : {"qw": (K, N) float}
  serving    : {"wt_packed": (N, KW) int32   — bit-packed W^T (or int8 codes
                "scale": (N,) f32}             when K doesn't pack), produced
                                               by convert.to_serving()

Serving matmuls go through the precision-dispatch engine; the dense KV
cache is int8/int4 codes with per-(position, head) scales, or the model
dtype when ``kv_bits`` is 0.

Unlike the JAX package, the cached attention paths update the cache
tensors IN PLACE (and return the same dict): a serving step never copies
the cache.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.packing import pack_nibbles, unpack_nibbles
from repro_torch.core.precision import W_FLOAT, get_precision, signed
from repro_torch.kernels import engine

from .config import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def pdtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _randn(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Standard normal f32 drawn on the generator's device, then moved."""
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=generator.device).to(device)


# ---------------------------------------------------------------------------
# qlinear
# ---------------------------------------------------------------------------
def qlinear_init(generator, k: int, n: int, cfg: ModelConfig, device):
    return {"qw": (_randn(generator, (k, n), device) * k ** -0.5
                   ).to(pdtype(cfg))}


def qlinear_apply(p, x, cfg: ModelConfig, backend: str | None = None):
    """x @ W under the model's PrecisionConfig.  Dispatches on param form:
    packed serving weights go through ``engine.qmatmul``; float weights of a
    float config are a plain matmul."""
    pcfg = signed(get_precision(cfg.precision))
    if "wt_packed" in p:
        pw = engine.as_packed_weight(p, pcfg)
        return engine.qmatmul(x, pw, pcfg, backend=backend).to(pdtype(cfg))
    if pcfg.w_mode != W_FLOAT:
        raise NotImplementedError(
            f"{cfg.precision}: the fake-quant (QAT) form is not ported; "
            "serve packed weights (models.convert.to_serving)")
    return x @ p["qw"].to(x.dtype)


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
        return F.gelu(x)
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
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh
    return {
        "norm": rmsnorm_init(d, device),
        "wq": qlinear_init(generator, d, h * dh, cfg, device),
        "wk": qlinear_init(generator, d, kv * dh, cfg, device),
        "wv": qlinear_init(generator, d, kv * dh, cfg, device),
        "wo": qlinear_init(generator, h * dh, d, cfg, device),
    }


def _kv_quantize(k, v, bits: int):
    """Symmetric per-(token, head) KV quantization; scales are per position
    so appends never re-scale history.  bits=4 nibble-packs along Dh."""
    qmax = (1 << (bits - 1)) - 1

    def q(t):
        s = t.abs().amax(dim=3, keepdim=True).clamp_min(1e-6) / qmax
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


def attn_apply(p, x, cfg: ModelConfig, positions, *, local: bool,
               cache=None, cache_pos=None, return_kv: bool = False,
               backend: str | None = None):
    """Full-sequence prefill when cache is None, else cached.

    cache: dict {"k","v"[, "ks","vs"]} with k/v (B, S_max, KV, Dh') (int8
    codes + f32 scales when cfg.kv_bits); updated in place.  With a cache
    and Sq > 1 this is the chunk-append path: the chunk's KV is written at
    [cache_pos, cache_pos + Sq) (cache_pos an int) and the queries attend
    causally over the cache.  With Sq == 1 it is the batched decode step:
    cache_pos is an int or a (B,) per-slot position tensor.
    Returns (out, cache_or_kv)."""
    b = x.shape[0]
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    xn = rmsnorm(p["norm"], x, cfg.norm_eps)
    q = qlinear_apply(p["wq"], xn, cfg, backend).reshape(b, -1, h, dh)
    k = qlinear_apply(p["wk"], xn, cfg, backend).reshape(b, -1, kvh, dh)
    v = qlinear_apply(p["wv"], xn, cfg, backend).reshape(b, -1, kvh, dh)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    bits = cfg.kv_bits

    if cache is None:
        i = positions[:, :, None]                   # (B,Sq,1) query pos
        j = positions[:, None, :]                   # (B,1,Sk) key pos
        mask = j <= i
        if local:
            mask &= j > i - cfg.window
        out = _attend(q, k, v, mask[:, None], cfg)
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
        out = _attend(q, kk, vv, mask, cfg)
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
            q4 = q[:, 0].reshape(b, kvh, h // kvh, dh)
            out = engine.decode_attention(
                q4, cache["k"], cache["ks"], cache["v"], cache["vs"], pos_b,
                kv_bits=bits, dtype=x.dtype, backend=backend)
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
            out = _attend(q, kk, vv, mask, cfg)

    out = qlinear_apply(p["wo"], out, cfg, backend)
    return out, new


def make_kv_cache(cfg: ModelConfig, b: int, s_max: int, device,
                  stacked: int = None):
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
    return p


def ffn_apply(p, x, cfg: ModelConfig, backend: str | None = None):
    xn = rmsnorm(p["norm"], x, cfg.norm_eps)
    up = qlinear_apply(p["w_up"], xn, cfg, backend)
    if "w_gate" in p:
        up = _act(qlinear_apply(p["w_gate"], xn, cfg, backend),
                  cfg.act_fn) * up
    else:
        up = _act(up, cfg.act_fn)
    return qlinear_apply(p["w_down"], up, cfg, backend)
