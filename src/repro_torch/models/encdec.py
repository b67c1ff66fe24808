"""Encoder-decoder LM (whisper-base backbone) — ``repro.models.encdec`` in
PyTorch.

The conv/mel frontend is a stub (``models.frontends``): the encoder takes
precomputed frame embeddings (B, S_enc, D).  Positions are RoPE rather than
whisper's absolute embeddings, a deviation the reference documents; the
backbone's compute shape is what is exercised.

Decoder layer = self-attention (cached) + cross-attention (the encoder's
K/V, computed once at prefill) + FFN; encoder layer = bidirectional
self-attention + FFN.  Every projection is quantization-aware as in the
decoder-only models; the classifier ``lm_head`` stays float through
``to_serving`` and runs through ``qlinear_apply``: a plain matmul at fp32,
the fake-quant forward at a quantized precision (one activation scale over
the whole (B, S, D) tensor, so a row's logits depend on the batch).

Layer params are stacked over layers (leading axis), as the reference's
vmapped init; the encoder's and the decoder's stacks are looped over.  The
cache is ``{"self": {"k","v"[,"ks","vs"]} (L, B, S_max, KV, Dh'),
"cross_k", "cross_v": (L, B, S_enc, KV, Dh)}``: the self cache kv-quantized
with scale 1e-6 in its unwritten positions, the cross K/V in the model
dtype.  ``decode_step`` writes the self cache in place and returns the
same dict.

Full-sequence attention runs through ``engine.flash_attention`` on the
card (B8): causal for the decoder's self-attention, with no mask for the
encoder and the cross-attention (Sq 1 against S_enc at a decode step).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import layers as L
from .config import ModelConfig
from .transformer import _period, _stack


def _enc_layer_init(generator, cfg: ModelConfig, device):
    return {"attn": L.attn_init(generator, cfg, device),
            "ffn": L.ffn_init(generator, cfg, device, gated=cfg.ffn_gated)}


def _dec_layer_init(generator, cfg: ModelConfig, device):
    return {"self_attn": L.attn_init(generator, cfg, device),
            "cross_attn": L.attn_init(generator, cfg, device),
            "ffn": L.ffn_init(generator, cfg, device, gated=cfg.ffn_gated)}


def init_params(cfg: ModelConfig, generator: torch.Generator, device):
    """Seeded random params (numbers differ from ``jax.random``'s; parity
    tests start from the reference's params through ``interop``)."""
    dt = L.pdtype(cfg)
    v, d = cfg.padded_vocab, cfg.d_model
    return {
        "embed": {"w": (L._randn(generator, (v, d), device) * 0.02).to(dt)},
        "encoder": _stack([_enc_layer_init(generator, cfg, device)
                           for _ in range(cfg.n_enc_layers)]),
        "decoder": _stack([_dec_layer_init(generator, cfg, device)
                           for _ in range(cfg.n_layers)]),
        "enc_norm": L.rmsnorm_init(d, device),
        "final_norm": L.rmsnorm_init(d, device),
        "lm_head": {"qw": (L._randn(generator, (d, v), device)
                           * d ** -0.5).to(dt)},
    }


def _cross_attend(p, x, enc_k, enc_v, cfg: ModelConfig, backend=None,
                  shard=None):
    """Cross-attention: queries from the decoder's x, the encoder's fixed
    K/V, no mask and no RoPE."""
    b = x.shape[0]
    xn = L.rmsnorm(p["norm"], x, cfg.norm_eps)
    q = L.qlinear_apply(p["wq"], xn, cfg, backend, shard=shard).reshape(
        b, -1, cfg.n_heads, cfg.dh)
    out = L._attend_all(q, enc_k, enc_v, cfg, backend)
    return L.qlinear_apply(p["wo"], out, cfg, backend, shard=shard)


def _cross_kv(p, enc_out, cfg: ModelConfig, backend=None, shard=None):
    b = enc_out.shape[0]
    kvh, dh = cfg.n_kv_heads, cfg.dh
    k = L.qlinear_apply(p["wk"], enc_out, cfg, backend, shard=shard
                        ).reshape(b, -1, kvh, dh)
    v = L.qlinear_apply(p["wv"], enc_out, cfg, backend, shard=shard
                        ).reshape(b, -1, kvh, dh)
    return k, v


def _positions(b: int, s: int, device):
    return torch.arange(s, device=device)[None].expand(b, s)


def encode(params, frames, cfg: ModelConfig, backend=None, shard=None):
    """frames: (B, S_enc, D) stub-frontend embeddings -> encoder states."""
    b, s, _ = frames.shape
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    x = frames.to(L.pdtype(cfg))
    positions = _positions(b, s, frames.device)
    for i in range(cfg.n_enc_layers):
        lp = _period(params["encoder"], i)
        xn = L.rmsnorm(lp["attn"]["norm"], x, cfg.norm_eps)
        q = L.qlinear_apply(lp["attn"]["wq"], xn, cfg, backend, shard=shard
                            ).reshape(b, -1, h, dh)
        k = L.qlinear_apply(lp["attn"]["wk"], xn, cfg, backend, shard=shard
                            ).reshape(b, -1, kvh, dh)
        v = L.qlinear_apply(lp["attn"]["wv"], xn, cfg, backend, shard=shard
                            ).reshape(b, -1, kvh, dh)
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)
        out = L._attend_all(q, k, v, cfg, backend)     # bidirectional
        x = x + L.qlinear_apply(lp["attn"]["wo"], out, cfg, backend,
                                shard=shard)
        x = x + L.ffn_apply(lp["ffn"], x, cfg, backend, shard)
    return L.rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _classify(params, x, cfg: ModelConfig, backend=None, shard=None):
    xn = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.qlinear_apply(params["lm_head"], xn, cfg, backend, shard=shard
                           ).to(torch.float32)


def _rows_only(shard):
    """``shard`` for the enc-dec backbone, which is pure data-parallel on
    every mesh (``parallel.sharding.pure_dp``: d_model < 1024): its rows
    and train step's global rows, no model or sequence axis."""
    if shard is not None and (shard.tp is not None or shard.seq is not None
                              or shard.fsdp is not None):
        raise ValueError("the enc-dec backbone is pure data-parallel: no "
                         "model, sequence or FSDP axis")
    return shard


def forward(params, tokens, frames, cfg: ModelConfig, backend=None,
            shard=None):
    """The encoder on ``frames``, then the teacher-forced decoder on
    ``tokens`` (B, S): logits (B, S, V) f32 and a zero aux.  ``shard``: a
    pure data-parallel rank's StepSharding (in a train step the fake-quant
    activation scale is the global batch's)."""
    shard = _rows_only(shard)
    enc_out = encode(params, frames, cfg, backend, shard)
    b, s = tokens.shape
    x = F.embedding(tokens, params["embed"]["w"])
    positions = _positions(b, s, tokens.device)
    for i in range(cfg.n_layers):
        lp = _period(params["decoder"], i)
        out, _ = L.attn_apply(lp["self_attn"], x, cfg, positions, local=False,
                              backend=backend, shard=shard)
        x = x + out
        ck, cv = _cross_kv(lp["cross_attn"], enc_out, cfg, backend, shard)
        x = x + _cross_attend(lp["cross_attn"], x, ck, cv, cfg, backend,
                              shard)
        x = x + L.ffn_apply(lp["ffn"], x, cfg, backend, shard)
    return _classify(params, x, cfg, backend, shard), torch.zeros(
        (), dtype=torch.float32, device=tokens.device)


def prefill(params, tokens, frames, cfg: ModelConfig, s_max: int,
            backend=None, shard=None):
    """Encode, then the teacher-forced decoder over the prompt (B, S),
    building the cache: the self-attention K/V at [0, S) of ``s_max``
    (quantized when ``cfg.kv_bits``), the cross K/V of every layer.
    Returns (last-position logits (B, 1, V), cache).  ``shard``: as
    :func:`forward`'s (a rank's rows)."""
    _rows_only(shard)
    enc_out = encode(params, frames, cfg, backend)
    b, s = tokens.shape
    device = tokens.device
    x = F.embedding(tokens, params["embed"]["w"])
    positions = _positions(b, s, device)
    self_cache = L.make_kv_cache(cfg, b, s_max, device, stacked=cfg.n_layers)
    cross_k, cross_v = [], []
    for i in range(cfg.n_layers):
        lp = _period(params["decoder"], i)
        out, (k, v) = L.attn_apply(lp["self_attn"], x, cfg, positions,
                                   local=False, return_kv=True,
                                   backend=backend)
        x = x + out
        c = _period(self_cache, i)
        if cfg.kv_bits:
            kq, ks, vq, vs = L._kv_quantize(k, v, cfg.kv_bits)
            for name, val in (("k", kq), ("v", vq), ("ks", ks), ("vs", vs)):
                c[name][:, :s] = val              # rest keeps the 1e-6 pad
        else:
            c["k"][:, :s] = k.to(c["k"].dtype)
            c["v"][:, :s] = v.to(c["v"].dtype)
        ck, cv = _cross_kv(lp["cross_attn"], enc_out, cfg, backend)
        cross_k.append(ck)
        cross_v.append(cv)
        x = x + _cross_attend(lp["cross_attn"], x, ck, cv, cfg, backend)
        x = x + L.ffn_apply(lp["ffn"], x, cfg, backend)
    cache = {"self": self_cache, "cross_k": torch.stack(cross_k),
             "cross_v": torch.stack(cross_v)}
    return _classify(params, x[:, -1:, :], cfg, backend), cache


def decode_step(params, token, cache, pos, cfg: ModelConfig, backend=None,
                shard=None):
    """One decoding step.  token: (B, 1); pos: int or (B,) per-slot
    positions.  The self cache is written in place; the cross K/V are
    read.  Returns (logits (B, 1, V), cache).  ``shard``: as
    :func:`forward`'s (a rank's rows)."""
    _rows_only(shard)
    b = token.shape[0]
    pos_b = torch.as_tensor(pos, device=token.device).to(torch.int64
                                                         ).reshape(-1).expand(b)
    x = params["embed"]["w"][token]
    positions = pos_b[:, None]
    for i in range(cfg.n_layers):
        lp = _period(params["decoder"], i)
        out, _ = L.attn_apply(lp["self_attn"], x, cfg, positions, local=False,
                              cache=_period(cache["self"], i),
                              cache_pos=pos_b, backend=backend)
        x = x + out
        x = x + _cross_attend(lp["cross_attn"], x, cache["cross_k"][i],
                              cache["cross_v"][i], cfg, backend)
        x = x + L.ffn_apply(lp["ffn"], x, cfg, backend)
    return _classify(params, x, cfg, backend), cache
