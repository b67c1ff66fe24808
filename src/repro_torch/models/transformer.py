"""Period-stacked decoder LM — the dense token-LM entry points of
``repro.models.transformer``.

The layer stack is ``n_periods`` repetitions of ``cfg.layer_pattern`` /
``cfg.ffn_pattern``; parameters (and the cache) are stacked along a leading
period axis exactly as in the JAX package, so the param tree maps leaf for
leaf.  Where JAX scans over the stack, the port loops over periods.

Entry points (functions of (params, inputs)):
  prefill(params, tokens, cfg, s_max)              -> logits, cache
  prefill_chunk(params, tokens, cache, pos, cfg)   -> logits, cache
  decode_step(params, token, cache, pos, cfg)      -> logits, cache

The cached entry points update ``cache`` in place and return it.  Every
entry point takes ``backend`` ("cuda" | "torch" | None = by device), which
reaches every engine dispatch.
"""
from __future__ import annotations

import torch

from . import layers as L
from .config import ModelConfig


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _init_period(generator, cfg: ModelConfig, device):
    p = {}
    for i, (mixer, ffn) in enumerate(zip(cfg.layer_pattern, cfg.ffn_pattern)):
        if not mixer.startswith("attn") or ffn != "dense":
            raise NotImplementedError(
                f"{cfg.name}: the port serves dense attention stacks only "
                f"(layer {i} is {mixer}/{ffn})")
        p[f"layer_{i}"] = {
            "attn": L.attn_init(generator, cfg, device),
            "ffn": L.ffn_init(generator, cfg, device, gated=cfg.ffn_gated),
        }
    return p


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_params(cfg: ModelConfig, generator: torch.Generator, device):
    """Seeded random params (numbers differ from ``jax.random``'s; parity
    tests start from the reference's params through ``interop``)."""
    dt = L.pdtype(cfg)
    v, d = cfg.padded_vocab, cfg.d_model
    params = {
        "embed": {"w": (L._randn(generator, (v, d), device) * 0.02).to(dt)},
        "blocks": _stack([_init_period(generator, cfg, device)
                          for _ in range(cfg.n_periods)]),
        "final_norm": L.rmsnorm_init(d, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"qw": (L._randn(generator, (d, v), device)
                                    * d ** -0.5).to(dt)}
    return params


# ---------------------------------------------------------------------------
# period application
# ---------------------------------------------------------------------------
def _period(tree, i: int):
    """Period ``i`` of a stacked tree (views: cache writes reach the stack)."""
    if isinstance(tree, dict):
        return {k: _period(v, i) for k, v in tree.items()}
    return tree[i]


def _apply_period(pp, x, cfg: ModelConfig, positions, *, caches=None,
                  cache_pos=None, backend=None):
    for i, mixer in enumerate(cfg.layer_pattern):
        lp = pp[f"layer_{i}"]
        cache_i = caches[f"layer_{i}"] if caches is not None else None
        out, _ = L.attn_apply(lp["attn"], x, cfg, positions,
                              local=(mixer == "attn_local"), cache=cache_i,
                              cache_pos=cache_pos, backend=backend)
        x = x + out
        x = x + L.ffn_apply(lp["ffn"], x, cfg, backend)
    return x


def _embed(params, tokens, cfg: ModelConfig):
    return params["embed"]["w"][tokens]


def _logits(params, x, cfg: ModelConfig):
    """f32 logits; the classifier stays at full precision (paper/WRPN
    convention), tied to the embedding or a float ``lm_head``."""
    xn = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    w = params["embed"]["w"].T if cfg.tie_embeddings else params["lm_head"]["qw"]
    return (xn @ w.to(xn.dtype)).to(torch.float32)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------
def make_cache(cfg: ModelConfig, b: int, s_max: int, device):
    """Stacked per-period cache (periods as leading axis)."""
    return {f"layer_{i}": L.make_kv_cache(cfg, b, s_max, device,
                                          stacked=cfg.n_periods)
            for i in range(cfg.period)}


def prefill(params, tokens, cfg: ModelConfig, s_max: int, backend=None):
    """Process a whole prompt (B, S), build the cache, return the
    last-position logits (B, 1, V) and the cache."""
    b, s = tokens.shape
    device = tokens.device
    x = _embed(params, tokens, cfg)
    positions = torch.arange(s, device=device)[None].expand(b, s)
    cache = make_cache(cfg, b, s_max, device)
    for per in range(cfg.n_periods):
        pp = _period(params["blocks"], per)
        for i, mixer in enumerate(cfg.layer_pattern):
            lp = pp[f"layer_{i}"]
            out, (k, v) = L.attn_apply(lp["attn"], x, cfg, positions,
                                       local=(mixer == "attn_local"),
                                       return_kv=True, backend=backend)
            x = x + out
            c = _period(cache[f"layer_{i}"], per)
            if cfg.kv_bits:
                kq, ks, vq, vs = L._kv_quantize(k, v, cfg.kv_bits)
                for name, val in (("k", kq), ("v", vq), ("ks", ks), ("vs", vs)):
                    c[name][:, :s] = val          # rest keeps the 1e-6 pad
            else:
                c["k"][:, :s] = k.to(c["k"].dtype)
                c["v"][:, :s] = v.to(c["v"].dtype)
            x = x + L.ffn_apply(lp["ffn"], x, cfg, backend)
    return _logits(params, x[:, -1:, :], cfg), cache


def prefill_chunk(params, tokens, cache, pos: int, cfg: ModelConfig,
                  backend=None):
    """Process one prompt chunk (B, C) against an existing cache: its KV is
    written at positions [pos, pos + C) and its queries attend causally over
    the cache.  Returns (logits (B, C, V), cache)."""
    b, c = tokens.shape
    pos = int(pos)
    x = _embed(params, tokens, cfg)
    positions = (pos + torch.arange(c, device=tokens.device))[None].expand(b, c)
    for per in range(cfg.n_periods):
        x = _apply_period(_period(params["blocks"], per), x, cfg, positions,
                          caches=_period(cache, per), cache_pos=pos,
                          backend=backend)
    return _logits(params, x, cfg), cache


def decode_step(params, token, cache, pos, cfg: ModelConfig, backend=None):
    """One decoding step.  token: (B, 1); pos: int or (B,) per-slot
    positions (continuous batching).  Returns (logits (B, 1, V), cache)."""
    b = token.shape[0]
    pos_b = torch.as_tensor(pos, device=token.device).to(torch.int64
                                                         ).reshape(-1).expand(b)
    x = _embed(params, token, cfg)
    positions = pos_b[:, None]
    for per in range(cfg.n_periods):
        x = _apply_period(_period(params["blocks"], per), x, cfg, positions,
                          caches=_period(cache, per), cache_pos=pos_b,
                          backend=backend)
    return _logits(params, x, cfg), cache
