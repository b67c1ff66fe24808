"""Period-stacked decoder LM — the token-LM entry points of
``repro.models.transformer``: attention, Mamba-1 and hybrid stacks, with
dense or MoE FFNs.

The layer stack is ``n_periods`` repetitions of ``cfg.layer_pattern`` /
``cfg.ffn_pattern``; parameters (and the cache) are stacked along a leading
period axis exactly as in the JAX package, so the param tree maps leaf for
leaf.  Where JAX scans over the stack, the port loops over periods.  The
cache holds ``{"k","v"[,"ks","vs"]}`` for an attention layer and
``{"conv", "ssm"}`` (the recurrent state, no sequence axis) for a Mamba
layer.

Entry points (functions of (params, inputs)):
  forward(params, tokens, cfg)                     -> logits, aux
  (tokens may be (B, S, D) embeds for ``frontend="embeds"``)
  prefill(params, tokens, cfg, s_max)              -> logits, cache
  prefill_chunk(params, tokens, cache, pos, cfg)   -> logits, cache
  decode_step(params, token, cache, pos, cfg)      -> logits, cache
  prefill_chunk_paged(params, tokens, pool, page_table, pos, cfg, kv_bits)
  decode_step_paged(params, token, pool, page_table, pos, cfg, kv_bits)
                                                   -> logits, pool

The paged entry points take attention-only stacks.  The cached entry
points update ``cache`` (or the block ``pool``) in place and return it.
Every entry point takes ``backend`` ("cuda" | "torch" | None = by device),
which reaches every engine dispatch, and ``shard`` (a
:class:`repro_torch.parallel.comm.StepSharding`, None on one device): over
a mesh the params, the cache and the pool hold this rank's slices
(``parallel.sharding``), a vocabulary-sharded embedding is a masked local
lookup and an all-reduce, and vocabulary-sharded logits are all-gathered.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import layers as L
from .config import ModelConfig


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _init_period(generator, cfg: ModelConfig, device):
    """One period's params: layer_i -> {mixer, ffn} by pattern; with
    ``cfg.post_norms`` the attention and dense FFN sub-blocks carry a
    post-norm (gemma2)."""
    p = {}
    for i, (mixer, ffn) in enumerate(zip(cfg.layer_pattern, cfg.ffn_pattern)):
        lp = {}
        if mixer.startswith("attn"):
            lp["attn"] = L.attn_init(generator, cfg, device)
        elif mixer == "mamba":
            lp["mamba"] = L.mamba_init(generator, cfg, device)
        else:
            raise ValueError(mixer)
        if ffn == "dense":
            lp["ffn"] = L.ffn_init(generator, cfg, device, gated=cfg.ffn_gated)
        elif ffn == "moe":
            lp["moe"] = L.moe_init(generator, cfg, device)
        elif ffn != "none":
            raise ValueError(ffn)
        p[f"layer_{i}"] = lp
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
    """Period ``i`` of a stacked tree (views: cache writes reach the stack;
    a None leaf, a state the reference's prefill did not return, stays
    None)."""
    if isinstance(tree, dict):
        return {k: _period(v, i) for k, v in tree.items()}
    return None if tree is None else tree[i]


def _ffn(lp, x, ffn: str, cfg: ModelConfig, backend, shard=None):
    """x after the layer's FFN and its residual; returns (x, aux)."""
    if ffn == "dense":
        return x + L.ffn_apply(lp["ffn"], x, cfg, backend, shard), 0.0
    if ffn == "moe":
        out, aux = L.moe_apply(lp["moe"], x, cfg, backend, shard)
        return x + out, aux
    return x, 0.0


def _put_state(cache: dict, key: str, state) -> None:
    """Copy a Mamba layer's new state into its (period view of the) cache."""
    for name, leaf in cache[key].items():
        leaf.copy_(state[name])


def _apply_period(pp, x, cfg: ModelConfig, positions, *, caches=None,
                  cache_pos=None, backend=None, shard=None):
    """One period.  With ``caches`` (the period's view of the cache) the
    attention KV and the Mamba states are updated in place.  Returns
    (x, aux): the MoE layers' load-balance terms summed (0.0, no device
    operation, with none)."""
    aux_total = 0.0
    for i, (mixer, ffn) in enumerate(zip(cfg.layer_pattern, cfg.ffn_pattern)):
        lp, key = pp[f"layer_{i}"], f"layer_{i}"
        cache_i = caches[key] if caches is not None else None
        if mixer.startswith("attn"):
            out, _ = L.attn_apply(lp["attn"], x, cfg, positions,
                                  local=(mixer == "attn_local"),
                                  cache=cache_i, cache_pos=cache_pos,
                                  backend=backend, shard=shard)
        else:
            out, state = L.mamba_apply(lp["mamba"], x, cfg, state=cache_i,
                                       backend=backend, shard=shard)
            if cache_i is not None:
                _put_state(caches, key, state)
        x, aux = _ffn(lp, x + out, ffn, cfg, backend, shard)
        aux_total = aux_total + aux
    return x, aux_total


def _embed(params, inputs, cfg: ModelConfig, shard=None):
    """Token ids through the embedding, or (``frontend="embeds"``) the stub
    frontend's (B, S, D) embeddings cast to the model dtype; gemma2
    (``embed_scale``) multiplies by sqrt(d_model) rounded to the model
    dtype first, as the reference does (68.0, not 67.88, in bf16).  A
    vocabulary-sharded table (this rank's rows) looks up the tokens it
    holds, zeros elsewhere, and sums over the model axis: one nonzero
    term, so the row comes back exact.  The lookup is ``F.embedding``,
    whose backward adds a row's repeated tokens in token order on every
    thread count (an indexing ``w[ids]``'s backward adds them with
    atomics on several CPU threads: replicas would differ in the last
    bits)."""
    if cfg.frontend == "embeds":
        x = inputs.to(L.pdtype(cfg))
    else:
        w = params["embed"]["w"]
        if shard is None or shard.tp is None or \
                w.shape[0] == cfg.padded_vocab:
            x = F.embedding(inputs, w)
        else:
            tp = shard.tp
            local = inputs - tp.index * w.shape[0]
            mine = (local >= 0) & (local < w.shape[0])
            x = F.embedding(local.clamp(0, w.shape[0] - 1), w) * \
                mine[..., None].to(w.dtype)
            x = tp.all_reduce_sum(x.to(torch.float32)).to(w.dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _logits(params, x, cfg: ModelConfig, shard=None, gather: bool = True,
            backend=None):
    """f32 logits; the classifier stays at full precision (paper/WRPN
    convention), tied to the embedding or a float ``lm_head``, unless
    ``cfg.quantize_lm_head``: then the ``lm_head`` runs as a projection
    (``layers.qlinear_apply``: packed through the engine once
    ``to_serving`` packed it, the fake-quant form in float), as the
    reference's; gemma2's final softcap after the f32 cast.  A
    vocabulary-sharded classifier's logits are all-gathered over the model
    axis (this rank's vocabulary slice without ``gather``), the normed x
    entering it (``Axis.enter``)."""
    xn = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    head = None if cfg.tie_embeddings else params["lm_head"]
    if head is not None and (cfg.quantize_lm_head or "qw" not in head):
        n = head["qw"].shape[-1] if "qw" in head else \
            head["wt_packed"].shape[-2]
        split = shard is not None and shard.tp is not None and \
            n != cfg.padded_vocab
        if split:
            xn = shard.tp.enter(xn)
        logits = L.qlinear_apply(head, xn, cfg, backend,
                                 shard=shard).to(torch.float32)
    else:
        w = params["embed"]["w"].T if head is None else head["qw"]
        split = shard is not None and shard.tp is not None and \
            w.shape[-1] != cfg.padded_vocab
        if split:
            xn = shard.tp.enter(xn)
        logits = (xn @ w.to(xn.dtype)).to(torch.float32)
    if split and gather:
        logits = shard.tp.all_gather(logits, dim=-1)
    if cfg.final_softcap > 0:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------
def _local_tree(tree, specs, mesh, device):
    """Leaves of this rank's shapes under ``specs`` for a tree of meta
    tensors: scales ("ks", "vs") start at 1e-6, everything else at 0."""
    from repro_torch.parallel.sharding import local_shape
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out[name] = _local_tree(leaf, specs[name], mesh, device)
        else:
            out[name] = torch.full(local_shape(leaf.shape, specs[name], mesh),
                                   1e-6 if name in ("ks", "vs") else 0,
                                   dtype=leaf.dtype, device=device)
    return out


def make_cache(cfg: ModelConfig, b: int, s_max: int, device, mesh=None):
    """Stacked per-period cache (periods as leading axis): KV for the
    attention layers, ``{"conv", "ssm"}`` states for the Mamba layers.
    With ``mesh``, leaves take the calling rank's shapes under
    ``cache_specs(..., b, allow_sp=False)`` (``b`` is the global batch):
    batch over the data axes, KV heads over 'model' when they divide; the
    sequence dim stays whole (appends write at dynamic positions)."""
    dev = "meta" if mesh is not None else device
    cache = {f"layer_{i}": (L.make_kv_cache(cfg, b, s_max, dev,
                                            stacked=cfg.n_periods)
                            if mixer.startswith("attn") else
                            L.make_ssm_state(cfg, b, dev,
                                             stacked=cfg.n_periods))
             for i, mixer in enumerate(cfg.layer_pattern)}
    if mesh is None:
        return cache
    from repro_torch.parallel.sharding import cache_specs
    return _local_tree(cache, cache_specs(cache, cfg, mesh, b,
                                          allow_sp=False), mesh, device)


def forward(params, tokens, cfg: ModelConfig, backend=None, shard=None,
            gather: bool = True):
    """The forward of a whole sequence (B, S) (or (B, S, D) embeds), no
    cache: logits (B, S, V) f32 and the auxiliary loss (the MoE layers'
    load-balance terms summed, an f32 scalar; 0.0 with no MoE layer).
    Differentiable, over a mesh too (the collectives carry gradients);
    ``gather=False`` leaves vocabulary-sharded logits as this rank's
    slice (``Model.loss``'s vocabulary-parallel form)."""
    b, s = tokens.shape[:2]
    x = _embed(params, tokens, cfg, shard)
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    aux = 0.0
    for per in range(cfg.n_periods):
        x, a = _apply_period(_period(params["blocks"], per), x, cfg,
                             positions, backend=backend, shard=shard)
        aux = aux + a
    return _logits(params, x, cfg, shard, gather, backend), torch.as_tensor(
        aux, dtype=torch.float32, device=tokens.device)


def prefill(params, tokens, cfg: ModelConfig, s_max: int, backend=None,
            shard=None):
    """Process a whole prompt (B, S) (or (B, S, D) embeds), build the
    cache, return the last-position logits (B, 1, V) and the cache.  A
    Mamba layer given one position returns no state (the reference's
    rule): its cache entry is then None, and a decode step from it starts
    from a zero state."""
    b, s = tokens.shape[:2]
    device = tokens.device
    x = _embed(params, tokens, cfg, shard)
    positions = torch.arange(s, device=device)[None].expand(b, s)
    cache = make_cache(cfg, b, s_max, device,
                       mesh=None if shard is None else shard.mesh)
    for per in range(cfg.n_periods):
        pp = _period(params["blocks"], per)
        for i, (mixer, ffn) in enumerate(zip(cfg.layer_pattern,
                                             cfg.ffn_pattern)):
            lp, key = pp[f"layer_{i}"], f"layer_{i}"
            if mixer.startswith("attn"):
                out, (k, v) = L.attn_apply(lp["attn"], x, cfg, positions,
                                           local=(mixer == "attn_local"),
                                           return_kv=True, backend=backend,
                                           shard=shard)
                c = _period(cache[key], per)
                if cfg.kv_bits:
                    kq, ks, vq, vs = L._kv_quantize(k, v, cfg.kv_bits)
                    for name, val in (("k", kq), ("v", vq), ("ks", ks),
                                      ("vs", vs)):
                        c[name][:, :s] = val      # rest keeps the 1e-6 pad
                else:
                    c["k"][:, :s] = k.to(c["k"].dtype)
                    c["v"][:, :s] = v.to(c["v"].dtype)
            else:
                out, state = L.mamba_apply(lp["mamba"], x, cfg, state=None,
                                           backend=backend, shard=shard)
                if state is None:
                    cache[key] = None
                else:
                    _put_state(_period(cache, per), key, state)
            x, _ = _ffn(lp, x + out, ffn, cfg, backend, shard)
    return _logits(params, x[:, -1:, :], cfg, shard, backend=backend), cache


def prefill_chunk(params, tokens, cache, pos: int, cfg: ModelConfig,
                  backend=None, shard=None):
    """Process one prompt chunk (B, C) against an existing cache: its KV is
    written at positions [pos, pos + C) and its queries attend causally over
    the cache.  Returns (logits (B, C, V), cache)."""
    b, c = tokens.shape[:2]
    pos = int(pos)
    x = _embed(params, tokens, cfg, shard)
    positions = (pos + torch.arange(c, device=tokens.device))[None].expand(b, c)
    for per in range(cfg.n_periods):
        x, _ = _apply_period(_period(params["blocks"], per), x, cfg,
                             positions, caches=_period(cache, per),
                             cache_pos=pos, backend=backend, shard=shard)
    return _logits(params, x, cfg, shard, backend=backend), cache


def decode_step(params, token, cache, pos, cfg: ModelConfig, backend=None,
                shard=None):
    """One decoding step.  token: (B, 1) (or (B, 1, D) embeds); pos: int or
    (B,) per-slot positions (continuous batching).  Returns (logits
    (B, 1, V), cache)."""
    b = token.shape[0]
    pos_b = torch.as_tensor(pos, device=token.device).to(torch.int64
                                                         ).reshape(-1).expand(b)
    x = _embed(params, token, cfg, shard)
    positions = pos_b[:, None]
    for per in range(cfg.n_periods):
        x, _ = _apply_period(_period(params["blocks"], per), x, cfg,
                             positions, caches=_period(cache, per),
                             cache_pos=pos_b, backend=backend, shard=shard)
    return _logits(params, x, cfg, shard, backend=backend), cache


# ---------------------------------------------------------------------------
# paged KV cache (runtime.kvcache)
# ---------------------------------------------------------------------------
def attention_only(cfg: ModelConfig) -> bool:
    """Every mixer attends: the stacks that the paged cache and chunked
    admission cover (a Mamba layer's state has no sequence axis)."""
    return all(m.startswith("attn") for m in cfg.layer_pattern)


def make_pool(cfg: ModelConfig, num_blocks: int, block_size: int,
              kv_bits: int, device, mesh=None):
    """Stacked per-period block pool for the paged KV cache: every attention
    layer gets ``num_blocks`` physical blocks of ``block_size`` positions
    (block 0 reserved as null).  With ``mesh``, leaves take the calling
    rank's shapes under ``pool_specs`` (KV heads over 'model' when they
    divide and TP applies; blocks and positions never split)."""
    if not attention_only(cfg):
        raise ValueError(f"{cfg.name}: paged KV cache needs an attention-only "
                         "stack")
    dev = "meta" if mesh is not None else device
    pool = {f"layer_{i}": L.make_kv_pool(cfg, num_blocks, block_size, kv_bits,
                                         dev, stacked=cfg.n_periods)
            for i in range(cfg.period)}
    if mesh is None:
        return pool
    from repro_torch.parallel.sharding import pool_specs
    return _local_tree(pool, pool_specs(pool, cfg, mesh), mesh, device)


def _paged_scan(params, x, cfg: ModelConfig, positions, pool, page_table,
                kv_bits: int, slot_map=None, fused: bool = False,
                backend=None, shard=None):
    for per in range(cfg.n_periods):
        pp, pool_p = _period(params["blocks"], per), _period(pool, per)
        for i, (mixer, ffn) in enumerate(zip(cfg.layer_pattern,
                                             cfg.ffn_pattern)):
            lp = pp[f"layer_{i}"]
            out, _ = L.attn_apply_paged(
                lp["attn"], x, cfg, positions, local=(mixer == "attn_local"),
                pool=pool_p[f"layer_{i}"], page_table=page_table,
                kv_bits=kv_bits, slot_map=slot_map, fused=fused,
                backend=backend, shard=shard)
            x, _ = _ffn(lp, x + out, ffn, cfg, backend, shard)
    return x, pool


def prefill_chunk_paged(params, tokens, pool, page_table, pos,
                        cfg: ModelConfig, kv_bits: int, backend=None,
                        shard=None):
    """Paged counterpart of :func:`prefill_chunk`: the chunk's KV is written
    into the pool blocks named by ``page_table`` (B=1 row) at positions
    [pos, pos + C), and queries attend through the page table.  ``pos`` may
    start past 0 (a radix prefix-cache hit covers [0, pos)).  Returns
    (logits (B, C, V), pool)."""
    b, c = tokens.shape
    x = _embed(params, tokens, cfg, shard)
    positions = (int(pos) + torch.arange(c, device=tokens.device))[None
                                                                   ].expand(b, c)
    x, pool = _paged_scan(params, x, cfg, positions, pool, page_table,
                          kv_bits, backend=backend, shard=shard)
    return _logits(params, x, cfg, shard, backend=backend), pool


def decode_step_paged(params, token, pool, page_table, pos, cfg: ModelConfig,
                      kv_bits: int, slot_map=None, fused: bool = True,
                      backend=None, shard=None):
    """Paged counterpart of :func:`decode_step`: per-slot page tables
    (B, n_blocks) resolve each slot's blocks; the new token's KV row lands
    in the slot's current block (zeroed rows deflect to the null block).
    ``fused=True`` runs each layer's attention and ``wo`` projection as one
    engine dispatch over ``slot_map`` (None = every slot).  Returns
    (logits (B, 1, V), pool)."""
    b = token.shape[0]
    pos_b = torch.as_tensor(pos, device=token.device).to(torch.int64
                                                         ).reshape(-1).expand(b)
    x = _embed(params, token, cfg, shard)
    x, pool = _paged_scan(params, x, cfg, pos_b[:, None], pool, page_table,
                          kv_bits, slot_map=slot_map, fused=fused,
                          backend=backend, shard=shard)
    return _logits(params, x, cfg, shard, backend=backend), pool


def decode_window_paged(params, tokens, pool, page_table, pos,
                        cfg: ModelConfig, kv_bits: int, backend=None):
    """Batched multi-token decode window with per-slot start positions: the
    verify step of self-speculative decoding (``runtime.kvcache``).

    tokens: (B, W), each slot's last accepted token followed by its W-1
    draft tokens; pos: (B,) per-slot window starts.  Row j of slot i runs
    at position ``pos[i] + j``: its KV is (re)written into the slot's
    blocks, overwriting the draft's KV at the same positions before any
    query of the window attends to it (each layer writes, then attends),
    and its logits are the full-precision next-token distribution given the
    window prefix.  The (B, W) grid attends through the gathered page-table
    view (plain PyTorch on every device, as the reference's window).
    Returns (logits (B, W, V), pool)."""
    b, w = tokens.shape
    x = _embed(params, tokens, cfg)
    positions = (torch.as_tensor(pos, device=tokens.device).to(torch.int64)
                 .reshape(b, 1) + torch.arange(w, device=tokens.device))
    x, pool = _paged_scan(params, x, cfg, positions, pool, page_table,
                          kv_bits, backend=backend)
    # one (B, 1) classifier call per window row, the sequential step's
    # shape: a matmul against the transposed tied embedding sums in an
    # order that depends on its row count
    return torch.cat([_logits(params, x[:, j:j + 1].contiguous(), cfg,
                              backend=backend)
                      for j in range(w)], dim=1), pool
