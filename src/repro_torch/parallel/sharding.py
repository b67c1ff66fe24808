"""Sharding rules — the port of ``repro.parallel.sharding``: which dims of
the params, the batch, the caches and the logits split over which mesh axes.

Policy (the reference's):
  * TP over 'model': attention heads, FFN hidden, MoE experts, mamba
    d_inner, vocab — each sharded ONLY when divisible by the axis size
    (smollm's 9 heads and whisper's 8 fall back to replicated attention).
  * DP over 'data' (+ 'pod' outer): batch; the FSDP option shards the K dim
    of expert weights over 'data'.
  * SP: when the batch does not cover the data axes the KV cache / SSM
    state shards its SEQUENCE dim over 'data' instead (``allow_sp``).

Rules are name-based over the param tree (train-form "qw" and serving-form
"wt_packed"/"scale" leaves alike); any object with ``.shape`` is a leaf, and
any mesh with ``.shape`` (axis -> size) and ``.axis_names`` will do.  A
spec is a tuple with one entry per dim: None, an axis name or a tuple of
names, as the reference's ``PartitionSpec`` holds them.
:func:`shard_tree` (the reference's ``named_shardings`` + ``device_put``)
cuts each leaf to the calling rank's slice.
"""
from __future__ import annotations

from typing import Any, NamedTuple

# names whose OUTPUT (N) dim is model-sharded
_N_SHARDED = ("wq", "wk", "wv", "w_gate", "w_up", "w_in", "w_dt", "lm_head")
# names whose K (contraction) dim is model-sharded
_K_SHARDED = ("wo", "w_down", "w_out", "w_x")
# mamba per-channel (d_inner) vectors/tensors
_DI_SHARDED = ("conv_w", "conv_b", "dt_bias", "A_log", "D")


def _axis(mesh, name: str) -> int:
    return mesh.shape[name]


def _div(dim: int, n: int) -> bool:
    return n > 0 and dim % n == 0


def _model_if(dim: int, mesh) -> Any:
    return "model" if _div(dim, _axis(mesh, "model")) else None


def _map_with_path(fn, tree, path=()):
    """``fn(keys, leaf)`` over a nested dict (None leaves stay None)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return None if tree is None else fn(list(path), tree)


def _replicated(leaf) -> tuple:
    return (None,) * len(leaf.shape)


def pure_dp(cfg, mesh) -> bool:
    """Small models don't amortize TP: replicate params, shard batch over
    every axis (smollm d=576, whisper d=512).  ``force_pure_dp`` opts a
    config in explicitly."""
    return cfg.force_pure_dp or cfg.d_model < 1024


def _dx(cfg, mesh):
    """Axes available for batch sharding."""
    base = ("pod", "data") if "pod" in mesh.axis_names else ("data",)
    if pure_dp(cfg, mesh):
        return base + ("model",)
    return base


def _batch_axes(cfg, mesh, b: int):
    """Largest prefix-product of data axes that divides the batch."""
    dx = _dx(cfg, mesh)
    for cut in range(len(dx), 0, -1):
        axes = dx[:cut]
        total = 1
        for a in axes:
            total *= _axis(mesh, a)
        if _div(b, total):
            return axes
    return None


def param_specs(params, cfg, mesh, fsdp: bool = False):
    """Tree of specs matching ``params`` (shapes or tensors)."""
    tp = _axis(mesh, "model")
    dp = _axis(mesh, "data")
    if pure_dp(cfg, mesh):
        return _map_with_path(lambda keys, leaf: _replicated(leaf), params)
    heads_ok = _div(cfg.n_heads, tp) if cfg.n_heads else False
    kv_ok = _div(cfg.n_kv_heads, tp) if cfg.n_kv_heads else False

    def leaf_spec(keys, leaf):
        shape = leaf.shape
        rank = len(shape)
        name = next((k for k in reversed(keys)
                     if k not in ("qw", "wt_packed", "scale", "w", "g", "b")),
                    "")
        leafname = keys[-1] if keys else ""
        in_expert = "moe" in keys and name in ("w_gate", "w_up", "w_down")

        # ---- embeddings ----
        if keys[-2:] == ["embed", "w"]:
            return (_model_if(shape[0], mesh), None)
        if "lm_head" in keys:
            if leafname == "qw":
                return (None, _model_if(shape[-1], mesh))
            if leafname == "wt_packed":   # (V, KW) — vocab sharded
                return (_model_if(shape[0], mesh), None)
            if leafname == "scale":
                return (_model_if(shape[0], mesh),)
            return (None,) * rank

        # ---- MoE experts: (..., E, K, N) / packed (..., E, N, KW) ----
        if in_expert:
            e_axis = rank - 3 if leafname != "scale" else rank - 2
            spec = [None] * rank
            if _div(cfg.n_experts, tp):
                spec[e_axis] = "model"
            if fsdp and leafname == name and _div(shape[-2], dp):
                spec[-2] = "data"       # FSDP: K dim over data
            return tuple(spec)
        if "w_router" in keys:
            return (None,) * rank

        # ---- attention / ffn / mamba projections ----
        is_attn = name in ("wq", "wk", "wv", "wo")
        if is_attn:
            ok = heads_ok if name in ("wq", "wo") else kv_ok
            if not ok:
                return (None,) * rank
        if name in _N_SHARDED:
            if leafname in ("qw",) or leafname == name:       # (..., K, N)
                return (None,) * (rank - 1) + (_model_if(shape[-1], mesh),)
            if leafname == "wt_packed":                        # (..., N, KW)
                return (None,) * (rank - 2) + (_model_if(shape[-2], mesh),
                                               None)
            if leafname == "scale":                            # (..., N)
                return (None,) * (rank - 1) + (_model_if(shape[-1], mesh),)
        if name in _K_SHARDED:
            if leafname in ("qw",) or leafname == name:       # (..., K, N)
                return (None,) * (rank - 2) + (_model_if(shape[-2], mesh),
                                               None)
            if leafname == "wt_packed":                        # (..., N, KW)
                return (None,) * (rank - 1) + (_model_if(shape[-1], mesh),)
            if leafname == "scale":
                return (None,) * rank
        if name in _DI_SHARDED or leafname in _DI_SHARDED:
            # last dim = d_inner for conv_w; first-nonperiod dim otherwise
            spec = [None] * rank
            for ax in range(rank - 1, -1, -1):
                if _div(shape[ax], tp) and shape[ax] % cfg.d_inner == 0:
                    spec[ax] = "model"
                    break
            return tuple(spec)
        # norms, biases, scalars
        return (None,) * rank

    return _map_with_path(leaf_spec, params)


def batch_specs(batch, cfg, mesh):
    """Input batch specs: batch dim over the largest dividing data-axis
    set."""
    def spec(keys, leaf):
        axes = _batch_axes(cfg, mesh, leaf.shape[0])
        return (axes,) + (None,) * (len(leaf.shape) - 1)

    return _map_with_path(spec, batch)


def cache_specs(cache, cfg, mesh, batch: int, kv_seq_shard: bool = False,
                allow_sp: bool = True):
    """KV/SSM cache specs.  Batch over data axes when divisible; otherwise
    sequence-parallel: shard the cache length (long context, B=1).

    ``kv_seq_shard``: when the KV heads don't divide the model axis, shard
    the cache SEQUENCE over the otherwise-idle 'model' axis instead of
    replicating the cache.

    ``allow_sp=False`` disables the sequence-parallel fallback entirely: the
    continuous batcher appends KV rows at dynamic positions over the
    sequence dim, which must stay local to one shard — its admission cache
    (batch=1) replicates instead."""
    tp = _axis(mesh, "model")
    baxes = _batch_axes(cfg, mesh, batch)
    # SP fallback axes for the sequence dim (never includes 'model' when the
    # model axis carries TP)
    sp_axes = _dx(cfg, mesh) if allow_sp else ()
    kv_ok = (not pure_dp(cfg, mesh)) and \
        (_div(cfg.n_kv_heads, tp) if cfg.n_kv_heads else False)

    def spec(keys, leaf):
        shape = leaf.shape
        rank = len(shape)
        leafname = keys[-1] if keys else ""
        if leafname in ("k", "v", "ks", "vs", "cross_k", "cross_v"):
            # (P?, B, S, KV, Dh) — periods lead when stacked
            lead = rank - 4
            bspec = baxes
            sspec = None
            if baxes is None:
                # sequence-parallel long-context decode
                sspec = tuple(a for a in sp_axes
                              if _div(shape[lead + 1], _axis(mesh, a)))
                sspec = sspec or None
            kvspec = "model" if kv_ok and _div(shape[lead + 2], tp) else None
            if kvspec is None and kv_seq_shard and not pure_dp(cfg, mesh) \
                    and _div(shape[lead + 1], tp) and sspec is None:
                sspec = "model"
            return (None,) * lead + (bspec, sspec, kvspec, None)
        if leafname == "conv":                                 # (P?, B, K-1, Di)
            lead = rank - 3
            return (None,) * lead + (
                baxes, None,
                None if pure_dp(cfg, mesh) else _model_if(shape[-1], mesh))
        if leafname == "ssm":                                  # (P?, B, Di, N)
            lead = rank - 3
            return (None,) * lead + (
                baxes,
                None if pure_dp(cfg, mesh) else _model_if(shape[-2], mesh),
                None)
        return (None,) * rank

    return _map_with_path(spec, cache)


def seq_axes(cache_specs, mesh) -> tuple | None:
    """The axes of size > 1 that a cache's SEQUENCE dim is cut over under
    ``cache_specs`` (its attention K/V leaves': the sequence-parallel
    fallback or ``kv_seq_shard``), in mesh order; None when it is whole."""
    found = set()

    def visit(keys, spec):
        if keys and keys[-1] in ("k", "v", "ks", "vs"):
            found.add(tuple(a for a in _entry_axes(spec[len(spec) - 3])
                            if _axis(mesh, a) > 1))
        return spec
    _map_with_path(visit, cache_specs)
    if len(found) > 1:
        raise ValueError(f"the cache's K/V leaves cut their sequence "
                         f"differently: {sorted(found)}")
    axes = next(iter(found), ())
    return tuple(a for a in mesh.axis_names if a in axes) or None


def pool_specs(pool, cfg, mesh):
    """Paged KV block-pool specs (``runtime.kvcache``): leaves are
    (P?, NB, bs, KV, Dh') — KV heads shard over 'model' when they divide and
    TP applies; the block (NB) and in-block position (bs) dims ALWAYS stay
    local to a shard (appends scatter KV rows at dynamically computed
    (block, offset) coordinates)."""
    tp = _axis(mesh, "model")
    kv_ok = (not pure_dp(cfg, mesh)) and \
        (_div(cfg.n_kv_heads, tp) if cfg.n_kv_heads else False)

    def spec(keys, leaf):
        rank = len(leaf.shape)
        leafname = keys[-1] if keys else ""
        if leafname in ("k", "v", "ks", "vs"):
            lead = rank - 4                     # (P?, NB, bs, KV, Dh')
            kvspec = "model" if kv_ok and _div(leaf.shape[lead + 2], tp) \
                else None
            return (None,) * lead + (None, None, kvspec, None)
        return (None,) * rank

    return _map_with_path(spec, pool)


def act_scale_specs(cfg, mesh, batch: int):
    """Spec for per-row activation-scale tensors of shape (B, G) / (B*T,
    G): the scale rows partition over the SAME data axes as the activations
    they dequantize."""
    return (_batch_axes(cfg, mesh, batch), None)


def logits_spec(cfg, mesh, batch: int):
    vspec = None if pure_dp(cfg, mesh) else _model_if(cfg.padded_vocab, mesh)
    return (_batch_axes(cfg, mesh, batch), None, vspec)


def serving_shard_factors(cfg, mesh, n_slots: int):
    """(dp, tp) the continuous batcher achieves on ``mesh``: ``dp`` — how
    many ways the ``n_slots`` decode batch is sharded (product of the
    dividing batch axes; for pure-DP models that includes the 'model'
    axis); ``tp`` — the model-axis size when TP applies (1 for pure-DP
    models, whose params replicate)."""
    baxes = _batch_axes(cfg, mesh, n_slots)
    dp = 1
    for a in (baxes or ()):
        dp *= _axis(mesh, a)
    tp = 1 if pure_dp(cfg, mesh) else _axis(mesh, "model")
    return dp, tp


# ---------------------------------------------------------------------------
# specs -> this rank's slices
# ---------------------------------------------------------------------------
def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_shape(shape, spec, mesh) -> tuple[int, ...]:
    """The calling rank's shape of a leaf of global ``shape`` under
    ``spec``."""
    out = []
    for dim, entry in zip(shape, spec):
        n = 1
        for a in _entry_axes(entry):
            n *= _axis(mesh, a)
        if dim % n:
            raise ValueError(f"dim {dim} does not split {n} ways ({spec})")
        out.append(dim // n)
    return tuple(out)


def shard_leaf(t, spec, mesh):
    """The calling rank's slice of tensor ``t`` under ``spec`` (the rank's
    ``mesh.coords``; a dim over several axes splits row-major in the
    entry's order): a view of ``t`` where no dim splits, else a contiguous
    copy of the slice."""
    out = t
    for d, entry in enumerate(spec):
        size, index = 1, 0
        for a in _entry_axes(entry):
            size *= _axis(mesh, a)
            index = index * _axis(mesh, a) + mesh.coords[a]
        if size == 1:
            continue
        n = t.shape[d] // size
        out = out.narrow(d, index * n, n)
    return out if out is t else out.contiguous()


def global_shape(shape, spec, mesh) -> tuple[int, ...]:
    """The global shape of a leaf whose calling rank's slice under ``spec``
    has ``shape`` (the inverse of :func:`local_shape`)."""
    out = []
    for dim, entry in zip(shape, spec):
        for a in _entry_axes(entry):
            dim *= _axis(mesh, a)
        out.append(int(dim))
    return tuple(out)


def slice_index(shape, spec, mesh) -> list[list[int]]:
    """[start, stop) a dim of the calling rank's slice of a leaf of global
    ``shape`` under ``spec`` (the index of :func:`shard_leaf`'s cut)."""
    out = []
    for dim, entry in zip(shape, spec):
        size, index = 1, 0
        for a in _entry_axes(entry):
            size *= _axis(mesh, a)
            index = index * _axis(mesh, a) + mesh.coords[a]
        n = dim // size
        out.append([index * n, (index + 1) * n])
    return out


def cut_axes(spec, mesh) -> tuple:
    """The axes of ``mesh`` of size > 1 that a leaf of ``spec`` is cut
    over, in mesh order (() on one device, or with no spec)."""
    if mesh is None or spec is None:
        return ()
    named = {a for entry in spec for a in _entry_axes(entry)}
    return tuple(a for a in mesh.axis_names
                 if a in named and _axis(mesh, a) > 1)


def holds_first_copy(spec, mesh) -> bool:
    """True on the one rank of each set that holds the same slice of a
    leaf under ``spec``: coordinate 0 on every axis the leaf is not cut
    over (a checkpoint writes each slice once)."""
    named = {a for entry in spec for a in _entry_axes(entry)}
    return all(mesh.coords[a] == 0 for a in mesh.axis_names
               if a not in named)


class TreeSharding(NamedTuple):
    """A tree cut over a mesh: its specs (a tree matching it) and the
    rank's mesh — what the reference's tree of ``NamedSharding`` says of a
    state (``Checkpointer.save`` / ``restore``'s ``shardings``)."""
    specs: Any
    mesh: Any


def shard_tree(tree, specs, mesh):
    """``tree`` with each leaf cut to the calling rank's slice under the
    matching spec of ``specs`` (:func:`param_specs`, :func:`cache_specs`,
    ...)."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    return None if tree is None else shard_leaf(tree, specs, mesh)
