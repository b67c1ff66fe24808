"""Expert-parallel MoE with local dispatch — the port of
``repro.parallel.moe_shard_map``: one all-reduce as the only collective.

The slot-map MoE (``models.layers.moe_apply``) keeps one global slot map.
Here each rank (data i, model j) of a tensor-parallel step

  1. already holds its token shard x_i (replicated over model) AND its
     expert shard E_j (``param_specs`` cut the experts over model) — so
     DISPATCH IS LOCAL: rank (i, j) fills slots for the experts of E_j from
     the tokens of x_i with per-group capacity (capacity budgeted per data
     shard);
  2. computes its experts on its slots — no communication;
  3. combines its partial (T_loc, D) f32 output and all-reduces it over the
     model axis — the ONLY collective, ~D*T_loc values a layer.

Semantics: the routing of ``moe_apply`` except that capacity is per
(data-shard, expert) instead of global (tokens compete for capacity within
their shard).  The same body serves a train step (``shard.global_rows``:
each rank routes its own rows, as the reference's ``jax.grad`` of its
``shard_map`` does); under autograd the normed tokens and the gates enter
the held experts through ``Axis.enter`` (each model rank holds its
experts' part of their cotangent), and the load-balance means over the
rows take the rows-objective convention: each row rank holds its own
objective and ``launch.steps`` averages the gradients over the rows, so the
all-reduce's backward sums the cotangent over them (with the identity the
aux term's gradient would come out 1 / rows of the reference's).  The partial outputs sum in another order than one device's
combine, so the result is the slot map's within float rounding, not bit
for bit.  Expert weights must be cut over the model axis (``n_experts``
divisible by its size) and whole over data (no FSDP).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _n_experts_held, moe_partial


def moe_apply_shard_map(p, x, cfg, shard, *, backend: str | None = None):
    """Expert-parallel ``moe_apply`` for one rank of a tensor-parallel
    step.  ``p``: this rank's MoE params (experts E / model of them,
    ``param_specs``' cut); ``x``: this rank's tokens (B_loc, S, D);
    ``shard``: the call's :class:`~repro_torch.parallel.comm.StepSharding`
    (``tp`` the model axis; ``rows`` the axes the tokens are split over, or
    None).  Returns (out (B_loc, S, D), aux), the load-balance terms
    averaged over the row shards."""
    tp = shard.tp
    e, e_held = cfg.n_experts, _n_experts_held(p)
    if e_held * tp.size != e:
        raise ValueError(
            f"{cfg.name}: expert-parallel MoE needs the {e} experts cut "
            f"over the model axis of {tp.size}; this rank holds {e_held}")
    out, probs, top_i = moe_partial(p, x, cfg, backend,
                                    first_expert=tp.index * e_held, enter=tp)
    out = tp.all_reduce_sum(out)                      # the ONLY collective
    # load-balance stats averaged over the row shards (global token means)
    me = probs.mean(dim=0)
    ce = F.one_hot(top_i[:, 0], e).to(torch.float32).mean(dim=0)
    rows = shard.rows
    if rows is not None and rows.size > 1:
        me = rows.all_reduce_sum(me, reduce_grad=shard.global_rows) / \
            rows.size
        ce = rows.all_reduce_sum(ce) / rows.size
    aux = e * torch.sum(me * ce)
    return out.reshape(x.shape).to(x.dtype), aux
