"""Pipeline parallelism — the port of ``repro.parallel.pipeline``: GPipe
over a mesh axis.

The period-stacked block stack splits over the ranks of one mesh axis:
stage s owns periods [s P/S, (s+1) P/S).  The batch is cut into
``n_micro`` microbatches, pumped through the classic GPipe schedule of
``n_micro + n_stages - 1`` ticks (bubble fraction (S-1)/(M+S-1)): at tick
t stage s runs microbatch t - s when there is one, taking it from the
queue (stage 0) or from stage s-1 by a point-to-point ``recv``, and hands
its output to stage s+1 by a ``send`` (gloo and NCCL both have them; the
sends are asynchronous, so a stage computes its next microbatch while its
last output travels).  The last stage's outputs are broadcast over the
axis, so every rank returns the whole (B, S, D) result, as the reference's
``shard_map`` leaves it.

Like the reference, this pipelines the BLOCK STACK only (the embedding and
the LM head stay with the caller), and it computes the sequential stack's
forward: stage by stage the same periods on the same rows.  It is a
forward pass; gradients do not cross the stages' sends, so a call under
autograd with inputs that require gradients is refused.
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import _apply_period, _period
from repro_torch.tree import tree_leaves


def pipeline_blocks(blocks, x, cfg: ModelConfig, mesh, *, axis: str = "pod",
                    n_micro: int | None = None):
    """Run the block stack as a GPipe pipeline over ``axis`` of ``mesh``
    (a rank's mesh; every rank of the axis calls this).

    blocks: period-stacked params (n_periods, ...), whole on every rank
    (each stage runs its periods, views of the stack); x: (B, S, D)
    activations, the same on every rank (batch divisible by n_micro).
    Returns y: (B, S, D) on every rank."""
    ax = mesh.axis(axis)
    n_stages = ax.size
    n_micro = n_micro or n_stages
    b, s = x.shape[:2]
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} "
                         "microbatches")
    n_periods = tree_leaves(blocks)[0].shape[0]
    if n_periods % n_stages:
        raise ValueError(f"{n_periods} periods do not split over "
                         f"{n_stages} stages")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in tree_leaves(blocks) + [x]):
        raise NotImplementedError(
            "pipeline_blocks is a forward pass: gradients do not cross the "
            "stages (call it under torch.no_grad())")
    mb, per, stage = b // n_micro, n_periods // n_stages, ax.index
    mine = [_period(blocks, i) for i in range(stage * per, (stage + 1) * per)]
    positions = torch.arange(s, device=x.device)[None].expand(mb, s)
    micro = x.reshape(n_micro, mb, *x.shape[1:])
    outs, sent = [], []
    for t in range(n_micro + n_stages - 1):
        m = t - stage
        if not 0 <= m < n_micro:
            continue
        h = micro[m] if stage == 0 else ax.recv(micro[m], stage - 1)
        for pp in mine:
            h, _ = _apply_period(pp, h, cfg, positions)
        if stage < n_stages - 1:
            sent.append(ax.isend(h, stage + 1))
        else:
            outs.append(h)
    for work in sent:
        work.wait()
    y = torch.cat(outs) if outs else torch.empty_like(x)
    return ax.broadcast(y.reshape(x.shape), src=n_stages - 1)


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    """GPipe bubble overhead: (S-1)/(M+S-1)."""
    return (n_stages - 1) / (n_micro + n_stages - 1)
