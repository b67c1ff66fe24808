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
forward: stage by stage the same periods on the same rows.

Gradients (a call under autograd whose blocks or ``x`` require one) run
the reverse GPipe schedule, as ``jax.grad`` transposes the reference's
``shard_map``: each stage keeps its microbatches' inputs from the forward;
in the backward the last stage takes y's cotangent (the output is one
replicated objective over the axis, so the broadcast hands the last stage
its own cotangent, not the sum over the ranks), and tick by tick in
reverse each stage receives the cotangent of its output for a microbatch
from stage s+1, recomputes its periods on that microbatch and takes their
gradient (``torch.autograd.backward``), and sends the input's cotangent to
stage s-1 (asynchronous sends, waited on before the backward returns; both
directions keep the forward's tick order, so no receive waits on a send
that is never made).  Every rank holds the whole stack and each stage has
the gradient of its own periods (zeros elsewhere); ``x`` is used by stage
0 alone.  One flat f32 bucket, all-reduced over the axis, sums the
stages' parts, so every rank ends with the whole gradient of the stack and
of ``x`` (the transpose of the reference's replicated ``P()`` input), the
same bits on every rank (one non-zero part an entry).  The backward's
sends, receives and bucket are counted in ``comm.p2p_counts(backward=True)``
and ``comm.backward_counts()``.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import _apply_period, _period
from repro_torch.tree import tree_leaves, tree_unflatten


class _Plan(NamedTuple):
    """One pipeline call: the stack's tree, the config, the pipeline axis,
    the microbatch count."""
    blocks: Any
    cfg: ModelConfig
    ax: Any
    n_micro: int

    def periods(self, blocks) -> list:
        """This stage's periods of ``blocks`` (views of the stack)."""
        n_stages, stage = self.ax.size, self.ax.index
        per = tree_leaves(blocks)[0].shape[0] // n_stages
        return [_period(blocks, i) for i in range(stage * per,
                                                  (stage + 1) * per)]


def _run_stage(plan: _Plan, periods, h):
    b, s = h.shape[:2]
    positions = torch.arange(s, device=h.device)[None].expand(b, s)
    for pp in periods:
        h, _ = _apply_period(pp, h, plan.cfg, positions)
    return h


def _forward(plan: _Plan, blocks, x):
    """The forward schedule: (y on every rank, this stage's input of each
    microbatch)."""
    ax, n_micro = plan.ax, plan.n_micro
    n_stages, stage = ax.size, ax.index
    mine = plan.periods(blocks)
    micro = x.reshape(n_micro, x.shape[0] // n_micro, *x.shape[1:])
    outs, sent, inputs = [], [], []
    for t in range(n_micro + n_stages - 1):
        m = t - stage
        if not 0 <= m < n_micro:
            continue
        h = micro[m] if stage == 0 else ax.recv(micro[m], stage - 1)
        inputs.append(h)
        h = _run_stage(plan, mine, h)
        if stage < n_stages - 1:
            sent.append(ax.isend(h, stage + 1))
        else:
            outs.append(h)
    for work in sent:
        work.wait()
    y = torch.cat(outs) if outs else torch.empty_like(x)
    return ax.broadcast(y.reshape(x.shape), src=n_stages - 1), inputs


class _GPipe(torch.autograd.Function):
    """The pipeline under autograd: the forward schedule, then the reverse
    schedule and the bucket (the module docstring)."""

    @staticmethod
    def forward(ctx, plan, x, *leaves):
        y, ctx.inputs = _forward(plan, tree_unflatten(plan.blocks,
                                                      list(leaves)), x)
        ctx.plan = plan
        ctx.save_for_backward(*leaves)
        return y

    @staticmethod
    def backward(ctx, gy):
        plan, ax = ctx.plan, ctx.plan.ax
        n_stages, stage, n_micro = ax.size, ax.index, plan.n_micro
        need_x, need = ctx.needs_input_grad[1], ctx.needs_input_grad[2:]
        leaves = [t.detach().requires_grad_(n) for t, n in
                  zip(ctx.saved_tensors, need)]
        with torch.enable_grad():        # the periods' views carry grads
            mine = plan.periods(tree_unflatten(plan.blocks, leaves))
        wrt = [t for t in leaves if t.requires_grad]
        gy = gy.reshape(n_micro, gy.shape[0] // n_micro, *gy.shape[1:])
        gx, sent = [None] * n_micro, []
        for m in reversed(range(n_micro)):
            g = gy[m] if stage == n_stages - 1 else \
                ax.recv(gy[m], stage + 1, backward=True)
            h0 = ctx.inputs[m].detach().requires_grad_(stage > 0 or need_x)
            with torch.enable_grad():
                h = _run_stage(plan, mine, h0)
            torch.autograd.backward(h, g, inputs=wrt + ([h0] if
                                                        h0.requires_grad
                                                        else []))
            if stage > 0:
                sent.append(ax.isend(h0.grad, stage - 1, backward=True))
            elif need_x:
                gx[m] = h0.grad
        for work in sent:
            work.wait()
        parts = [t.grad if t.grad is not None else torch.zeros_like(t)
                 for t in wrt]
        if need_x:
            parts.append(torch.cat(gx) if stage == 0 else
                         gy.new_zeros(gy.shape).flatten(0, 1))
        flat = torch.cat([t.reshape(-1).to(torch.float32) for t in parts])
        if n_stages > 1:
            flat = ax._reduce(flat, dist.ReduceOp.SUM, "all_reduce_sum",
                              backward=True)
        grads, at = [], 0
        for t in parts:
            grads.append(flat[at:at + t.numel()].view(t.shape).to(t.dtype))
            at += t.numel()
        out = iter(grads)
        g_leaves = [next(out) if n else None for n in need]
        return (None, next(out) if need_x else None, *g_leaves)


def pipeline_blocks(blocks, x, cfg: ModelConfig, mesh, *, axis: str = "pod",
                    n_micro: int | None = None):
    """Run the block stack as a GPipe pipeline over ``axis`` of ``mesh``
    (a rank's mesh; every rank of the axis calls this).

    blocks: period-stacked params (n_periods, ...), whole on every rank
    (each stage runs its periods, views of the stack); x: (B, S, D)
    activations, the same on every rank (batch divisible by n_micro).
    Returns y: (B, S, D) on every rank; under autograd its backward gives
    every rank the whole gradient of ``blocks`` and ``x``."""
    ax = mesh.axis(axis)
    n_stages = ax.size
    n_micro = n_micro or n_stages
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} "
                         "microbatches")
    leaves = tree_leaves(blocks)
    n_periods = leaves[0].shape[0]
    if n_periods % n_stages:
        raise ValueError(f"{n_periods} periods do not split over "
                         f"{n_stages} stages")
    plan = _Plan(blocks, cfg, ax, n_micro)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in leaves + [x]):
        return _GPipe.apply(plan, x, *leaves)
    return _forward(plan, blocks, x)[0]


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    """GPipe bubble overhead: (S-1)/(M+S-1)."""
    return (n_stages - 1) / (n_micro + n_stages - 1)
