"""The collectives of sharded serving and training — what XLA's SPMD
partitioner inserts into the reference's sharded step functions (and into
their ``jax.grad``), written out and counted.

A rank's view of one mesh axis (or of several, flattened row-major) is an
:class:`Axis`: its size, the rank's index along it and the process group of
the ranks that share every other coordinate.  A model call learns how its
work is split from a :class:`StepSharding` (the model axis where tensor
parallelism applies, the axes its rows are split over), which the batchers
and the train step pass down with each call as they pass ``backend``.

Four collectives, each counted in :func:`collective_counts` (beside the
kernels' ``engine.launch_counts``) where it crosses ranks; an axis of size
1 is the identity and counts nothing:

  * ``all_reduce_sum`` — the row-parallel projections' partial products,
    the vocabulary-sharded embedding lookup, the MoE partial outputs, a
    train step's gradient bucket;
  * ``all_reduce_max`` — an activation scale over a split tensor;
  * ``all_gather`` — vocabulary-sharded logits, the next-token vector of a
    batch split over data, the rows of the MoE's global slot map;
  * ``broadcast``;

and point-to-point ``send`` / ``recv`` (the pipeline's stage-to-stage
activations), counted in :func:`p2p_counts`.  Each also adds its wire bytes
a rank to :func:`collective_bytes`, by the ring algorithms' count (the
tensor's own dtype): an all-reduce 2 (n-1)/n of the tensor's bytes, an
all-gather (n-1) times the rank's part, a broadcast, a send or a receive
the tensor's bytes.

A *dry* axis (``Axis(..., dry=True)``, the axes of a dry mesh: one rank of
a mesh that no process group backs, ``launch.mesh.make_production_mesh``)
communicates nothing: each collective counts itself and its bytes as the
real one does and returns a tensor of the real result's shape and dtype
(this rank's values, repeated for a gather), under autograd the same
graph.  The dry run (``launch.dryrun``) traces one rank's step with it.

Under autograd the collectives carry gradients, Megatron's f/g pair (what
XLA's partitioner puts into the reference's ``jax.grad`` of a sharded
step).  The ranks of a model axis compute one replicated objective, so the
cotangent of a tensor replicated over that axis is the same on each rank:

  * ``all_reduce_sum`` (g): backward is the identity, or, with
    ``reduce_grad`` (ranks that each hold their own objective: a train
    step's rows), the sum of the cotangent over the axis;
  * ``all_gather``: backward takes this rank's slice of the cotangent, or,
    with ``reduce_grad``, the slice of its sum over the axis;
  * :meth:`Axis.enter` (f): the identity, whose backward sums the
    cotangent over the axis — where a replicated tensor enters a region
    split over the axis (a column-parallel projection, the experts held
    here), whose cotangent each rank holds only its part of.

``all_reduce_max`` and ``broadcast`` carry no gradient (the activation
scale they serve is detached in both packages).  A collective made in a
backward pass is counted in :func:`collective_counts` and also in
:func:`backward_counts`; a send or receive made in one, in
:func:`p2p_counts` and also in ``p2p_counts(backward=True)``.

Backends: NCCL when every rank has a card of its own, gloo when ranks share
a card or run on the CPU (:func:`choose_backend`).  gloo collectives on a
card's tensors are staged through host memory, one copy each way: gloo has
no CUDA all-gather, and one staged path serves every operation.  gloo
reduces no bfloat16, so bfloat16 tensors travel as float32 there (exact for
the max and the gather; the sums of this package are float32 already).
"""
from __future__ import annotations

import collections
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

OPS = ("all_reduce_sum", "all_reduce_max", "all_gather", "broadcast")
P2P = ("send", "recv")

# collectives since the last reset, by operation: each Axis method adds one
# where it crosses ranks, and nowhere else; BACKWARD holds those made in a
# backward pass (counted in COUNTS too)
COUNTS: collections.Counter = collections.Counter()
BACKWARD: collections.Counter = collections.Counter()
# wire bytes a rank since the last reset, by operation (COUNTS' operations)
BYTES: collections.Counter = collections.Counter()


def collective_counts() -> dict[str, int]:
    """Collectives since the last :func:`reset_collective_counts`, by
    operation, forward and backward."""
    return {op: COUNTS[op] for op in OPS}


def collective_bytes() -> dict[str, int]:
    """Wire bytes a rank of the collectives of :func:`collective_counts`,
    by operation (the module docstring's count)."""
    return {op: BYTES[op] for op in OPS}


def backward_counts() -> dict[str, int]:
    """The collectives of :func:`collective_counts` made in backward
    passes."""
    return {op: BACKWARD[op] for op in OPS}


def p2p_counts(backward: bool = False) -> dict[str, int]:
    """Point-to-point sends and receives since the last reset (with
    ``backward``, those made in backward passes)."""
    return {op: (BACKWARD if backward else COUNTS)[op] for op in P2P}


def reset_collective_counts() -> None:
    COUNTS.clear()
    BACKWARD.clear()
    BYTES.clear()


def choose_backend(device_type: str, n_ranks: int) -> str:
    """``nccl`` when every rank has a card of its own, else ``gloo`` (ranks
    sharing a card, or on the CPU)."""
    if device_type == "cuda" and torch.cuda.device_count() >= n_ranks:
        return "nccl"
    return "gloo"


class Axis:
    """One rank's view of mesh axes ``names`` (flattened row-major): ``size``
    ranks, this rank at ``index``, joined by ``group`` (None for size 1)."""

    def __init__(self, names: tuple[str, ...], size: int, index: int,
                 group, backend: str | None, dry: bool = False):
        self.names = names
        self.size = size
        self.index = index
        self.group = group
        self.backend = backend
        self.dry = dry
        if size > 1 and group is None and not dry:
            raise ValueError(f"axes {names} of size {size} have no process "
                             "group: build the mesh with launch.mesh."
                             "make_mesh inside an initialized process group, "
                             "or, for one rank of a mesh with no group, a dry "
                             "mesh (launch.mesh.make_production_mesh)")

    def __repr__(self) -> str:
        return f"Axis({'x'.join(self.names)}, size={self.size}, " \
               f"index={self.index}{', dry' if self.dry else ''})"

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """A fresh contiguous copy of ``t`` in the form the backend reduces:
        on the host for gloo, float32 for a bfloat16 tensor on gloo."""
        if self.backend == "gloo":
            dt = torch.float32 if t.dtype == torch.bfloat16 else t.dtype
            return t.detach().to("cpu", dt, copy=True).contiguous()
        return t.detach().clone(memory_format=torch.contiguous_format)

    def _back(self, w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return w.to(like.device, like.dtype)

    def _reduce(self, t: torch.Tensor, op, name: str,
                backward: bool = False) -> torch.Tensor:
        _count(name, backward, 2 * (self.size - 1) * _nbytes(t) // self.size)
        if self.dry:
            return t.detach().clone()
        w = self._wire(t)
        dist.all_reduce(w, op=op, group=self.group)
        return self._back(w, t)

    def _gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        _count("all_gather", nbytes=(self.size - 1) * _nbytes(t))
        if self.dry:
            return torch.cat([t.detach()] * self.size, dim=dim)
        w = self._wire(t)
        parts = [torch.empty_like(w) for _ in range(self.size)]
        dist.all_gather(parts, w, group=self.group)
        return self._back(torch.cat(parts, dim=dim), t)

    def all_reduce_sum(self, t: torch.Tensor, *,
                       reduce_grad: bool = False) -> torch.Tensor:
        """Elementwise sum of ``t`` over the axis (a new tensor); under
        autograd the output is replicated over the axis and the backward
        is the identity (g), or with ``reduce_grad`` (each rank its own
        objective) the cotangent summed over the axis."""
        if self.size == 1:
            return t
        return _AllReduceSum.apply(t, self, reduce_grad)

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise max of ``t`` over the axis (a new tensor, no
        gradient)."""
        if self.size == 1:
            return t
        return self._reduce(t, dist.ReduceOp.MAX, "all_reduce_max")

    def all_gather(self, t: torch.Tensor, dim: int = 0, *,
                   reduce_grad: bool = False) -> torch.Tensor:
        """The ranks' ``t`` concatenated along ``dim`` in index order.
        Backward: this rank's slice of the cotangent, or with
        ``reduce_grad`` the slice of its sum over the axis."""
        if self.size == 1:
            return t
        return _AllGather.apply(t, self, dim, reduce_grad)

    def enter(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (replicated over the axis) where it enters a region split
        over the axis: the identity, whose backward sums the cotangent over
        the axis (f)."""
        if self.size == 1 or not torch.is_grad_enabled() or \
                not t.requires_grad:
            return t
        return _Enter.apply(t, self)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """The value of ``t`` at index ``src`` on every rank (a new
        tensor)."""
        if self.size == 1:
            return t
        _count("broadcast", nbytes=_nbytes(t))
        if self.dry:
            return t.detach().clone()
        w = self._wire(t)
        dist.broadcast(w, dist.get_global_rank(self.group, src),
                       group=self.group)
        return self._back(w, t)

    def isend(self, t: torch.Tensor, dst: int, backward: bool = False):
        """Start sending ``t`` to the rank at index ``dst`` of the axis (no
        gradient); returns the work, to ``wait()`` on (it holds the staged
        copy until then).  ``backward``: made in a backward pass."""
        _count("send", backward, _nbytes(t))
        if self.dry:
            return _Sent(None, t)
        w = self._wire(t)
        work = dist.isend(w, dist.get_global_rank(self.group, dst),
                          group=self.group)
        return _Sent(work, w)

    def recv(self, like: torch.Tensor, src: int,
             backward: bool = False) -> torch.Tensor:
        """A tensor of ``like``'s shape, dtype and device received from the
        rank at index ``src`` of the axis.  ``backward``: made in a
        backward pass."""
        _count("recv", backward, _nbytes(like))
        if self.dry:
            return torch.zeros_like(like)
        w = self._wire(torch.empty_like(like))
        dist.recv(w, dist.get_global_rank(self.group, src), group=self.group)
        return self._back(w, like)


class _Sent(NamedTuple):
    """An asynchronous send and the buffer it reads."""
    work: Any
    buffer: torch.Tensor

    def wait(self) -> None:
        if self.work is not None:          # None: a dry axis's send
            self.work.wait()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _count(name: str, backward: bool = False, nbytes: int = 0) -> None:
    COUNTS[name] += 1
    BYTES[name] += int(nbytes)
    if backward:
        BACKWARD[name] += 1


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis, reduce_grad):
        ctx.axis, ctx.reduce_grad = axis, reduce_grad
        return axis._reduce(t, dist.ReduceOp.SUM, "all_reduce_sum")

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce_grad:
            g = ctx.axis._reduce(g, dist.ReduceOp.SUM, "all_reduce_sum",
                                 backward=True)
        return g, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis, dim, reduce_grad):
        ctx.axis, ctx.dim, ctx.reduce_grad = axis, dim, reduce_grad
        ctx.n = t.shape[dim]
        return axis._gather(t, dim)

    @staticmethod
    def backward(ctx, g):
        axis = ctx.axis
        if ctx.reduce_grad:
            g = axis._reduce(g, dist.ReduceOp.SUM, "all_reduce_sum",
                             backward=True)
        return g.narrow(ctx.dim, axis.index * ctx.n, ctx.n), None, None, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis = axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis._reduce(g, dist.ReduceOp.SUM, "all_reduce_sum",
                                backward=True), None


class StepSharding(NamedTuple):
    """How one model call's work is split over a mesh.

    ``tp``: the model axis where tensor parallelism applies (params cut by
    ``parallel.sharding.param_specs``; of size 1 on a mesh with no model
    split), else None (one device, or pure DP).  ``rows``: the axes the
    call's rows (its batch) are split over, else None (every rank holds
    every row).  ``global_rows``: the call is one rank's share of a train
    step's global batch, so what the reference computes over the whole
    batch is computed over every rank's rows — the fake-quant activation
    scale (one absmax over the tensor), the MoE's routing (its capacity
    and load-balance terms over the global slot map).

    ``seq``: the axes a decode step's cache holds a slice of the SEQUENCE
    over (``parallel.sharding.cache_specs``: the data axes when the batch
    does not divide them, or 'model' under ``kv_seq_shard``), else None:
    each rank attends its own positions and the partials are combined over
    it (``models.layers.attn_apply``).  ``fsdp``: the data axis that the
    FSDP rule of ``param_specs`` cuts expert weights' K over, else None:
    a layer gathers such a weight where it uses it."""
    mesh: Any
    tp: Axis | None = None
    rows: Axis | None = None
    global_rows: bool = False
    seq: Axis | None = None
    fsdp: Axis | None = None

    def every(self) -> Axis:
        """This rank's view of every axis of the mesh (flattened)."""
        return self.mesh.axis(self.mesh.axis_names)
