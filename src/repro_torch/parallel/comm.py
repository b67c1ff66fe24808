"""The collectives of sharded serving — what XLA's SPMD partitioner inserts
into the reference's sharded step functions, written out and counted.

A rank's view of one mesh axis (or of several, flattened row-major) is an
:class:`Axis`: its size, the rank's index along it and the process group of
the ranks that share every other coordinate.  A model call learns how its
work is split from a :class:`StepSharding` (the model axis where tensor
parallelism applies, the axes its rows are split over), which the batchers
pass down with each call as they pass ``backend``.

Four operations, each counted in :func:`collective_counts` (beside the
kernels' ``engine.launch_counts``) where it crosses ranks; an axis of size
1 is the identity and counts nothing:

  * ``all_reduce_sum`` — the row-parallel projections' partial products,
    the vocabulary-sharded embedding lookup, the MoE partial outputs;
  * ``all_reduce_max`` — a K-sharded row's activation scale;
  * ``all_gather`` — vocabulary-sharded logits, the next-token vector of a
    batch split over data;
  * ``broadcast``.

Backends: NCCL when every rank has a card of its own, gloo when ranks share
a card or run on the CPU (:func:`choose_backend`).  gloo collectives on a
card's tensors are staged through host memory, one copy each way: gloo has
no CUDA all-gather, and one staged path serves all four operations.  gloo
reduces no bfloat16, so bfloat16 tensors travel as float32 there (exact for
the max and the gather; the sums of this package are float32 already).
"""
from __future__ import annotations

import collections
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

OPS = ("all_reduce_sum", "all_reduce_max", "all_gather", "broadcast")

# collectives since the last reset, by operation: each Axis method adds one
# where it crosses ranks, and nowhere else
COUNTS: collections.Counter = collections.Counter()


def collective_counts() -> dict[str, int]:
    """Collectives since the last :func:`reset_collective_counts`, by
    operation."""
    return {op: COUNTS[op] for op in OPS}


def reset_collective_counts() -> None:
    COUNTS.clear()


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
                 group, backend: str | None):
        self.names = names
        self.size = size
        self.index = index
        self.group = group
        self.backend = backend
        if size > 1 and group is None:
            raise ValueError(f"axes {names} of size {size} have no process "
                             "group: build the mesh with launch.mesh."
                             "make_mesh inside an initialized process group")

    def __repr__(self) -> str:
        return f"Axis({'x'.join(self.names)}, size={self.size}, " \
               f"index={self.index})"

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """A fresh contiguous copy of ``t`` in the form the backend reduces:
        on the host for gloo, float32 for a bfloat16 tensor on gloo."""
        if self.backend == "gloo":
            dt = torch.float32 if t.dtype == torch.bfloat16 else t.dtype
            return t.detach().to("cpu", dt, copy=True).contiguous()
        return t.detach().clone(memory_format=torch.contiguous_format)

    def _back(self, w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return w.to(like.device, like.dtype)

    def _reduce(self, t: torch.Tensor, op, name: str) -> torch.Tensor:
        if self.size == 1:
            return t
        w = self._wire(t)
        dist.all_reduce(w, op=op, group=self.group)
        COUNTS[name] += 1
        return self._back(w, t)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise sum of ``t`` over the axis (a new tensor)."""
        return self._reduce(t, dist.ReduceOp.SUM, "all_reduce_sum")

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise max of ``t`` over the axis (a new tensor)."""
        return self._reduce(t, dist.ReduceOp.MAX, "all_reduce_max")

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The ranks' ``t`` concatenated along ``dim`` in index order."""
        if self.size == 1:
            return t
        w = self._wire(t)
        parts = [torch.empty_like(w) for _ in range(self.size)]
        dist.all_gather(parts, w, group=self.group)
        COUNTS["all_gather"] += 1
        return self._back(torch.cat(parts, dim=dim), t)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """The value of ``t`` at index ``src`` on every rank (a new
        tensor)."""
        if self.size == 1:
            return t
        w = self._wire(t)
        dist.broadcast(w, dist.get_global_rank(self.group, src),
                       group=self.group)
        COUNTS["broadcast"] += 1
        return self._back(w, t)


class StepSharding(NamedTuple):
    """How one model call's work is split over a mesh.

    ``tp``: the model axis where tensor parallelism applies (params cut by
    ``parallel.sharding.param_specs``; of size 1 on a mesh with no model
    split), else None (one device, or pure DP).  ``rows``: the axes the
    call's rows (its batch) are split over, else None (every rank holds
    every row)."""
    mesh: Any
    tp: Axis | None = None
    rows: Axis | None = None
