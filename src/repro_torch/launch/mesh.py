"""Meshes of ranks — the port of ``repro.launch.mesh`` on
``torch.distributed``.

A :class:`Mesh` has the reference mesh's ``shape`` (axis -> size, ordered)
and ``axis_names``; ranks are laid out row-major over (``pod``,) ``data``,
``model``, as ``jax.make_mesh`` lays out devices.  Built inside an
initialized process group (:func:`make_mesh`, or a rank of :func:`spawn`) it
also knows the calling rank, its coordinate on each axis, one process group
per set of axes and the rank's ``torch.device``; built from a shape alone it
holds no group, which is all the spec functions of
``repro_torch.parallel.sharding`` need.

:func:`spawn` starts one process per rank (the ``spawn`` start method, a
file store in a temporary directory), runs ``fn(mesh, *args)`` on each and
returns their results; rank r takes ``cuda:(r % device_count)``, or the
CPU.  A rank that raises fails the whole call.

:func:`make_production_mesh` is the reference's production pod (16 x 16,
or 2 x 16 x 16 with ``multi_pod``) as one rank sees it with no process
group: a *dry* mesh, whose axes (``parallel.comm.Axis`` with ``dry``)
count their collectives and communicate nothing.  The dry run
(``launch.dryrun``) traces one rank's step on it.  A mesh of several ranks
built from a shape alone and not marked dry refuses to give an axis.
"""
from __future__ import annotations

import datetime
import itertools
import math
import os
import pickle
import tempfile

import torch
import torch.distributed as dist

from repro_torch.parallel.comm import Axis, choose_backend


# seconds a collective (or the store) waits for every rank of a spawn
RANK_TIMEOUT_S = 600


class Mesh:
    """An ordered mapping of axis -> size, and, inside a process group, the
    calling rank's place in it (``rank``, ``coords``), its process groups
    and its ``device`` (None for a mesh of the shape alone)."""

    def __init__(self, shape: dict[str, int], *, rank: int = 0,
                 groups: dict | None = None, backend: str | None = None,
                 device=None, dry: bool = False):
        self.shape = dict(shape)
        self.dry = dry
        self.axis_names = tuple(self.shape)
        self.size = math.prod(self.shape.values())
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = rank
        self.coords = dict(zip(self.axis_names, _unravel(rank, self.shape)))
        self.groups = groups
        self.backend = backend
        self.device = torch.device(device) if device is not None else None

    def __repr__(self) -> str:
        dims = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        where = "dry" if self.dry else f"on {self.device}"
        return f"Mesh({dims}; rank {self.rank} {where})"

    def barrier(self) -> None:
        """Wait for every rank of the mesh (a dry mesh waits for none)."""
        if self.size > 1 and not self.dry:
            dist.barrier(group=self.groups[self.axis_names])

    def axis(self, names) -> Axis:
        """This rank's view of axis ``names`` (a name or a tuple of names,
        flattened row-major in mesh order)."""
        names = (names,) if isinstance(names, str) else tuple(names)
        names = tuple(a for a in self.axis_names if a in names)
        size = math.prod(self.shape[a] for a in names)
        index = 0
        for a in names:
            index = index * self.shape[a] + self.coords[a]
        group = None
        if size > 1 and not self.dry:
            if self.groups is None:
                raise ValueError(
                    f"{self!r} was built from a shape alone: it has no "
                    "process groups (one rank of a mesh that no group backs "
                    "is a dry mesh: make_production_mesh, or Mesh(shape, "
                    "rank=r, dry=True))")
            group = self.groups[names]
        return Axis(names, size, index, group, self.backend, dry=self.dry)


def _unravel(rank: int, shape: dict[str, int]) -> tuple[int, ...]:
    coords = []
    for n in reversed(list(shape.values())):
        coords.append(rank % n)
        rank //= n
    return tuple(reversed(coords))


def _mesh_shape(n_data: int, n_model: int, n_pod: int) -> dict[str, int]:
    if n_pod > 1:
        return {"pod": n_pod, "data": n_data, "model": n_model}
    return {"data": n_data, "model": n_model}


def make_mesh(n_data: int, n_model: int, n_pod: int = 1, *, ranks=None,
              device=None) -> Mesh | None:
    """A (``pod``,) ``data``, ``model`` mesh.  Outside an initialized
    process group: from the shape alone (rank 0, no groups).  Inside one,
    over ``ranks`` (default: every rank of the world, in order); every rank
    of the world must call it, since each process group is created by all
    of them, and a rank outside ``ranks`` gets None."""
    shape = _mesh_shape(n_data, n_model, n_pod)
    size = math.prod(shape.values())
    if not dist.is_initialized():
        return Mesh(shape, device=device)
    ranks = list(range(dist.get_world_size())) if ranks is None \
        else list(ranks)
    if len(ranks) != size:
        raise ValueError(f"a {'x'.join(map(str, shape.values()))} mesh "
                         f"needs {size} ranks, got {len(ranks)}")
    me = dist.get_rank()
    names = tuple(shape)
    groups = {}
    # one group per non-empty set of axes and per value of the others, in
    # the same order on every rank (each new_group is collective)
    for r in range(1, len(names) + 1):
        for sub in itertools.combinations(names, r):
            rest = [a for a in names if a not in sub]
            for fixed in itertools.product(*(range(shape[a]) for a in rest)):
                members = []
                for moving in itertools.product(*(range(shape[a])
                                                  for a in sub)):
                    c = dict(zip(rest, fixed)) | dict(zip(sub, moving))
                    lin = 0
                    for a in names:
                        lin = lin * shape[a] + c[a]
                    members.append(ranks[lin])
                if len(members) < 2:
                    continue
                g = dist.new_group(members)
                if me in members:
                    groups[sub] = g
    if me not in ranks:
        return None
    return Mesh(shape, rank=ranks.index(me), groups=groups,
                backend=dist.get_backend(), device=device)


# the reference's production pod: 16 x 16 chips, two of them multi-pod
PRODUCTION_SHAPE = {"data": 16, "model": 16}


def make_production_mesh(multi_pod: bool = False, rank: int = 0) -> Mesh:
    """Rank ``rank`` of the reference's production mesh, ``{"data": 16,
    "model": 16}`` or with ``multi_pod`` ``{"pod": 2, "data": 16, "model":
    16}`` (the reference's axes and sizes, so the two packages' dry-run
    records compare cell for cell), as a dry mesh: no process group, its
    axes count their collectives and communicate nothing."""
    shape = _mesh_shape(PRODUCTION_SHAPE["data"], PRODUCTION_SHAPE["model"],
                        2 if multi_pod else 1)
    return Mesh(shape, rank=rank, dry=True)


def data_axes(mesh) -> tuple:
    """Axes that shard the batch (pod joins data when present)."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def parse_mesh(spec, max_ranks: int | None = None) -> Mesh | None:
    """``--mesh dp,mp`` -> a ('data', 'model') mesh of the shape alone (e.g.
    "2,4"; "1,1" is a one-rank mesh, the sharded batcher's exactness
    baseline).  ``None`` or empty returns None (one device, no mesh).  A
    mesh of more than ``max_ranks`` ranks raises."""
    if spec in (None, "", "none"):
        return None
    try:
        dp, mp = (int(v) for v in str(spec).split(","))
    except ValueError:
        raise ValueError(
            f"--mesh expects 'dp,mp' (e.g. '2,4'), got {spec!r}") from None
    if dp < 1 or mp < 1:
        raise ValueError(f"--mesh axes must be >= 1, got {spec!r}")
    if max_ranks is not None and dp * mp > max_ranks:
        raise ValueError(
            f"--mesh {spec} needs {dp * mp} ranks but only {max_ranks} are "
            "allowed (one process per rank)")
    return Mesh(_mesh_shape(dp, mp, 1))


def _rank_main(rank: int, shape: dict, backend: str, device_type: str,
               store: str, fn, args) -> None:
    n = math.prod(shape.values())
    if device_type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    # a rank that stops answering fails its peers' collectives after this,
    # rather than holding them for the default half hour
    dist.init_process_group(backend, init_method=f"file://{store}/store",
                            world_size=n, rank=rank,
                            timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    try:
        mesh = make_mesh(shape["data"], shape["model"], shape.get("pod", 1),
                         device=device)
        out = fn(mesh, *args)
        with open(os.path.join(store, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn(fn, mesh: Mesh, *args, device: str = "cuda") -> list:
    """Run ``fn(rank_mesh, *args)`` on one process per rank of ``mesh`` (a
    mesh of the shape alone) and return the ranks' results in rank order.
    ``fn`` and ``args`` are pickled to each process (tensors through shared
    memory, a card's tensors through CUDA IPC: the caller keeps them alive
    until this returns).  The backend is :func:`~repro_torch.parallel.comm.
    choose_backend`'s.  Any rank's exception fails the call."""
    device_type = torch.device(device).type
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("spawn(device='cuda'): no CUDA device is visible")
    backend = choose_backend(device_type, mesh.size)
    with tempfile.TemporaryDirectory(prefix="repro_torch_mesh_") as store:
        torch.multiprocessing.spawn(
            _rank_main, args=(mesh.shape, backend, device_type, store, fn,
                              args),
            nprocs=mesh.size, join=True, start_method="spawn")
        out = []
        for r in range(mesh.size):
            # written by this call's own ranks
            with open(os.path.join(store, f"result_{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out
