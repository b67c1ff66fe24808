"""Checkpointing — ``repro.checkpoint``'s, on the reference's on-disk
format, so a checkpoint written by either package restores in the other:

    <dir>/step_N/host_<h>/shards.npz     arrays arr_{i}_s{j}
    <dir>/step_N/host_<h>/manifest.json  {"step", "n_leaves", "treedef",
                                          "leaves": [{"shape", "dtype",
                                          "shards": [{"name", "index"}]}]}
    <dir>/step_N/COMPLETE                 written last

Leaf ``i`` is the i-th leaf in ``jax.tree_util``'s order (dict entries by
sorted key: ``repro_torch.tree``).  A state on one device writes each leaf
as one shard spanning the whole array.  A state cut over a mesh
(``shardings``, a ``parallel.sharding.TreeSharding``) is written as the
reference's hosts write theirs: each rank writes the slices it holds, with
their index ranges, under ``host_<rank>/``, each slice once (by the rank at
coordinate 0 of every axis the leaf is not cut over); no leaf is gathered.
``restore`` assembles every leaf from every host's slices, so a checkpoint
restores on one device, on another mesh (``shardings``: this rank's slices
are cut from the assembled leaves) and in the reference.  ``"treedef"`` is
a JAX proto in the reference's files; the port writes null and never reads
it (``restore`` takes the structure from ``like``).

A save writes ``step_N.tmp``, renames it to ``step_N``, then writes the
``COMPLETE`` sentinel; ``all_steps`` sees only sentineled steps, and
``restore_latest`` walks back past one that fails to load (a torn shard
file).  With ``blocking=False`` the device-to-host copy happens in the
call and the files are written by a background thread.

bfloat16 leaves: numpy has no bfloat16 without ``ml_dtypes``, which the
port does not use.  The reference's ``np.savez`` stores a JAX bf16 array
as raw 2-byte records (dtype ``|V2``), which the port reads back as the
bf16 bit patterns they are (the reference's own ``restore`` cannot cast
them).  The port stores a bf16 leaf as its float32 values, exactly, under
the dtype string ``"bfloat16"``: the reference's ``restore`` casts those
back to bfloat16 without loss.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import warnings
from typing import Any

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_leaves_along, tree_unflatten

_SENTINEL = "COMPLETE"


def _key_str(i):
    return f"arr_{i}"


def _host_index() -> int:
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return 0


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """(host array to store, dtype string for the manifest)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.to(torch.float32).numpy(), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str, like, cut=None) -> torch.Tensor:
    """A stored leaf as a tensor of ``like``'s dtype on ``like``'s device;
    ``cut`` (spec, mesh): this rank's slice of it."""
    if dtype == "bfloat16" and arr.dtype.kind == "V":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if cut is not None:
        from repro_torch.parallel.sharding import shard_leaf
        t = shard_leaf(t, *cut)
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype)
    return t


def _records(state, shardings) -> list:
    """Per leaf (global shape, manifest dtype, [(index, host array)]): the
    whole leaf, or over a mesh the slices this rank writes."""
    leaves = tree_leaves(state)
    if shardings is None:
        out = []
        for leaf in leaves:
            arr, dtype = _to_host(leaf)
            out.append((arr.shape, dtype, [([[0, int(n)] for n in arr.shape],
                                            arr)]))
        return out
    from repro_torch.parallel import sharding as shd
    mesh = shardings.mesh
    out = []
    for leaf, spec in zip(leaves, tree_leaves_along(state, shardings.specs)):
        shape = shd.global_shape(leaf.shape, spec, mesh)
        mine = shd.holds_first_copy(spec, mesh)
        arr, dtype = _to_host(leaf) if mine else (None, _dtype_name(leaf))
        out.append((shape, dtype, [(shd.slice_index(shape, spec, mesh), arr)]
                    if mine else []))
    return out


def _dtype_name(leaf) -> str:
    if leaf.dtype == torch.bfloat16:
        return "bfloat16"
    return str(torch.empty((), dtype=leaf.dtype).numpy().dtype)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Any, blocking: bool = True,
             shardings=None):
        """Save a tree of tensors (or numpy arrays).  ``shardings`` (a
        ``TreeSharding``: the state holds this rank's slices): every rank
        of the mesh calls ``save``; each writes its slices under
        ``host_<rank>/`` and the ranks meet at barriers (rank 0 prepares
        the directory and publishes it), so the save blocks."""
        self.wait()          # one in-flight save at a time
        records = _records(state, shardings)
        mesh = None if shardings is None else shardings.mesh
        step_dir = os.path.join(self.dir, f"step_{step}")
        tmp = step_dir + ".tmp"

        def write_host(host: int):
            host_dir = os.path.join(tmp, f"host_{host}")
            os.makedirs(host_dir, exist_ok=True)
            manifest = {"step": step, "n_leaves": len(records),
                        "treedef": None, "leaves": []}
            arrays = {}
            for i, (shape, dtype, shards) in enumerate(records):
                rec = {"shape": [int(n) for n in shape], "dtype": dtype,
                       "shards": []}
                for j, (index, arr) in enumerate(shards):
                    name = f"{_key_str(i)}_s{j}"
                    arrays[name] = arr
                    rec["shards"].append({"name": name, "index": index})
                manifest["leaves"].append(rec)
            np.savez(os.path.join(host_dir, "shards.npz"), **arrays)
            with open(os.path.join(host_dir, "manifest.json"), "w") as f:
                json.dump(manifest, f)

        def publish():
            if os.path.exists(step_dir):
                shutil.rmtree(step_dir)
            os.rename(tmp, step_dir)
            with open(os.path.join(step_dir, _SENTINEL), "w") as f:
                f.write("ok")
            self._gc()

        def fresh_tmp():
            if os.path.exists(tmp):
                shutil.rmtree(tmp)

        if mesh is not None and mesh.size > 1:
            if mesh.rank == 0:
                fresh_tmp()
            mesh.barrier()
            write_host(mesh.rank)
            mesh.barrier()
            if mesh.rank == 0:
                publish()
            mesh.barrier()
            return

        def write():
            fresh_tmp()
            write_host(_host_index())
            publish()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name, _SENTINEL)):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore_latest(self, like: Any, shardings=None):
        """Restore the newest restorable checkpoint, walking back past any
        that fail to load (a partial ``step_N`` without the COMPLETE
        sentinel is already invisible to :meth:`all_steps`; a
        sentineled-but-corrupt one, e.g. a torn shard file, is skipped with
        a warning).  Returns ``(step, state)``, or ``(None, like)`` when no
        checkpoint is restorable."""
        for step in reversed(self.all_steps()):
            try:
                return step, self.restore(step, like, shardings)
            except Exception as e:  # noqa: BLE001 — any torn artifact
                warnings.warn(
                    f"checkpoint step_{step} unrestorable ({type(e).__name__}:"
                    f" {e}); falling back to the previous complete one",
                    RuntimeWarning, stacklevel=2)
        return None, like

    def restore(self, step: int, like: Any, shardings=None) -> Any:
        """Restore into the structure of ``like`` (shapes validated; each
        leaf takes ``like``'s dtype and device).  ``shardings`` (a
        ``TreeSharding``) is the elastic re-shard onto a mesh, which may
        differ from the saving one: ``like`` holds this rank's slices,
        which are cut from the assembled leaves."""
        specs = None if shardings is None else \
            tree_leaves_along(like, shardings.specs)
        step_dir = os.path.join(self.dir, f"step_{step}")
        hosts = sorted(d for d in os.listdir(step_dir)
                       if d.startswith("host_"))
        leaves_like = tree_leaves(like)
        n = len(leaves_like)
        assembled: list = [None] * n
        dtypes: list = [None] * n
        for host in hosts:
            with open(os.path.join(step_dir, host, "manifest.json")) as f:
                manifest = json.load(f)
            if manifest["n_leaves"] != n:
                raise ValueError(f"tree structure changed: {n} leaves, the "
                                 f"checkpoint holds {manifest['n_leaves']}")
            with np.load(os.path.join(step_dir, host, "shards.npz")) as data:
                for i, rec in enumerate(manifest["leaves"]):
                    want = tuple(getattr(leaves_like[i], "shape", ()))
                    have = tuple(rec["shape"])
                    if specs is not None:
                        from repro_torch.parallel.sharding import local_shape
                        have = local_shape(have, specs[i], shardings.mesh)
                    if have != want:
                        raise ValueError(f"leaf {i}: {rec['shape']} vs "
                                         f"{list(want)}")
                    for shard in rec["shards"]:
                        part = data[shard["name"]]
                        if assembled[i] is None:
                            assembled[i] = np.zeros(tuple(rec["shape"]),
                                                    part.dtype)
                            dtypes[i] = rec["dtype"]
                        idx = tuple(slice(p[0], p[1])
                                    for p in shard["index"])
                        assembled[i][idx] = part
        cuts = [None] * n if specs is None else \
            [(spec, shardings.mesh) for spec in specs]
        return tree_unflatten(like, [_from_host(a, d, l, c) for a, d, l, c in
                                     zip(assembled, dtypes, leaves_like,
                                         cuts)])
