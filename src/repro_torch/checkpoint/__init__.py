"""Checkpointing — ``repro.checkpoint``'s, on the reference's on-disk
format, so a checkpoint written by either package restores in the other:

    <dir>/step_N/host_<h>/shards.npz     arrays arr_{i}_s{j}
    <dir>/step_N/host_<h>/manifest.json  {"step", "n_leaves", "treedef",
                                          "leaves": [{"shape", "dtype",
                                          "shards": [{"name", "index"}]}]}
    <dir>/step_N/COMPLETE                 written last

Leaf ``i`` is the i-th leaf in ``jax.tree_util``'s order (dict entries by
sorted key: ``repro_torch.tree``).  The port holds its whole state on one
device, so each leaf is one shard spanning the whole array.  ``"treedef"``
is a JAX proto in the reference's files; the port writes null and never
reads it (``restore`` takes the structure from ``like``).

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

from repro_torch.tree import tree_leaves, tree_unflatten

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


def _from_host(arr: np.ndarray, dtype: str, like) -> torch.Tensor:
    """A stored leaf as a tensor of ``like``'s dtype on ``like``'s device."""
    if dtype == "bfloat16" and arr.dtype.kind == "V":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype)
    return t


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Any, blocking: bool = True):
        """Save a tree of tensors (or numpy arrays)."""
        self.wait()          # one in-flight save at a time
        host = [_to_host(leaf) for leaf in tree_leaves(state)]

        def write():
            step_dir = os.path.join(self.dir, f"step_{step}")
            tmp = step_dir + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            host_dir = os.path.join(tmp, f"host_{_host_index()}")
            os.makedirs(host_dir, exist_ok=True)
            manifest = {"step": step, "n_leaves": len(host), "treedef": None,
                        "leaves": []}
            arrays = {}
            for i, (arr, dtype) in enumerate(host):
                name = f"{_key_str(i)}_s0"
                arrays[name] = arr
                manifest["leaves"].append({
                    "shape": list(arr.shape), "dtype": dtype,
                    "shards": [{"name": name,
                                "index": [[0, int(n)] for n in arr.shape]}]})
            np.savez(os.path.join(host_dir, "shards.npz"), **arrays)
            with open(os.path.join(host_dir, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(step_dir):
                shutil.rmtree(step_dir)
            os.rename(tmp, step_dir)
            with open(os.path.join(step_dir, _SENTINEL), "w") as f:
                f.write("ok")
            self._gc()

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
        leaf takes ``like``'s dtype and device).  ``shardings`` is the
        reference's elastic re-shard onto a mesh; the port runs on one
        device and takes only None."""
        if shardings is not None:
            raise NotImplementedError("restoring onto a mesh is not ported "
                                      "(ROADMAP Queue A item 9)")
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
                    if tuple(rec["shape"]) != want:
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
        return tree_unflatten(like, [_from_host(a, d, l) for a, d, l in
                                     zip(assembled, dtypes, leaves_like)])
