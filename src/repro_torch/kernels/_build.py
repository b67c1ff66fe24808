"""Build and load the hand-written CUDA kernels (``src/repro_torch/csrc``).

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface and loaded through ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/repro_torch/lib<name>_<hash>.so <name>.cu

The build runs at first CUDA use (never at import), into
``build/repro_torch`` at the root of the checkout when the package runs from
one (``<root>/src/repro_torch`` beside ``<root>/pyproject.toml``), else, for
an installed package, into ``$XDG_CACHE_HOME/repro_torch`` (default
``~/.cache/repro_torch``).  The library's file name carries a hash of the
sources and flags, so a stale library never loads.  :func:`build_all` starts
one ``nvcc`` per source at once and waits for all of them.

A failed build raises with nvcc's output; nothing falls back.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"


def build_dir(pkg: Path) -> Path:
    """Where the libraries of the package at ``pkg`` are built: the
    checkout's ``build/`` for a source tree, a user cache for an install."""
    root = pkg.parent.parent
    if pkg.parent.name == "src" and (root / "pyproject.toml").is_file():
        return root / "build" / "repro_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "repro_torch"


BUILD_DIR = build_dir(CSRC.parent)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of every extern "C" launcher, by source; each returns a
# cudaError_t (0 = success).  The last argument is the CUDA stream.
SIGNATURES = {
    "qmatmul": {
        # (x, x_kind, w, alpha, bias, out, M, N, K, stream)
        "ternary_matmul": (P, I, P, P, P, P, I, I, I, P),
        # (x, x_kind, w, scale, bias, out, M, N, K, bits, stream)
        "packed_matmul": (P, I, P, P, P, P, I, I, I, I, P),
    },
    "decode_attention": {
        # (q, q_kind, k, k_scale, v, v_scale, pos, out,
        #  B, S, KV, G, Dh, sm_scale, stream)
        "decode_attention_int8": (P, I, P, P, P, P, P, P,
                                  I, I, I, I, I, F, P),
    },
}

# kernel launches, by wrapper name: each wrapper adds one where it launches
# its kernel, and nowhere else (the CPU path is not a launch)
LAUNCHES: collections.Counter = collections.Counter()

# ptxas register/shared-memory report of each build, by source
BUILD_LOG: dict[str, str] = {}

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from src/repro_torch/csrc at first use")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):         # .cu and shared .cuh
        if src.suffix == ".cuh" or src.stem == name:
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source into a temp file; returns (proc, tmp, out)."""
    out = _lib_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc, tmp: str, out: Path) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    BUILD_LOG[name] = log
    os.replace(tmp, out)                   # atomic: readers never see half


def _load(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    _LIBS[name] = lib
    return lib


def build_all() -> dict[str, ctypes.CDLL]:
    """Build every missing library in parallel (one nvcc per source, all
    started together), then load them all."""
    todo = [n for n in SIGNATURES
            if n not in _LIBS and not _lib_path(n).exists()]
    started = [(n, *_start(n)) for n in todo]
    for n, proc, tmp, out in started:
        _finish(n, proc, tmp, out)
    return {n: _LIBS.get(n) or _load(n, _lib_path(n)) for n in SIGNATURES}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    path = _lib_path(name)
    if not path.exists():
        _finish(name, *_start(name))
    return _load(name, path)


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t from a launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


def stream_ptr(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
