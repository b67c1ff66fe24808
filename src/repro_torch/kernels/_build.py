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
    "act_quant": {
        # (x, x_kind, out, M, F, bits, bf16, aligned, stream)
        "act_quant_unsigned": (P, I, P, I, I, I, I, I, P),
        # (x, x_kind, scale, s_kind, out, M, F, bits, bf16, aligned, stream)
        "act_quant_signed": (P, I, P, I, P, I, I, I, I, I, P),
        # (x, x_kind, scale, s_kind, out, M, F, G, bits, bf16, aligned, stream)
        "act_quant_signed_grouped": (P, I, P, I, P, I, I, I, I, I, I, P),
        # (x, x_kind, out, scale, M, F, bits, aligned, stream)
        "act_quant_signed_rows": (P, I, P, P, I, I, I, I, P),
        # (x, x_kind, out, scale, state, M, F, bits, aligned, stream)
        "act_quant_signed_tensor": (P, I, P, P, P, I, I, I, I, P),
    },
    "binary_matmul": {
        # (a, w, alpha, bias, out, M, N, K, stream)
        "binary_matmul": (P, P, P, P, P, I, I, I, P),
        # one named kernel (the tuning cache's picks, chip_smoke.py)
        # (a, w, alpha, bias, out, M, N, K, variant, stream)
        "binary_matmul_variant": (P, P, P, P, P, I, I, I, I, P),
        # () -> the largest M of the decode-rows kernel
        "binary_matmul_m_small": (),
    },
    "qmatmul": {
        # (x, x_kind, w, alpha, bias, out, M, N, K, stream)
        "ternary_matmul": (P, I, P, P, P, P, I, I, I, P),
        # (x, x_kind, w, scale, bias, out, M, N, K, bits, stream)
        "packed_matmul": (P, I, P, P, P, P, I, I, I, I, P),
        # int8 codes through one named kernel (the tuning cache's picks)
        # (x, w, scale, bias, out, M, N, K, bits, variant, stream)
        "qmatmul_int8_variant": (P, P, P, P, P, I, I, I, I, I, P),
        # () -> the largest M of the decode-rows kernel
        "qmatmul_m_small": (),
    },
    "decode_attention": {
        # (q, q_kind, k, k_scale, v, v_scale, pos, out,
        #  B, S, KV, G, Dh, stream)
        "decode_attention_int8": (P, I, P, P, P, P, P, P,
                                  I, I, I, I, I, P),
        # the tuning cache's plans and the optional log-sum-exp: (q,
        #  q_kind, k, k_scale, v, v_scale, pos, out, lse or null, B, S, KV,
        #  G, Dh, cluster, span_max, stream); 0 takes the automatic choice
        "decode_attention_config": (P, I, P, P, P, P, P, P, P,
                                    I, I, I, I, I, I, I, P),
        # (B, S, KV, G, Dh, k, v, plan[4]) -> 0; plan = (vector loads,
        # cluster size, span, shared-memory bytes of one block)
        "decode_attention_plan": (I, I, I, I, I, P, P, P),
    },
    "paged_attention": {
        # (q, q_kind, k, k_scale, v, v_scale, kv_kind, page_table, pos, out,
        #  B, NB, bs, n_blocks, KV, G, Dh, stream)
        "paged_attention": (P, I, P, P, P, P, I, P, P, P,
                            I, I, I, I, I, I, I, P),
        # measurement only: an explicit cluster size and span limit
        # (..., B, NB, bs, n_blocks, KV, G, Dh, cluster, span, stream)
        "paged_attention_config": (P, I, P, P, P, P, I, P, P, P,
                                   I, I, I, I, I, I, I, I, I, P),
        # (kv_kind, B, KV, G, Dh, bs, n_blocks, k, v, plan[3]) -> 0; plan =
        # (vector loads, cluster size, span)
        "paged_attention_plan": (I, I, I, I, I, I, I, P, P, P),
        # (kv_kind, B, KV, G, Dh, bs, n_blocks, k, v) -> shared-memory bytes
        # of one block
        "paged_attention_smem_bytes": (I, I, I, I, I, I, I, P, P),
    },
    "flash_attention": {
        # (q, k, v, kind, out, B, Sq, Sk, KV, G, Dh, causal, window,
        #  probs_bf16, softcap, sm_scale, stream)
        "flash_attention": (P, P, P, I, P, I, I, I, I, I, I, I, I, I, F, F,
                            P),
    },
    "decode_fused": {
        # (q, q_kind, k, k_scale, v, v_scale, kv_kind, page_table, pos,
        #  slot_map, wo, out, B, L, NB, bs, n_blocks, KV, G, Dh, D, stream)
        "fused_decode": (P, I, P, P, P, P, I, P, P, P, P, P,
                         I, I, I, I, I, I, I, I, I, P),
        # measurement only: (..., B, L, NB, bs, n_blocks, KV, G, Dh, D,
        #  variant, span, stream); variant bits: 1 skips the projection, 2
        #  the attention, 4 reads wo unstaged, 8 writes phase cycles, not
        #  results; span: the span limit (0: automatic)
        "fused_decode_variant": (P, I, P, P, P, P, I, P, P, P, P, P,
                                 I, I, I, I, I, I, I, I, I, I, I, P),
        # (kv_kind, KV, G, Dh, D, bs, n_blocks, k, v, wo) -> shared-memory
        # bytes of one block
        "fused_decode_smem_bytes": (I, I, I, I, I, I, I, P, P, P),
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
