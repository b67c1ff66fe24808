"""H100 tuning cache: which compiled kernel, launch plan or pool block size a
shape class runs, persisted to JSON — the counterpart of
``repro.kernels.tuning``.

The reference tunes Pallas tiles (bm, bn, bk) per shape class.  The port's
kernels are compiled with fixed tiles (``csrc/``); what can be chosen per
shape class is *which* compiled kernel runs, or a kernel's launch plan, or
the pool's block size.  A "block" stays three positive ints, in the
reference's key format, so both packages can share one cache file:

  ========================  ==================================================
  cache kind                block
  ========================  ==================================================
  ``ternary``, ``int``      the output tile of one of the two int8-code kernels
  (B1, B3; w_bits 2/4/8)    of ``csrc/qmatmul.cu``: ``(8, 1, K)`` the decode
                            rows kernel (8 rows of one column a lane group,
                            all of K at once, ``__dp4a``), ``(64, 64, 128)``
                            the int8 tensor-core kernel (``mma.sync`` s8,
                            K tiles of 128 codes)
  ``binary`` (B6, 1x1)      the same for ``csrc/binary_matmul.cu``: ``(8, 1,
                            K)`` the ``__popc`` rows kernel, ``(64, 64, 512)``
                            the 1-bit tensor-core kernel (K stages of 512
                            bits)
  ``attn_decode`` (B5)      the paged core's launch plan ``(cluster, Dh,
                            span limit)``: cluster 1/2/4/8 blocks a (sequence,
                            KV head), span limit 1..32 positions a warp
  ``attn_paged`` (B2),      the reference's ``(1, Dh, block_size)``: the pool's
  ``attn_fused_decode``     block size is the knob
  (B4)
  ========================  ==================================================

Float activations (``a_bits == 0``) reach a single kernel
(``qmm_float_kernel``): nothing there is tuned, and the engine does not
look them up.  :func:`fallback_block` of a matmul kind is what the C file's
automatic rule picks for this M and N (the rows kernel while M <= 64 and
M * N <= 64 * 1536, ``qmatmul.cu`` and ``binary_matmul.cu``), so a cold
cache launches exactly the automatic choice.  A B5 miss runs the kernel's
automatic plan (``decode_attention_config`` with 0, 0).

Keys carry the port's backend (``cuda|...`` on the card, ``torch|...``
for sweeps of the plain versions on the CPU), so they never collide with
the reference's ``pallas|...`` / ``xla|...`` entries; the file is the
reference's format (``{"version": 1, "entries": {...}}``), and every entry
is ``{"block": [3 positive ints], "us", "default_us", "swept"}``, which the
reference's ``_sane_entry`` keeps when it merges the file on write.  The
file is ``~/.cache/repro_torch/tuning.json``, or ``REPRO_TUNING_CACHE``.

:func:`get_block_sizes` is the hot-path entry and never sweeps.  Eager
PyTorch dispatches every call (210 matmuls a 2xT decode step), so the
resolution is memoised per (kind, bits, backend, M bucket, N, K) and a hit
or a miss is counted once per distinct resolution — what the reference
counts once per jit trace.  :func:`reset`, :func:`autotune` and
:func:`prime` clear the memo.
"""
from __future__ import annotations

import json
import os
import statistics
import time
import warnings
from collections.abc import Callable, Sequence

Block = tuple[int, int, int]

# ---- the compiled kernels' tiles and the C files' automatic rule --------
ROWS_RT = 8                          # rows kernels: RT output rows a block
QMM_MMA_TILE: Block = (64, 64, 128)  # MM_BM, MM_BN, MM_BK of qmatmul.cu
XNOR_TC_TILE: Block = (64, 64, 512)  # TC_BM, TC_BN, 32 * TC_BKW bits
M_SMALL = 64                         # qmatmul.cu / binary_matmul.cu
ROWS_MAX_MN = M_SMALL * 1536
VARIANT_ROWS, VARIANT_TC = 0, 1      # the C variant entries' numbering
# packed kinds with CUDA kernels, by weight bits
KERNEL_BITS = {"int": (2, 4, 8), "ternary": (2,), "binary": (1,)}

ATTN_DECODE = "attn_decode"
ATTN_PAGED = "attn_paged"
ATTN_FUSED = "attn_fused_decode"
PA_CLUSTERS = (1, 2, 4, 8)           # csrc/paged_common.cuh: PA_CLUSTER_MAX 8
PA_SPAN_MAX = 32
PA_SPAN = 16                         # the automatic span limit, one block
DEFAULT_KV_BLOCK = 16

# In-memory cache state.  ``_cache is None`` means "not loaded yet"; loading
# is lazy so importing the engine never touches the filesystem.
_cache: dict[str, dict] | None = None
_cache_src: str | None = None
# keys this process actually MEASURED (vs merely loaded from disk): only
# these may overwrite a concurrent writer's fresher on-disk entry in _save
_dirty: set = set()

_STATS = {"hits": 0, "misses": 0, "sweeps": 0}

# hot-path memo: (kind, a_bits, w_bits, backend, M bucket, N, K) -> the
# tuned block, or None for a miss; valid for one REPRO_TUNING_CACHE value
_memo: dict[tuple, Block | None] = {}
_memo_env: object = object()          # never equal to an environment value


# ---------------------------------------------------------------------------
# cache file handling
# ---------------------------------------------------------------------------
def cache_path() -> str:
    """Tuning-cache location; override with ``REPRO_TUNING_CACHE``."""
    env = os.environ.get("REPRO_TUNING_CACHE")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "tuning.json")


def _sane_entry(entry) -> bool:
    """Structural validity of one cache entry (a corrupt/hand-edited file
    must degrade to a miss, never an exception on the serving hot path)."""
    if not isinstance(entry, dict):
        return False
    block = entry.get("block")
    return (isinstance(block, (list, tuple)) and len(block) == 3
            and all(isinstance(v, int) and not isinstance(v, bool) and v > 0
                    for v in block))


def _read_entries(path: str) -> dict[str, dict]:
    """Sane entries currently on disk (no in-memory cache involvement)."""
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        # unreadable or torn JSON: serve from defaults
        return {}
    raw = data.get("entries", {}) if isinstance(data, dict) else {}
    if not isinstance(raw, dict):
        return {}
    return {k: v for k, v in raw.items() if _sane_entry(v)}


def _load() -> dict[str, dict]:
    global _cache, _cache_src
    path = cache_path()
    if _cache is not None and _cache_src == path:
        return _cache
    _cache, _cache_src = _read_entries(path), path
    _memo.clear()
    return _cache


def _save() -> None:
    global _cache
    path = cache_path()
    try:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        # Merge-on-write: another process (or the other package) may have
        # persisted entries since we loaded.  Union the file with our
        # in-memory entries; on a key conflict ours wins only if we MEASURED
        # it in this process (``_dirty``).
        merged = _read_entries(path)
        for key, entry in _load().items():
            if key in _dirty or key not in merged:
                merged[key] = entry
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"version": 1, "entries": merged}, f, indent=1,
                      sort_keys=True)
        os.replace(tmp, path)
        _cache = merged
    except OSError as e:
        # unwritable cache: tuned choices still serve from memory this
        # process; they just won't persist for the next one
        warnings.warn(f"tuning cache not persisted to {path}: {e}",
                      RuntimeWarning, stacklevel=2)


def reset(clear_stats: bool = True) -> None:
    """Drop the in-memory cache and the memo (forces a re-read of the JSON
    file)."""
    global _cache, _cache_src
    _cache, _cache_src = None, None
    _dirty.clear()
    _memo.clear()
    if clear_stats:
        for k in _STATS:
            _STATS[k] = 0


def stats() -> dict[str, int]:
    return dict(_STATS)


# ---------------------------------------------------------------------------
# shape classes and candidate blocks
# ---------------------------------------------------------------------------
def _pow2_bucket(m: int, cap: int = 1024) -> int:
    b = 8
    while b < m and b < cap:
        b *= 2
    return b


def shape_class(m: int, n: int, k: int) -> tuple[int, int, int]:
    """(N, K) are structural (layer dims); M varies per batch — bucket it to
    the next power of two so nearby batch sizes share a tuning entry."""
    return (_pow2_bucket(m), n, k)


def cache_key(kind: str, a_bits: int, w_bits: int, backend: str,
              m: int, n: int, k: int) -> str:
    mb, nn, kk = shape_class(m, n, k)
    return f"{backend}|{kind}|a{a_bits}w{w_bits}|m{mb}n{nn}k{kk}"


def rows_tile(k: int) -> Block:
    """The decode-rows kernels' tile: RT rows of one column, all of K."""
    return (ROWS_RT, 1, k)


def tc_tile(kind: str) -> Block:
    """The tensor-core kernel's tile of a packed kind."""
    return XNOR_TC_TILE if kind == "binary" else QMM_MMA_TILE


def matmul_variant(kind: str, k: int, block: Block) -> int:
    """The C variant entry's number for a packed matmul block (ValueError
    for a block that names no compiled kernel)."""
    block = tuple(block)
    if block == rows_tile(k):
        return VARIANT_ROWS
    if block == tc_tile(kind):
        return VARIANT_TC
    raise ValueError(f"block {block} names no compiled {kind} kernel at "
                     f"K={k}: {rows_tile(k)} (rows) or {tc_tile(kind)} "
                     "(tensor cores)")


def _valid_block(m: int, n: int, k: int, kind: str, w_bits: int,
                 block) -> bool:
    """Whether ``block`` names something this shape class can launch: a
    compiled kernel's tile (packed kinds), a launch plan (B5) or a pool
    block size that divides the context (B2, B4)."""
    if len(block) != 3:
        return False
    bm, bn, bk = block
    if kind in KERNEL_BITS:
        return (w_bits in KERNEL_BITS[kind]
                and tuple(block) in (rows_tile(k), tc_tile(kind)))
    if kind == ATTN_DECODE:
        return bm in PA_CLUSTERS and bn == n and 1 <= bk <= PA_SPAN_MAX
    if kind in (ATTN_PAGED, ATTN_FUSED):
        return bm == 1 and bn == n and 0 < bk <= k and k % bk == 0
    return False


def fallback_block(m: int, n: int, k: int, kind: str, w_bits: int) -> Block:
    """What runs without a tuned entry: the C file's automatic kernel for
    this M and N (packed kinds), one block with spans of 16 (B5's automatic
    plan up to 128 positions), or the default pool block size."""
    if kind in KERNEL_BITS:
        if m <= M_SMALL and m * n <= ROWS_MAX_MN:
            return rows_tile(k)
        return tc_tile(kind)
    if kind == ATTN_DECODE:
        return (1, n, PA_SPAN)
    if kind in (ATTN_PAGED, ATTN_FUSED):
        return (1, n, DEFAULT_KV_BLOCK if k % DEFAULT_KV_BLOCK == 0 else k)
    raise ValueError(f"unknown tuning kind {kind!r}")


def candidate_blocks(m: int, n: int, k: int, kind: str, w_bits: int,
                     ) -> list[Block]:
    """The sweep grid, the default first: both compiled kernels of a packed
    kind; for the attention kinds only the default (their sweeps pass their
    own candidates)."""
    fb = fallback_block(m, n, k, kind, w_bits)
    if kind not in KERNEL_BITS:
        return [fb]
    return [fb] + [b for b in (rows_tile(k), tc_tile(kind)) if b != fb]


# ---------------------------------------------------------------------------
# lookup (hot path) and sweep (explicit/offline)
# ---------------------------------------------------------------------------
def resolve(m: int, n: int, k: int, *, kind: str, a_bits: int, w_bits: int,
            backend: str = "cuda") -> Block | None:
    """The tuned block of a shape class, or None on a miss.  Memoised per
    (kind, bits, backend, M bucket, N, K); the first resolution of each
    counts one hit or one miss.  An entry that names nothing this shape
    class can launch is evicted and is a miss."""
    global _memo_env
    env = os.environ.get("REPRO_TUNING_CACHE")
    if env != _memo_env:
        _memo.clear()
        _memo_env = env
    mkey = (kind, a_bits, w_bits, backend, _pow2_bucket(m), n, k)
    try:
        return _memo[mkey]
    except KeyError:
        pass
    cache = _load()
    key = cache_key(kind, a_bits, w_bits, backend, m, n, k)
    entry = cache.get(key)
    block = None
    if entry is not None:
        b = tuple(entry["block"])
        if _valid_block(m, n, k, kind, w_bits, b):
            block = b
        else:
            # stale/foreign entry: evict so an explicit autotune re-sweeps
            cache.pop(key, None)
    _STATS["hits" if block is not None else "misses"] += 1
    _memo[mkey] = block
    return block


def get_block_sizes(m: int, n: int, k: int, *, kind: str, a_bits: int,
                    w_bits: int, backend: str = "cuda") -> Block:
    """Cache lookup only — never sweeps.  A miss returns
    :func:`fallback_block`, the automatic choice."""
    block = resolve(m, n, k, kind=kind, a_bits=a_bits, w_bits=w_bits,
                    backend=backend)
    return block if block is not None else \
        fallback_block(m, n, k, kind, w_bits)


def lookup(m: int, n: int, k: int, *, kind: str, a_bits: int, w_bits: int,
           backend: str = "cuda") -> dict | None:
    """Raw cache entry for a shape class, or None on a miss (no fallback,
    no stats) — for callers that tell a tuned recommendation from the
    default (the paged pool's block-size pick)."""
    entry = _load().get(cache_key(kind, a_bits, w_bits, backend, m, n, k))
    return entry if entry is not None and _sane_entry(entry) else None


def autotune(m: int, n: int, k: int, *, kind: str, a_bits: int, w_bits: int,
             backend: str, measure: Callable[[Block], float],
             candidates: Sequence[Block] | None = None,
             default: Block | None = None,
             force: bool = False, persist: bool = True) -> dict:
    """Sweep ``candidates`` (default: :func:`candidate_blocks`) with the
    caller's ``measure(block) -> seconds`` and persist the winner.

    ``default`` is the block the cold path runs (default:
    :func:`fallback_block`); it is always measured, as ``default_us``.
    Returns the cache entry ``{"block", "us", "default_us", "swept"}``.  A
    pre-existing entry short-circuits (zero re-sweeps) unless ``force``."""
    key = cache_key(kind, a_bits, w_bits, backend, m, n, k)
    cache = _load()
    if key in cache and not force:
        _STATS["hits"] += 1
        return cache[key]

    cands = [tuple(c) for c in candidates] if candidates is not None else \
        candidate_blocks(m, n, k, kind, w_bits)
    if default is None:
        default = fallback_block(m, n, k, kind, w_bits)
    default = tuple(default)
    if default not in cands:
        cands.insert(0, default)

    swept = [{"block": list(block), "us": measure(block) * 1e6}
             for block in cands]
    _STATS["sweeps"] += 1
    best = min(swept, key=lambda e: e["us"])
    default_us = next(e["us"] for e in swept
                      if tuple(e["block"]) == default)
    entry = {"block": best["block"], "us": best["us"],
             "default_us": default_us, "swept": swept}
    cache[key] = entry
    _dirty.add(key)
    _memo.clear()
    if persist:
        _save()
    return entry


def prime(m: int, n: int, k: int, *, kind: str, a_bits: int, w_bits: int,
          backend: str = "cuda", block: Block | None = None,
          persist: bool = True) -> dict:
    """Insert a cache entry for one shape class WITHOUT measuring — the
    default block (or an explicit ``block``) at zero cost.  A pre-existing
    entry is left alone."""
    key = cache_key(kind, a_bits, w_bits, backend, m, n, k)
    cache = _load()
    if key in cache:
        return cache[key]
    b = tuple(block) if block is not None \
        else fallback_block(m, n, k, kind, w_bits)
    entry = {"block": list(b), "us": 0.0, "default_us": 0.0, "swept": []}
    cache[key] = entry
    _dirty.add(key)
    _memo.clear()
    if persist:
        _save()
    return entry


def time_fn(fn: Callable[[], object], iters: int = 3, reps: int = 10
            ) -> float:
    """Seconds of one ``fn()`` call.

    ``fn`` returning a CUDA tensor: after a warm-up and a
    ``torch.cuda.synchronize()``, ``reps`` calls are captured in a CUDA
    graph, and the median over ``iters`` replays, timed with CUDA events,
    is divided by ``reps``: device time, the host's launch cost left out
    (the kernels here run for microseconds).  Otherwise: the median
    wall-clock time of ``iters`` calls after one warm-up call."""
    import torch
    out = fn()
    if not (isinstance(out, torch.Tensor) and out.is_cuda):
        ts = []
        for _ in range(max(iters, 1)):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                 # warm up off the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ts = []
    for _ in range(max(iters, 1)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end) / 1e3 / reps)
    return statistics.median(ts)
