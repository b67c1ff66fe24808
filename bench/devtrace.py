"""The traced slice of a run, as plain records, and the arithmetic over it.

``torch.profiler`` (CPU and CUDA activities) records a short slice of
batches.  :func:`from_profile` keeps of it the device operations (kernels,
copies, fills; not the profiler's own annotations on the device timeline)
and the host events (the harness's spans, PyTorch operators, CUDA runtime
calls), each with its start and end in microseconds on the profiler's one
clock.  The per-layer readers (``metrics/<name>.py``) read a :class:`Run`
built on it, so a test can hand them a synthetic one.

The harness marks every batch with its own spans (``record_function``),
none inside the program: ``bench.batch`` around ``bench.pick`` (the input
batch taken from the pool), ``bench.forward`` (the program's call) and
``bench.sync`` (the logits to the host, which waits for the card).
"""
from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import NamedTuple

BATCH, PICK, FORWARD, SYNC = ("bench.batch", "bench.pick", "bench.forward",
                              "bench.sync")


class DeviceOp(NamedTuple):
    name: str
    kind: str                 # kernel | memcpy | memset
    start: float              # us
    end: float


class HostEvent(NamedTuple):
    name: str                 # a bench.* span, an operator, a cuda* call
    start: float
    end: float


@dataclasses.dataclass
class Trace:
    ops: list[DeviceOp]
    host: list[HostEvent]


@dataclasses.dataclass
class Run:
    """What a per-layer reader gets: the traced slice, the cell's products
    at its batch (``costs.Layer``, in forward order), the images a second
    of the run's measured window, and the names of the program's own
    kernels (``__global__`` functions of its CUDA sources)."""
    trace: Trace
    layers: list
    batch: int
    images_per_s: float
    port_kernels: frozenset


def from_profile(prof) -> Trace:
    """The records of a finished ``torch.profiler.profile``: its device
    events (kernels; ``Memcpy ...`` copies and ``Memset ...`` fills; the
    harness's spans as the profiler repeats them on the device timeline
    left out) and its host events."""
    from torch.autograd import DeviceType
    ops, host = [], []
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if e.name.startswith("bench."):
                continue
            kind = "memcpy" if e.name.startswith("Memcpy") else \
                "memset" if e.name.startswith("Memset") else "kernel"
            ops.append(DeviceOp(e.name, kind, start, end))
        elif e.device_type == DeviceType.CPU:
            host.append(HostEvent(e.name, start, end))
    ops.sort(key=lambda o: o.start)
    host.sort(key=lambda h: h.start)
    return Trace(ops, host)


_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                     r"(\w+)\s*\(")


def port_kernels(csrc: Path) -> frozenset:
    """Names of the ``__global__`` functions in the CUDA sources ``csrc``."""
    names = set()
    for path in sorted(csrc.glob("*.cu*")):
        names.update(_GLOBAL.findall(path.read_text(encoding="utf-8")))
    return frozenset(names)


def kernel_base(name: str) -> str:
    """A kernel's bare function name: ``void (anonymous namespace)::
    qmm_int8_mma_kernel<2, 16>(signed char const*, ...)`` gives
    ``qmm_int8_mma_kernel``."""
    s = name.replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[5:]
    s = re.split(r"[<(]", s, maxsplit=1)[0]
    return s.rsplit("::", 1)[-1].strip()


def window(trace: Trace) -> tuple[float, float, int]:
    """(start, end, batches) of the traced batches' spans."""
    spans = [h for h in trace.host if h.name == BATCH]
    if not spans:
        return 0.0, 0.0, 0
    return spans[0].start, max(h.end for h in spans), len(spans)


def harness_ops(trace: Trace) -> list[DeviceOp]:
    """The harness's own device operations: the logits' copies to the host,
    which run inside its ``bench.sync`` spans."""
    syncs = [h for h in trace.host if h.name == SYNC]
    return [o for o in trace.ops
            if o.kind == "memcpy" and "DtoH" in o.name
            and any(s.start <= o.start and o.end <= s.end for s in syncs)]


def program_ops(trace: Trace) -> list[DeviceOp]:
    """The device operations of the traced batches but the harness's."""
    lo, hi, _ = window(trace)
    own = set(harness_ops(trace))
    return [o for o in trace.ops if lo <= o.start and o.end <= hi
            and o not in own]


def busy_intervals(ops, lo: float, hi: float) -> list[tuple[float, float]]:
    """The union of the operations' intervals, clipped to [lo, hi]."""
    merged: list[list[float]] = []
    for o in sorted(ops, key=lambda o: o.start):
        a, b = max(o.start, lo), min(o.end, hi)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def busy_us(trace: Trace) -> float:
    lo, hi, _ = window(trace)
    return sum(b - a for a, b in busy_intervals(trace.ops, lo, hi))


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time (seconds, summed by
    kernel), and the longest idle gaps of the card, each named by what the
    host was doing when it began: the harness's span and the innermost
    operator or runtime call open then."""
    lo, hi, _ = window(trace)
    by_name: dict[str, float] = {}
    for o in trace.ops:
        if lo <= o.start and o.end <= hi:
            by_name[o.name] = by_name.get(o.name, 0.0) + (o.end - o.start)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = busy_intervals(trace.ops, lo, hi)
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n, t / 1e6] for n, t in ops],
            "idle_gaps": [[host_label(trace, a), (b - a) / 1e6]
                          for a, b in gaps]}


def host_label(trace: Trace, t: float) -> str:
    """``<harness span>/<innermost operator or runtime call>`` open at t."""
    open_ = [h for h in trace.host if h.start <= t < h.end]
    spans = [h for h in open_ if h.name.startswith("bench.")
             and h.name != BATCH]
    inner = [h for h in open_ if not h.name.startswith("bench.")]
    span = max(spans, key=lambda h: h.start).name if spans else "between"
    if inner:
        return f"{span}/{max(inner, key=lambda h: h.start).name}"
    return span
