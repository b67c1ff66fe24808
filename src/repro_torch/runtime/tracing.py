"""Serving flight recorder — structured event tracing for the scheduler
(``repro.runtime.tracing``).

:mod:`repro_torch.runtime.metrics` reports aggregates (percentiles,
counters); this module records the event stream behind them, so that "where
did step 412 spend its time" has an answer:

  * **spans** (begin/end pairs): scheduler step, prefill chunk (or whole
    prefill), decode dispatch;
  * **instants**: admission, first token, finish, preemption, stall,
    pool-eviction waves, and engine kernel dispatches (via
    :func:`repro_torch.kernels.engine.set_dispatch_listener`);
  * **counters**: KV-pool occupancy, and the tuning cache's hits, misses
    and sweeps (``tuning_cache`` on the engine track, emitted when
    :func:`repro_torch.kernels.tuning.stats` moved);
  * **flow events** linking one request's admission -> chunks -> first token
    -> finish (-> re-admission after preemption) across slots.

Events land in a bounded ring buffer (``collections.deque(maxlen=...)``,
drop-oldest; the drop count is exposed and exported).  The hot-path cost is
one dict construction + deque append per event when enabled and a single
attribute check when disabled.  Tracer calls wrap the model's step calls
from the host scheduler; none runs inside a step.

**Engine dispatches.**  The JAX engine dispatches once per jit trace, so
each of its dispatch instants marks a new shape class.  Eager PyTorch
dispatches on every call: about 450 engine dispatches per 2xT decode step
(210 matmuls, 210 activation quantizers, 30 attentions).  Forwarding each
would fill a 65536-event ring within a few hundred steps and push out the
scheduler events the recorder exists for, so the tracer's listener records
an instant only the first time it sees a distinct
:class:`~repro_torch.kernels.engine.DispatchEvent` (a new kernel, storage
kind, backend or row count): the same "new shape class" mark the reference
puts on its timeline.  The engine's own sink
(:func:`~repro_torch.kernels.engine.dispatch_trace`) still records every
call.

Exporters:
  * :meth:`Tracer.to_perfetto` — chrome://tracing / Perfetto JSON.  Ring
    overflow can orphan an ``E`` (its ``B`` was dropped) or strand a ``B``
    (export mid-span); the exporter prunes the former and synthesizes a
    closing ``E`` for the latter so every exported ``B`` has an ``E``.
  * :meth:`Tracer.dump_jsonl` / :meth:`Tracer.on_crash` — flight-recorder
    dump, one event per line; ``run()`` calls ``on_crash`` on any exception
    so the last N events land next to the stack trace.
  * :class:`MetricsSnapshotter` — periodic ``Metrics.summary()`` snapshots
    (plus numeric-leaf deltas vs the previous snapshot) to JSONL, for
    load-over-time plots; ``launch/serve.py --metrics-interval`` rides it.

Timestamps are ``time.perf_counter`` microseconds relative to the tracer's
construction (the chrome-trace unit); snapshot lines also carry wall time.
"""
from __future__ import annotations

import dataclasses
import json
import time
from collections import deque
from typing import Any

# well-known track (chrome "thread") names; batchers may add their own
TRACK_SCHEDULER = "scheduler"
TRACK_DEVICE = "device"
TRACK_ENGINE = "engine"

_PID = 1                       # single-process scheduler: one trace "process"


@dataclasses.dataclass
class TraceConfig:
    """The ``ServingConfig.trace`` payload: what to record and where it goes.

    ``enabled=False`` with a ``snapshot_interval`` still ticks the metrics
    snapshotter (``--metrics-interval`` without ``--trace``); ``profile``
    turns on the per-step device-sync boundary timing
    (:class:`repro_torch.runtime.profile.StepProfiler`) independently of
    event recording."""
    enabled: bool = True
    buffer: int = 65536                 # ring capacity (events)
    path: str | None = None             # Perfetto JSON export target
    crash_dump: str | None = None       # JSONL on exception (default:
                                        # "<path>.crash.jsonl", or
                                        # "flight_recorder_crash.jsonl")
    snapshot_path: str | None = None    # metrics-snapshot JSONL
    snapshot_interval: int = 0          # scheduler steps between snapshots
    profile: bool = False               # device-time vs host-gap per step


class Tracer:
    """Bounded-ring structured event recorder (chrome-trace event dicts).

    Every recording method is a no-op behind one ``self.enabled`` check —
    call sites guard with ``if tr.enabled:`` where they would otherwise
    build kwargs, so the disabled path allocates nothing."""

    def __init__(self, capacity: int = 65536, *, enabled: bool = True):
        self.enabled = bool(enabled)
        self.capacity = max(int(capacity), 16)
        self.events: deque[dict] = deque(maxlen=self.capacity)
        self.dropped = 0
        self.config: TraceConfig | None = None
        self.snapshotter: MetricsSnapshotter | None = None
        self._t0 = time.perf_counter()
        self._wall_t0 = time.time()
        self._tracks: dict[str, int] = {}
        self._dispatches_seen: set = set()
        self._last_tuning: dict | None = None
        self._engine_attached = False
        self._crash_dumped = False

    # ------------------------------------------------------------ factory
    @classmethod
    def from_config(cls, trace) -> "Tracer":
        """Build the tracer a batcher runs on from ``ServingConfig.trace``:
        ``None`` → the shared disabled singleton; an existing ``Tracer`` is
        passed through (several batchers may share one)."""
        if trace is None:
            return NULL_TRACER
        if isinstance(trace, Tracer):
            return trace
        t = cls(capacity=trace.buffer, enabled=trace.enabled)
        t.config = trace
        if trace.snapshot_interval and trace.snapshot_path:
            t.snapshotter = MetricsSnapshotter(
                trace.snapshot_path, trace.snapshot_interval)
        if t.enabled:
            t.attach_engine()
        return t

    # ---------------------------------------------------------- recording
    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _append(self, ev: dict) -> None:
        if len(self.events) == self.capacity:
            self.dropped += 1
        self.events.append(ev)

    def track(self, name: str) -> int:
        """Stable tid for a named track (chrome "thread"); registers the
        thread_name metadata lazily at export."""
        tid = self._tracks.get(name)
        if tid is None:
            tid = len(self._tracks) + 1
            self._tracks[name] = tid
        return tid

    def begin(self, name: str, cat: str, track: str = TRACK_SCHEDULER,
              **args) -> None:
        if not self.enabled:
            return
        self._append({"ph": "B", "name": name, "cat": cat,
                      "ts": self._now_us(), "pid": _PID,
                      "tid": self.track(track), "args": args})

    def end(self, name: str, cat: str, track: str = TRACK_SCHEDULER,
            **args) -> None:
        if not self.enabled:
            return
        self._append({"ph": "E", "name": name, "cat": cat,
                      "ts": self._now_us(), "pid": _PID,
                      "tid": self.track(track), "args": args})

    def instant(self, name: str, cat: str, track: str = TRACK_SCHEDULER,
                **args) -> None:
        if not self.enabled:
            return
        self._append({"ph": "i", "s": "t", "name": name, "cat": cat,
                      "ts": self._now_us(), "pid": _PID,
                      "tid": self.track(track), "args": args})

    def counter(self, name: str, cat: str, track: str = TRACK_SCHEDULER,
                **values) -> None:
        if not self.enabled:
            return
        self._append({"ph": "C", "name": name, "cat": cat,
                      "ts": self._now_us(), "pid": _PID,
                      "tid": self.track(track), "args": values})

    def complete(self, name: str, cat: str, ts_us: float, dur_us: float,
                 track: str = TRACK_SCHEDULER, **args) -> None:
        """Retro-emitted complete ("X") span with explicit start/duration —
        the profiler's shape: timing is measured first, recorded after."""
        if not self.enabled:
            return
        self._append({"ph": "X", "name": name, "cat": cat, "ts": ts_us,
                      "dur": dur_us, "pid": _PID, "tid": self.track(track),
                      "args": args})

    def flow(self, phase: str, fid: int, track: str = TRACK_SCHEDULER,
             name: str = "req") -> None:
        """Per-request flow edge: ``phase`` is "s" (start, at admission),
        "t" (through: chunks/tokens/re-admission), or "f" (finish).  The
        flow id is the request id, so Perfetto draws one arrow chain per
        request across slots."""
        if not self.enabled:
            return
        ev = {"ph": phase, "name": name, "cat": "flow", "id": int(fid),
              "ts": self._now_us(), "pid": _PID, "tid": self.track(track)}
        if phase == "f":
            ev["bp"] = "e"                 # bind to the enclosing slice end
        self._append(ev)

    # --------------------------------------------------- engine timeline
    def attach_engine(self) -> None:
        """Put kernel dispatches on this trace's timeline: install a
        persistent listener on the engine's dispatch hook that records an
        instant the first time each distinct ``DispatchEvent`` is seen
        (eager PyTorch dispatches on every call; see the module docstring).
        An instant mid-serving therefore means a new shape class or kernel
        appeared mid-serving."""
        if not self.enabled or self._engine_attached:
            return
        from repro_torch.kernels import engine

        def _on_dispatch(ev) -> None:
            if ev in self._dispatches_seen:
                return
            self._dispatches_seen.add(ev)
            args = {k: (list(v) if isinstance(v, tuple) else v)
                    for k, v in ev._asdict().items() if k != "op"}
            self.instant(f"dispatch:{ev.op}", "engine",
                         track=TRACK_ENGINE, **args)

        engine.set_dispatch_listener(_on_dispatch)
        self._engine_attached = True

    def detach_engine(self) -> None:
        if self._engine_attached:
            from repro_torch.kernels import engine
            engine.set_dispatch_listener(None)
            self._engine_attached = False

    def maybe_tuning_counter(self) -> None:
        """Emit a tuning-cache counter sample when the stats moved since the
        last emission (hits/misses/sweeps live in one process-wide dict, so
        sampling every step would repeat values)."""
        if not self.enabled:
            return
        from repro_torch.kernels import tuning
        s = tuning.stats()
        if s != self._last_tuning:
            self._last_tuning = dict(s)
            self.counter("tuning_cache", "engine", track=TRACK_ENGINE, **s)

    # ----------------------------------------------------- snapshot tick
    def tick_snapshot(self, metrics) -> None:
        if self.snapshotter is not None:
            self.snapshotter.tick(metrics)

    # ----------------------------------------------------------- export
    def _sanitized(self) -> list[dict]:
        """Ring contents made chrome-trace-consistent: orphaned ``E`` events
        (their ``B`` fell off the ring) are pruned, unclosed ``B`` events get
        a synthetic closing ``E`` at the last timestamp, and flow ``t``/``f``
        edges whose ``s`` was dropped are pruned too."""
        body: list[dict] = []
        stacks: dict[int, list[dict]] = {}
        flow_starts: set[int] = set()
        last_ts = 0.0
        for ev in self.events:
            last_ts = max(last_ts, ev["ts"] + ev.get("dur", 0.0))
            ph = ev["ph"]
            if ph == "B":
                stacks.setdefault(ev["tid"], []).append(ev)
            elif ph == "E":
                st = stacks.get(ev["tid"])
                if not st:
                    continue               # orphan: its B was dropped
                st.pop()
            elif ph == "s":
                flow_starts.add(ev["id"])
            elif ph in ("t", "f") and ev["id"] not in flow_starts:
                continue                   # orphan flow edge
            body.append(ev)
        for st in stacks.values():
            for b in reversed(st):
                body.append({"ph": "E", "name": b["name"], "cat": b["cat"],
                             "ts": last_ts, "pid": _PID, "tid": b["tid"],
                             "args": {"synthetic_close": True}})
        return body

    def to_perfetto(self, path: str | None = None) -> dict:
        """Export the ring as a chrome://tracing / Perfetto JSON object
        (and write it to ``path`` when given)."""
        meta = [{"ph": "M", "name": "process_name", "pid": _PID,
                 "args": {"name": "repro-serving"}}]
        for name, tid in self._tracks.items():
            meta.append({"ph": "M", "name": "thread_name", "pid": _PID,
                         "tid": tid, "args": {"name": name}})
            meta.append({"ph": "M", "name": "thread_sort_index", "pid": _PID,
                         "tid": tid, "args": {"sort_index": tid}})
        obj = {
            "traceEvents": meta + self._sanitized(),
            "displayTimeUnit": "ms",
            "otherData": {
                "dropped_events": self.dropped,
                "buffer_capacity": self.capacity,
                "wall_t0": self._wall_t0,
            },
        }
        if path:
            with open(path, "w") as f:
                json.dump(obj, f)
        return obj

    def dump_jsonl(self, path: str, last: int | None = None) -> int:
        """Flight-recorder dump: the last ``last`` ring events (all when
        None), one JSON object per line.  Returns the line count."""
        evs = list(self.events)
        if last is not None:
            evs = evs[-int(last):]
        with open(path, "w") as f:
            f.write(json.dumps({"flight_recorder": True,
                                "dropped": self.dropped,
                                "wall_t0": self._wall_t0}) + "\n")
            for ev in evs:
                f.write(json.dumps(ev) + "\n")
        return len(evs)

    def crash_path(self) -> str:
        cfg = self.config
        if cfg is not None and cfg.crash_dump:
            return cfg.crash_dump
        if cfg is not None and cfg.path:
            return cfg.path + ".crash.jsonl"
        return "flight_recorder_crash.jsonl"

    def on_crash(self) -> None:
        """Exception hook for ``run()``: dump the ring next to the crash.
        Idempotent — batchers that share one tracer unwind through it more
        than once, and only the outermost unwind should write."""
        if not self.enabled or self._crash_dumped:
            return
        self._crash_dumped = True
        try:
            self.dump_jsonl(self.crash_path())
        except OSError:                    # never mask the real exception
            pass


# Shared disabled singleton: batchers constructed without a trace config all
# point here, so the hot path pays one attribute read, zero allocation.
NULL_TRACER = Tracer(capacity=16, enabled=False)


class MetricsSnapshotter:
    """Periodic ``Metrics.summary()`` snapshots to JSONL.

    Every line carries the step counter, wall time, the full summary, and
    ``delta`` — the numeric leaves of the summary minus the previous
    snapshot's (counters become per-interval rates for load-over-time
    plots).  Lines are appended and flushed per write so a crash loses at
    most the current interval."""

    def __init__(self, path: str, interval: int = 32):
        self.path = path
        self.interval = max(int(interval), 1)
        self.lines_written = 0
        self._since = 0
        self._prev: dict | None = None
        with open(path, "w"):              # truncate: one file per run
            pass

    def tick(self, metrics) -> None:
        self._since += 1
        if self._since >= self.interval:
            self._since = 0
            self.write(metrics)

    def write(self, metrics) -> None:
        s = metrics.summary()
        line = {
            "step": metrics.scheduler_steps,
            "t_wall": time.time(),
            "summary": s,
            "delta": _numeric_delta(self._prev, s),
        }
        self._prev = s
        with open(self.path, "a") as f:
            f.write(json.dumps(line) + "\n")
        self.lines_written += 1

    def final(self, metrics) -> None:
        """One last snapshot regardless of interval phase (end of run)."""
        self.write(metrics)


def _numeric_delta(prev: Any, cur: Any) -> Any:
    """Numeric leaves of ``cur`` minus the matching leaves of ``prev``
    (missing/previously-absent leaves delta against 0); non-numeric leaves
    are dropped."""
    if isinstance(cur, dict):
        out = {}
        for k, v in cur.items():
            d = _numeric_delta(prev.get(k) if isinstance(prev, dict)
                               else None, v)
            if d is not None:
                out[k] = d
        return out or None
    if isinstance(cur, bool):
        return None
    if isinstance(cur, (int, float)):
        base = prev if isinstance(prev, (int, float)) \
            and not isinstance(prev, bool) else 0
        return cur - base
    return None


def span_coverage(trace: dict, name: str = "step") -> float:
    """Fraction of the trace's wall window covered by the union of closed
    ``name`` spans (any track) — the acceptance metric "per-step spans
    account for ≥95% of the serving window"."""
    evs = [e for e in trace["traceEvents"] if e["ph"] != "M"]
    if not evs:
        return 0.0
    t_lo = min(e["ts"] for e in evs)
    t_hi = max(e["ts"] + e.get("dur", 0.0) for e in evs)
    window = t_hi - t_lo
    if window <= 0.0:
        return 1.0
    intervals: list[tuple[float, float]] = []
    open_: dict[int, list[float]] = {}
    for e in evs:
        if e.get("name") != name:
            continue
        if e["ph"] == "B":
            open_.setdefault(e["tid"], []).append(e["ts"])
        elif e["ph"] == "E":
            st = open_.get(e["tid"])
            if st:
                intervals.append((st.pop(), e["ts"]))
        elif e["ph"] == "X":
            intervals.append((e["ts"], e["ts"] + e.get("dur", 0.0)))
    covered = 0.0
    end = None
    for lo, hi in sorted(intervals):
        if end is None or lo > end:
            covered += hi - lo
            end = hi
        elif hi > end:
            covered += hi - end
            end = hi
    return covered / window
