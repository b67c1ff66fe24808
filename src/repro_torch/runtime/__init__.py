"""Runtime package: the serving facade plus the host-side fault-tolerance
helpers (``repro.runtime``'s, as far as they are ported).

``repro_torch.runtime`` is the stable import surface for serving:

  * :class:`ServingConfig` / :class:`RequestOptions` / :class:`Request` —
    the typed front door (``runtime.serving``);
  * :class:`ContinuousBatcher` (dense) / :class:`PagedBatcher` (paged,
    quantized KV; self-speculative decoding) / :class:`AdaptiveServer`
    (SLO-routed multi-precision lanes under a brownout controller,
    ``runtime.adaptive``; its policy layer in ``runtime.policy``);
  * :class:`Metrics` and the :mod:`repro_torch.runtime.errors`
    admission-error hierarchy;
  * :class:`Tracer` / :class:`TraceConfig` / :class:`MetricsSnapshotter`
    (the serving flight recorder: structured event tracing, Perfetto
    export, crash dumps, metrics snapshots — ``runtime.tracing``) and
    :class:`StepProfiler` (per-step device time against host gap —
    ``runtime.profile``).

**Fault-tolerance runtime** (host-side; they wrap step functions):
  * ``PreemptionGuard``  — SIGTERM/SIGINT handler that flips a flag; the
    train loop checkpoints and exits cleanly at the next step boundary;
  * ``StragglerMonitor`` — per-step wall-time EWMA + deviation; flags steps
    exceeding mean + k*sigma, and recommends replacement after repeated
    offenses;
  * ``ElasticTrainer``   — the restart driver: resolve the latest
    checkpoint, restore the state (re-sharded onto whatever mesh ``build``
    returns, which may differ from the saving one) and the data position,
    continue; step granularity recovery;
  * ``retry_with_backoff`` — transient-error wrapper for host I/O.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from collections.abc import Callable

from .adaptive import AdaptiveServer, ByteLedger  # noqa: F401
from .errors import (AdmissionError, EmptyPromptError,  # noqa: F401
                     InvalidBudgetError, PoolFootprintError,
                     PromptTooLongError, UnknownSLOClassError)
from .kvcache import PagedBatcher  # noqa: F401
from .metrics import Metrics  # noqa: F401
from .policy import (BrownoutController, BrownoutPolicy,  # noqa: F401
                     SLOClass, default_slo_classes, search_policy)
from .profile import StepProfiler  # noqa: F401
from .serving import (ContinuousBatcher, Request,  # noqa: F401
                      RequestOptions, ServingConfig)
from .tracing import (MetricsSnapshotter, TraceConfig,  # noqa: F401
                      Tracer, span_coverage)


class PreemptionGuard:
    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.requested = False
        self._old = {}
        self._signals = signals

    def __enter__(self):
        for s in self._signals:
            self._old[s] = signal.signal(s, self._handler)
        return self

    def _handler(self, signum, frame):
        self.requested = True

    def __exit__(self, *exc):
        for s, h in self._old.items():
            signal.signal(s, h)
        return False


@dataclasses.dataclass
class StragglerEvent:
    step: int
    wall_s: float
    mean_s: float
    deviation: float


class StragglerMonitor:
    """EWMA step-time tracker; flags outliers > mean + k*std."""

    def __init__(self, alpha: float = 0.1, k: float = 3.0, warmup: int = 5,
                 replace_after: int = 3):
        self.alpha = alpha
        self.k = k
        self.warmup = warmup
        self.replace_after = replace_after
        self.mean = 0.0
        self.var = 0.0
        self.n = 0
        self.events: list[StragglerEvent] = []
        self.consecutive = 0

    def record(self, step: int, wall_s: float) -> StragglerEvent | None:
        self.n += 1
        if self.n <= self.warmup:
            self.mean = wall_s if self.n == 1 else \
                (self.mean * (self.n - 1) + wall_s) / self.n
            self.var = max(self.var, (wall_s - self.mean) ** 2)
            return None
        std = self.var ** 0.5
        event = None
        if wall_s > self.mean + self.k * max(std, 1e-2 * self.mean):
            event = StragglerEvent(step, wall_s, self.mean,
                                   (wall_s - self.mean) / max(std, 1e-9))
            self.events.append(event)
            self.consecutive += 1
        else:
            self.consecutive = 0
        self.mean = (1 - self.alpha) * self.mean + self.alpha * wall_s
        self.var = (1 - self.alpha) * self.var + \
            self.alpha * (wall_s - self.mean) ** 2
        return event

    @property
    def should_replace(self) -> bool:
        """Recommend pulling the slow host after repeated offenses."""
        return self.consecutive >= self.replace_after


def retry_with_backoff(fn: Callable, retries: int = 3, base_s: float = 0.1,
                       exceptions=(OSError,)):
    for attempt in range(retries + 1):
        try:
            return fn()
        except exceptions:
            if attempt == retries:
                raise
            time.sleep(base_s * 2 ** attempt)


class ElasticTrainer:
    """Restart driver: checkpoint-resume onto whatever mesh is available.

    ``build`` = (n_data, n_model) -> (mesh, state_like, shardings, step_fn),
    ``step_fn(state, batch) -> (state, metrics)``: ``mesh`` the rank's mesh
    and ``shardings`` the state's ``parallel.sharding.TreeSharding``
    (``state_like`` holds this rank's slices), or both None on one device.
    On each (re)start: restore the latest checkpoint (elastic re-shard)
    and the data iterator's position (``load_state_dict({"step": N})``),
    run until preempted or done, checkpoint on exit.  Over a mesh every
    rank runs the loop; a preemption signal on any rank stops them all at
    the same step boundary (the flag is max-reduced over the mesh each
    step), and the checkpoints are the ranks' joint saves.
    """

    def __init__(self, ckpt, build: Callable, save_every: int = 50):
        self.ckpt = ckpt
        self.build = build
        self.save_every = save_every

    def run(self, n_steps: int, n_data: int, n_model: int, data_iter,
            monitor: StragglerMonitor | None = None):
        mesh, state, shardings, step_fn = self.build(n_data, n_model)
        start = 0
        latest = self.ckpt.latest_step()
        if latest is not None:
            state = self.ckpt.restore(latest, state, shardings)
            if hasattr(data_iter, "load_state_dict"):
                data_iter.load_state_dict({"step": latest})
            start = latest
        metrics_log = []
        with PreemptionGuard() as guard:
            for step in range(start, n_steps):
                t0 = time.time()
                state, metrics = step_fn(state, next(data_iter))
                wall = time.time() - t0
                if monitor is not None:
                    monitor.record(step, wall)
                metrics_log.append(metrics)
                stop = _agreed(guard.requested, mesh)
                if stop or (step + 1) % self.save_every == 0:
                    self.ckpt.save(step + 1, state, shardings=shardings)
                if stop:
                    return state, metrics_log, "preempted"
        self.ckpt.save(n_steps, state, shardings=shardings)
        return state, metrics_log, "done"


def _agreed(flag: bool, mesh) -> bool:
    """``flag`` on any rank of ``mesh`` (itself with no mesh)."""
    if mesh is None or mesh.size == 1:
        return flag
    import torch
    every = mesh.axis(mesh.axis_names)
    return bool(every.all_reduce_max(
        torch.tensor([float(flag)], device=mesh.device)) > 0)
