"""Per-step device/host profiling at the device-sync boundary
(``repro.runtime.profile``).

:class:`StepProfiler` brackets every profiled dispatch host-side and syncs
the device inside the bracket, splitting each scheduler step into

  ``device_ms`` — dispatch call -> device sync returning.  The device work
      is the long pole inside this bracket, but in eager PyTorch the bracket
      also holds the host's issue of every launch of the step (about 450
      engine dispatches and ~3300 device operations per 2xT decode step),
      so it is an upper bound on the step's device time, not its busy time;
  ``host_ms``   — the gap between the PREVIOUS profiled sync returning and
      this dispatch starting: scheduler bookkeeping, sampling of the first
      token, token emission, admission math.  The device sits idle for this
      whole gap.

``host_frac`` is therefore the share of profiled wall time spent outside
the brackets, and it is not the device's idle share that
``torch.profiler`` reports: the launch issue inside each bracket, during
which the device idles between kernels, counts as device time here.

The sync is :func:`sync`: ``torch.cuda.synchronize`` on the batcher's
device for CUDA, nothing on the CPU (its results are ready when the call
returns).  Profiling forces a sync per profiled dispatch, so it serializes
the host and the device: use it to *measure* the step's structure.  When a
:class:`repro_torch.runtime.tracing.Tracer` is attached, each bracket also
lands on the trace's "device" track as a complete ("X") span, with the host
gap as its own span beside it.
"""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import torch

from .tracing import TRACK_DEVICE, Tracer


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op for the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _pcts(xs: list[float]) -> dict:
    if not xs:
        return {"mean": 0.0, "p50": 0.0, "p90": 0.0, "n": 0}
    s = sorted(xs)
    n = len(s)
    return {
        "mean": sum(s) / n,
        "p50": s[min(n - 1, max(0, -(-50 * n // 100) - 1))],
        "p90": s[min(n - 1, max(0, -(-90 * n // 100) - 1))],
        "n": n,
    }


class StepProfiler:
    """Device-time vs host-gap accounting per labeled dispatch phase.

    Usage (the batchers wire this around their step calls)::

        with profiler.step("decode"):
            out = decode_fn(...)
            sync(device)

    The sync belongs INSIDE the bracket: the bracket measures "how long
    until this step's results are host-visible", and the gap to the next
    bracket measures pure host time."""

    def __init__(self, tracer: Tracer | None = None):
        self.tracer = tracer
        self.records: dict[str, list[tuple[float, float]]] = \
            defaultdict(list)
        self._last_sync: float | None = None

    @contextmanager
    def step(self, label: str):
        t0 = time.perf_counter()
        host_ms = ((t0 - self._last_sync) * 1e3
                   if self._last_sync is not None else 0.0)
        try:
            yield
        finally:
            t1 = time.perf_counter()
            self._last_sync = t1
            device_ms = (t1 - t0) * 1e3
            self.records[label].append((device_ms, host_ms))
            tr = self.tracer
            if tr is not None and tr.enabled:
                base = tr._t0
                ts0 = (t0 - base) * 1e6
                if host_ms > 0.0:
                    tr.complete("host_gap", "profile",
                                ts0 - host_ms * 1e3, host_ms * 1e3,
                                track=TRACK_DEVICE, before=label)
                tr.complete(f"device:{label}", "profile", ts0,
                            device_ms * 1e3, track=TRACK_DEVICE)

    def summary(self) -> dict:
        """Per-label device/host breakdown.  ``host_frac`` is the share of
        profiled wall time spent between brackets (see the module
        docstring for what it is not)."""
        out = {}
        for label, recs in self.records.items():
            dev = [d for d, _ in recs]
            host = [h for _, h in recs[1:]] if len(recs) > 1 \
                else [h for _, h in recs]
            d_sum, h_sum = sum(dev), sum(host)
            out[label] = {
                "steps": len(recs),
                "device_ms": _pcts(dev),
                "host_ms": _pcts(host),
                "host_frac": h_sum / max(d_sum + h_sum, 1e-9),
            }
        return out
