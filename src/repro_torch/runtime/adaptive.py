"""Adaptive precision serving — precision as a runtime control knob (the
port's ``repro.runtime.adaptive``).

The rest of the repo freezes the paper's precision dial at config load; this
module turns it into a serving-time control surface.  An
:class:`AdaptiveServer` fronts a ladder of **rung lanes**, each a
:class:`repro_torch.runtime.kvcache.PagedBatcher` holding a different
(weight-variant, kv_bits) point on the accuracy/throughput curve:

  rung 0   full-precision weights, kv_bits=16 — optionally running
           self-speculative decoding (low-bit drafts, fp-verified, lossless)
  rung 1   full-precision weights, kv_bits=8
  rung 2   full-precision weights, kv_bits=4
  rung 3   low-bit weight variant (``draft_precision``), kv_bits=4 — the
           only rung whose *tokens* may differ from the fp stream

Requests enter a central queue tagged with an SLO class
(:func:`repro_torch.runtime.policy.default_slo_classes`); a
:class:`repro_torch.runtime.policy.BrownoutController` reads the per-step
controller signals (queue depth, pool utilization, latency tails — sampled
by :meth:`Metrics.on_step` every scheduler step, never per admission) and
picks the ladder rung.  Routing happens at admission time:
``rung = min(controller.level, slo.max_brownout)``, so a traffic spike
degrades *new* admissions down the ladder instead of queueing them, while
already-active slots keep their lane — and their exact token streams —
untouched (the brownout-isolation contract the golden tests pin).

**Shared pool budget.**  With ``pool_bytes`` the lanes share one device
byte budget through a :class:`ByteLedger`: every lane sizes its own pool to the
full budget (so any single lane may use all of it) and each block
allocation debits the ledger at that lane's per-block byte cost —
cheaper-KV rungs literally fit more resident requests in the same bytes,
which is the whole point of browning out.  When the budget is exhausted the
ledger reclaims freeable radix blocks across all lanes (biggest
bytes-per-block first) before refusing; a refusal then behaves exactly
like pool exhaustion inside the asking lane (queued admissions wait,
decode preempts).  With ``num_blocks`` the lanes keep independent pools
and no ledger is installed.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

from .errors import UnknownSLOClassError
from .kvcache import PagedBatcher, paged_block_bytes
from .metrics import Metrics
from .policy import (DEFAULT_KV_LADDER, BrownoutController, BrownoutPolicy,
                     SLOClass, default_slo_classes)
from .serving import Request, ServingConfig


class ByteLedger:
    """Cross-lane device-memory accounting for a shared pool byte budget.

    Block *counts* are not comparable across lanes (a kv16 block costs ~4x
    a kv4 block), so the ledger prices each lane's blocks in bytes and
    enforces ``sum(lane.used_blocks * lane.block_bytes) <= budget``.  Usage
    is computed on demand from each lane's pool metadata — the pools remain
    the single source of truth and the ledger can never drift from them.
    """

    def __init__(self, budget_bytes: int):
        self.budget_bytes = int(budget_bytes)
        self.lanes: list[PagedBatcher] = []
        self._block_bytes: dict[int, int] = {}

    def attach(self, lane: PagedBatcher) -> None:
        self._block_bytes[id(lane)] = paged_block_bytes(
            lane.model.cfg, lane.block_size, lane.kv_bits)
        lane._ledger = self
        self.lanes.append(lane)

    def block_bytes(self, lane) -> int:
        return self._block_bytes[id(lane)]

    def used_bytes(self) -> int:
        return sum(l.pool_meta.used_blocks * self._block_bytes[id(l)]
                   for l in self.lanes)

    def utilization(self) -> float:
        return self.used_bytes() / max(self.budget_bytes, 1)

    def affords(self, lane, n: int) -> bool:
        """Would ``n`` more blocks in ``lane`` stay within the budget?"""
        return (self.used_bytes() + n * self.block_bytes(lane)
                <= self.budget_bytes)

    def reclaim(self, lane, n: int) -> None:
        """Evict freeable radix blocks across ALL lanes until ``lane`` can
        afford ``n`` blocks (or nothing freeable remains).  Biggest
        bytes-per-block lanes first: one kv16 eviction frees as many bytes
        as four kv4 ones."""
        for victim in sorted(self.lanes, key=self.block_bytes, reverse=True):
            while not self.affords(lane, n):
                if victim.radix is None or not len(victim.radix):
                    break
                dropped = victim.radix.evict(1, freeable_only=True)
                victim.metrics.on_evictions(dropped)
                if dropped == 0:
                    break
            if self.affords(lane, n):
                return


class AdaptiveServer:
    """SLO-routed multi-precision serving front door.

    Usage mirrors the batchers::

        srv = AdaptiveServer(model, params, ServingConfig(
            n_slots=8, s_max=128, pool_bytes=1 << 20,
            brownout=True, speculative=True))
        srv.submit(Request(0, prompt, RequestOptions(slo="premium")))
        finished = srv.run()

    ``model``/``params`` are the FULL-PRECISION primary; the server packs
    the ``draft_precision`` variant itself (rung 3 and the rung-0
    speculative draft) and registers every variant with the kernel engine.
    """

    def __init__(self, model, params,
                 config: ServingConfig | None = None, *,
                 metrics: Metrics | None = None):
        if not isinstance(config, ServingConfig):
            raise TypeError("AdaptiveServer: pass a ServingConfig "
                            "(AdaptiveServer(model, params, "
                            "ServingConfig(...)))")
        if config.mesh is not None:
            raise ValueError("AdaptiveServer serves on one device: its "
                             "lanes take no mesh")
        self.config = config
        self.model = model
        self.classes: dict[str, SLOClass] = dict(
            config.slo_classes or default_slo_classes())
        self.policy = config.brownout_policy or BrownoutPolicy()
        self.controller = BrownoutController(self.policy)
        self.metrics = metrics if metrics is not None \
            else Metrics(config.n_slots)
        for cls in self.classes.values():
            self.metrics.register_slo(cls.name, cls.ttft_ms, cls.itl_ms)
        # one shared flight recorder across the server and every lane: lane
        # events land on per-lane tracks, request flows cross lanes intact
        from .tracing import Tracer
        self.tracer = Tracer.from_config(config.trace)
        self.trace_track = "server"
        self.queue: deque[Request] = deque()

        n_rungs = 1 + (min(self.policy.max_level,
                           max((c.max_brownout for c in
                                self.classes.values()), default=0))
                       if config.brownout else 0)
        lane_cfg = dataclasses.replace(
            config, brownout=False, slo_classes=None, brownout_policy=None)
        self.lanes: list[PagedBatcher] = []
        for rung in range(n_rungs):
            kv = DEFAULT_KV_LADDER[min(rung, len(DEFAULT_KV_LADDER) - 1)]
            if rung == len(DEFAULT_KV_LADDER):        # low-bit weight rung
                lane_model, lane_params = self._draft_stack(model, params)
                cfg_r = dataclasses.replace(lane_cfg, kv_bits=kv,
                                            speculative=False)
            else:
                lane_model, lane_params = model, params
                cfg_r = dataclasses.replace(
                    lane_cfg, kv_bits=kv,
                    speculative=config.speculative and rung == 0)
            lane = PagedBatcher(lane_model, lane_params, cfg_r,
                                metrics=self.metrics, tracer=self.tracer)
            lane.tick = False      # the server emits one consolidated tick
            lane.trace_track = f"rung{rung}-kv{kv}" \
                + ("-spec" if cfg_r.speculative else "")
            self.lanes.append(lane)

        self.ledger: ByteLedger | None = None
        if config.pool_bytes is not None and len(self.lanes) > 1:
            self.ledger = ByteLedger(config.pool_bytes)
            for lane in self.lanes:
                self.ledger.attach(lane)

    def _draft_stack(self, model, params):
        """Build (and engine-register) the low-bit weight variant rung 3
        serves from.  Reuses rung 0's registration when speculation already
        packed it."""
        from repro_torch.core.precision import get_precision, signed
        from repro_torch.kernels import engine
        from repro_torch.models import build_model, to_serving
        cfg = model.cfg
        draft_cfg = dataclasses.replace(
            cfg, precision=self.config.draft_precision)
        draft_model = build_model(draft_cfg)
        draft_params = to_serving(params, draft_cfg)
        engine.register_variant(cfg.name, "primary",
                                signed(get_precision(cfg.precision)), params)
        engine.register_variant(cfg.name, self.config.draft_precision,
                                signed(get_precision(draft_cfg.precision)),
                                draft_params)
        return draft_model, draft_params

    # -------------------------------------------------------------- submit
    def submit(self, req: Request) -> None:
        if req.slo not in self.classes:
            raise UnknownSLOClassError(
                f"request {req.rid}: unknown SLO class {req.slo!r} "
                f"(configured: {sorted(self.classes)})",
                rid=req.rid, slo=req.slo, classes=tuple(sorted(self.classes)))
        # the strictest lane (rung 0) validates shape/budget/footprint; a
        # request it admits is admissible on every rung (deeper rungs have
        # the same s_max and cheaper — never costlier — blocks)
        self.lanes[0]._validate(req)
        if req.submitted_at == 0.0:
            req.submitted_at = time.time()
            self.metrics.on_submit(req)
        self.queue.append(req)

    # ---------------------------------------------------------------- step
    def _route(self, level: int) -> None:
        """Admission-time routing: drain the central queue head into its
        target lane while that lane can accept (its own queue is empty —
        keeping lanes' queues shallow so each request's rung reflects
        pressure at ITS admission, not at burst arrival).  Strict FIFO
        across classes: a busy target lane blocks the queue head rather
        than letting later requests overtake (deterministic routing)."""
        while self.queue:
            req = self.queue[0]
            rung = min(self.controller.route_level(self.classes[req.slo]),
                       len(self.lanes) - 1)
            lane = self.lanes[rung]
            if lane.queue:
                return
            self.queue.popleft()
            req.routed_rung = rung
            if rung > 0:
                self.metrics.on_brownout(level, degraded_admission=True)
            lane.submit(req)

    def step(self) -> list[Request]:
        """One server iteration: consolidated signal tick, controller
        observation, admission routing, then one step of every lane with
        work."""
        depth = len(self.queue) + sum(
            len(l.queue) + (1 if l._adm is not None else 0)
            for l in self.lanes)
        active = sum(
            1 for l in self.lanes for i in range(l.n_slots)
            if l.slots[i] is not None and not l.done[i])
        in_use = sum(l.pool_meta.used_blocks for l in self.lanes)
        total = sum(l.num_blocks - 1 for l in self.lanes)
        self.metrics.on_step(
            depth, pool_in_use=in_use, pool_total=total, active=active,
            util=self.ledger.utilization() if self.ledger else None)
        tr = self.tracer
        signals = self.metrics.controller_signals()
        prev_level = self.metrics.brownout_level
        level = self.controller.observe(signals)
        self.metrics.on_brownout(level)
        if level != prev_level and tr.enabled:
            # the transition instant carries the exact controller_signals()
            # snapshot the decision was made on — "what did the controller
            # see the tick it raised" is answerable from the trace alone
            tr.instant("brownout", "adaptive", track=self.trace_track,
                       level=level, prev_level=prev_level, **signals)
        self._route(level)
        finished: list[Request] = []
        if tr.enabled:
            tr.begin("step", "adaptive", track=self.trace_track,
                     queue_depth=depth, level=level)
        try:
            for lane in self.lanes:
                if not lane.idle:
                    finished.extend(lane.step())
        finally:
            if tr.enabled:
                tr.end("step", "adaptive", track=self.trace_track)
        if tr.snapshotter is not None:
            tr.tick_snapshot(self.metrics)
        return finished

    @property
    def idle(self) -> bool:
        return not self.queue and all(l.idle for l in self.lanes)

    def run(self, max_steps: int = 10_000) -> list[Request]:
        out: list[Request] = []
        try:
            for _ in range(max_steps):
                out.extend(self.step())
                if self.idle:
                    break
        except BaseException:
            self.tracer.on_crash()
            raise
        return out

    # ---------------------------------------------------------- invariants
    def check_pool(self) -> None:
        """Chaos-harness hook: every lane's pool invariants, plus the
        ledger's budget bound when one is installed."""
        for lane in self.lanes:
            lane.check_pool()
        if self.ledger is not None:
            used = self.ledger.used_bytes()
            if used > self.ledger.budget_bytes:
                raise AssertionError(
                    f"byte ledger overrun: {used} > "
                    f"{self.ledger.budget_bytes}")

    def summary(self) -> dict:
        return self.metrics.summary()
