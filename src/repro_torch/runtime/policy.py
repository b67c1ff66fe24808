"""Precision-as-a-control-knob policy layer for adaptive serving (the
port's own copy of ``repro.runtime.policy``).

The paper's Table 2 dial — binary/ternary PEs buy multiples of throughput
for accuracy — is frozen at config load everywhere else in this repo.  This
module makes it a *runtime* control surface:

  * :class:`SLOClass` — a named service tier (``premium`` / ``standard`` /
    ``batch`` by default) with TTFT/ITL targets, the deepest brownout rung
    its requests may be routed to, and whether its slots run
    self-speculative decoding.
  * the **brownout ladder** — an ordered list of (weight-variant, kv_bits)
    rungs.  Rung 0 is full fidelity; each later rung degrades *new
    admissions* (cheaper KV encodings first, low-bit weight variants last)
    instead of queueing them.  Already-active slots are never touched: a
    brownout only changes where the *next* admission lands.
  * :class:`BrownoutController` — a pure hysteresis controller mapping the
    per-step signals of :meth:`repro_torch.runtime.metrics.Metrics
    .controller_signals` (queue depth, pool utilization, TTFT/ITL tails)
    to a ladder rung.  Pressure raises the rung immediately; recovery
    lowers it only after ``cool_steps`` consecutive calm observations, so
    the ladder does not thrash at the threshold.
  * :func:`simulate_policy` / :func:`search_policy` — a tiny host-side
    queue simulator and a hillclimb over the controller thresholds,
    scoring completed-work against degraded-work on a bursty synthetic
    trace.

Everything here is host-side and model-free: the controller sees only the
metrics dict, so it is unit-testable without a model or a device.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Sequence

DEFAULT_KV_LADDER = (16, 8, 4)


# ---------------------------------------------------------------------------
# SLO classes
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One service tier.

    ``max_brownout`` is the deepest ladder rung this class may be degraded
    to (0 = pinned at full fidelity).  ``speculative`` marks the class for
    self-speculative decoding on its lane — drafts from the low-bit variant,
    verified (losslessly) by the full-precision weights.
    """
    name: str
    ttft_ms: float                 # attainment target: time-to-first-token
    itl_ms: float                  # attainment target: inter-token latency
    max_brownout: int = 0
    speculative: bool = False


def default_slo_classes() -> dict[str, SLOClass]:
    """The three stock tiers.  ``premium`` never degrades and runs the
    self-speculative fast path; ``standard`` rides the kv_bits rungs;
    ``batch`` may additionally spill onto the low-bit weight variant (the
    only tier whose *tokens* may differ from the fp stream — the paper's
    accuracy-for-throughput trade, taken knowingly)."""
    return {
        "premium": SLOClass("premium", ttft_ms=500.0, itl_ms=100.0,
                            max_brownout=0, speculative=True),
        "standard": SLOClass("standard", ttft_ms=2000.0, itl_ms=250.0,
                             max_brownout=2),
        "batch": SLOClass("batch", ttft_ms=10000.0, itl_ms=1000.0,
                          max_brownout=3),
    }


# ---------------------------------------------------------------------------
# brownout controller
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class BrownoutPolicy:
    """Thresholds the controller trips on.  ``*_high`` raises the rung,
    falling below ``*_low`` (all of them) counts toward recovery."""
    pool_high: float = 0.85        # pool utilization to raise the rung
    pool_low: float = 0.60         # pool utilization to allow lowering
    queue_high: float = 2.0        # queued requests per free slot
    queue_low: float = 0.5
    cool_steps: int = 8            # consecutive calm steps before lowering
    max_level: int = 3             # deepest rung the controller may reach


class BrownoutController:
    """Pure hysteresis ladder controller: observe(signals) -> rung.

    Raising is immediate (pressure compounds fast: an over-threshold pool
    utilization means the next admissions will preempt or queue); lowering
    waits for ``cool_steps`` consecutive below-low observations so a bursty
    arrival trace does not bounce the ladder every step.
    """

    def __init__(self, policy: BrownoutPolicy | None = None):
        self.policy = policy or BrownoutPolicy()
        self.level = 0
        self._calm = 0
        self.raises = 0
        self.lowers = 0

    def observe(self, signals: dict) -> int:
        """One controller tick against a ``controller_signals()`` dict."""
        p = self.policy
        util = float(signals.get("pool_utilization", 0.0))
        queue = float(signals.get("queue_per_slot", 0.0))
        hot = util >= p.pool_high or queue >= p.queue_high
        calm = util < p.pool_low and queue < p.queue_low
        if hot:
            self._calm = 0
            if self.level < p.max_level:
                self.level += 1
                self.raises += 1
        elif calm:
            self._calm += 1
            if self._calm >= p.cool_steps and self.level > 0:
                self.level -= 1
                self.lowers += 1
                self._calm = 0
        else:
            self._calm = 0
        return self.level

    def route_level(self, slo: SLOClass) -> int:
        """The ladder rung a new admission of class ``slo`` lands on."""
        return min(self.level, slo.max_brownout)


# ---------------------------------------------------------------------------
# policy search (hillclimb)
# ---------------------------------------------------------------------------
def simulate_policy(policy: BrownoutPolicy,
                    arrivals: Sequence[int],
                    *,
                    capacity: float = 4.0,
                    rung_cost: Sequence[float] = (1.0, 0.55, 0.35, 0.25),
                    rung_penalty: Sequence[float] = (0.0, 0.05, 0.12, 0.30),
                    pool_blocks: float = 64.0) -> dict:
    """Tiny host-side queue simulator for scoring a brownout policy.

    One step = one scheduler iteration.  ``arrivals[t]`` requests join at
    step ``t``; the server completes ``capacity / rung_cost[rung]`` requests
    per step (cheaper rungs drain faster), each completion at rung r scoring
    ``1 - rung_penalty[r]`` (degraded work is worth less — the accuracy side
    of the dial).  Pool utilization tracks resident work.  Returns the score
    plus the trace the regression tests assert on.
    """
    ctl = BrownoutController(policy)
    queue = 0.0
    resident = 0.0
    score = 0.0
    completed = 0.0
    max_level = 0
    for t in range(len(arrivals)):
        queue += arrivals[t]
        util = min(resident / pool_blocks, 1.0)
        level = ctl.observe({"pool_utilization": util,
                             "queue_per_slot": queue / capacity})
        level = min(level, len(rung_cost) - 1)
        max_level = max(max_level, level)
        admit = min(queue, capacity)
        queue -= admit
        resident = min(resident + admit, pool_blocks)
        drain = min(resident, capacity / rung_cost[level])
        resident -= drain
        completed += drain
        score += drain * (1.0 - rung_penalty[level])
    # queue left over at the end of the trace is work never served
    score -= 0.5 * queue
    return {"score": score, "completed": completed, "left_queued": queue,
            "max_level": max_level, "raises": ctl.raises,
            "lowers": ctl.lowers}


def search_policy(arrivals: Sequence[int],
                  seed: BrownoutPolicy | None = None,
                  iters: int = 32, **sim_kwargs
                  ) -> tuple[BrownoutPolicy, dict]:
    """Coordinate-descent hillclimb over the controller thresholds.

    Seeded with ``seed`` (the stock :class:`BrownoutPolicy` by default),
    each iteration
    nudges one threshold up or down and keeps the move if the simulated
    score improves.  Deterministic: the neighbor schedule is a fixed
    round-robin, no RNG."""
    best = dataclasses.replace(seed) if seed else BrownoutPolicy()
    best_out = simulate_policy(best, arrivals, **sim_kwargs)
    knobs = [("pool_high", 0.05, 0.5, 0.99),
             ("pool_low", 0.05, 0.1, 0.95),
             ("queue_high", 0.5, 0.5, 16.0),
             ("queue_low", 0.25, 0.0, 8.0),
             ("cool_steps", 2, 1, 64)]
    for it in range(iters):
        name, step, lo, hi = knobs[it % len(knobs)]
        for sign in (+1, -1):
            cand = dataclasses.replace(best)
            val = getattr(cand, name) + sign * step
            val = type(getattr(cand, name))(min(max(val, lo), hi))
            setattr(cand, name, val)
            if cand.pool_low >= cand.pool_high \
                    or cand.queue_low >= cand.queue_high:
                continue
            out = simulate_policy(cand, arrivals, **sim_kwargs)
            if out["score"] > best_out["score"]:
                best, best_out = cand, out
                break
    return best, best_out


def bursty_trace(n_steps: int = 96, burst_every: int = 24,
                 burst: int = 12, base: int = 0) -> list[int]:
    """Synthetic bursty arrival trace (the regression tests' workload):
    long idle stretches punctuated by admission spikes — exactly the shape
    that starves a per-admission-sampled controller, since no admissions
    happen during the idle tail it must recover in."""
    return [base + (burst if t % burst_every == 0 else 0)
            for t in range(n_steps)]
