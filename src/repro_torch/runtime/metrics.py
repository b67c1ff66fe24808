"""Serving metrics — TTFT / ITL / queue-time percentiles and throughput.

The paper's headline number (3,700 img/s on Arria 10) is a *serving* number:
it only holds while the scheduler keeps the PEs saturated.  This module is
the accounting side of that claim for the LM scheduler: every request's
queue wait, time-to-first-token and inter-token latencies are sampled, and
``summary()`` folds them into the percentiles a load test cares about.

Host-side and allocation-light: one float append per token, percentile math
only on demand.
"""
from __future__ import annotations

import time
from collections import deque

PERCENTILES = (50, 90, 99)

# per-step gauge history kept for the brownout controller (scheduler steps)
SIGNAL_WINDOW = 64


def _pcts(samples: list[float]) -> dict[str, float]:
    if not samples:
        return {f"p{p}": 0.0 for p in PERCENTILES} | {"mean": 0.0, "n": 0}
    xs = sorted(samples)
    n = len(xs)
    out = {}
    for p in PERCENTILES:
        # canonical nearest-rank (inverted CDF): 1-indexed rank ceil(p/100*n)
        # — matches numpy.percentile(..., method="inverted_cdf").  (The old
        # round(p/100*(n-1)) drifted a rank high whenever the fraction hit
        # .5: p50 of 4 samples gave the 3rd-smallest, not the 2nd.)
        rank = -(-p * n // 100)               # ceil(p*n/100) in ints
        out[f"p{p}"] = xs[min(n - 1, max(0, int(rank) - 1))]
    out["mean"] = sum(xs) / n
    out["n"] = n
    return out


class Metrics:
    """Aggregates per-request serving latencies and scheduler counters.

    Samples (all milliseconds):
      queue_ms : submit -> admission start (prefill begins)
      ttft_ms  : submit -> first generated token
      itl_ms   : gap between consecutive generated tokens of one request

    Counters:
      decode_steps / prefill_chunks / prefill_full : batched decode
      iterations, chunk-admission calls, and whole-prompt prefill calls;
      decode_slot_tokens: tokens produced by batched decode (occupancy
      numerator — decode_steps * n_slots is the denominator).

    Paged-KV counters (runtime.kvcache; all zero for the dense batcher):
      prefix_lookups / prefix_hits / prefix_hit_tokens : radix prefix-cache
      admissions — lookups, admissions with a non-empty PROMPT-block match,
      and prompt tokens whose prefill was skipped;
      suffix_hits / suffix_hit_tokens : admissions that matched
      generated-suffix blocks (decode-written KV registered at release or
      preemption), and the tokens those blocks covered — split from the
      prompt counters so agent-style reuse and preemption-recompute savings
      are visible separately;
      preemptions / recomputed_tokens : requests preempted mid-flight
      (blocks released, re-queued), and the already-computed positions their
      re-admissions actually re-prefilled (radix suffix hits shrink this);
      blocks_evicted : cached blocks dropped under pool pressure;
      kv_blocks_in_use / kv_blocks_peak / kv_blocks_total : pool occupancy
      gauge, its high-water mark, and the allocatable pool size.

    Concurrency gauge: requests_active / requests_active_peak — admitted
    requests currently resident (admission++ / finish-or-preempt--) and the
    high-water mark; the overcommit bench's "admitted concurrency" number.
    """

    def __init__(self, n_slots: int = 0):
        self.n_slots = n_slots
        self.queue_ms: list[float] = []
        self.ttft_ms: list[float] = []
        self.itl_ms: list[float] = []
        self.requests_submitted = 0
        self.requests_finished = 0
        self.requests_active = 0
        self.requests_active_peak = 0
        self.tokens_out = 0
        self.prompt_tokens = 0
        self.decode_steps = 0
        self.decode_slot_tokens = 0
        self.prefill_chunks = 0
        self.prefill_full = 0
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        self.suffix_hits = 0
        self.suffix_hit_tokens = 0
        self.preemptions = 0
        self.recomputed_tokens = 0
        self.blocks_evicted = 0
        self.kv_blocks_in_use = 0
        self.kv_blocks_peak = 0
        self.kv_blocks_total = 0
        # ---- adaptive serving -------------------------------------------
        # per-step controller gauges (window-anchored: one sample per
        # SCHEDULER STEP via on_step, never per admission — see
        # controller_signals); deques so an idle tail pushes the burst out
        # of the window and the brownout controller can recover
        self.scheduler_steps = 0
        self._step_queue: deque = deque(maxlen=SIGNAL_WINDOW)
        self._step_util: deque = deque(maxlen=SIGNAL_WINDOW)
        self._step_active: deque = deque(maxlen=SIGNAL_WINDOW)
        # per-SLO-class latency samples + attainment targets
        self.slo_targets: dict[str, dict[str, float]] = {}
        self._slo_ttft: dict[str, list[float]] = {}
        self._slo_itl: dict[str, list[float]] = {}
        self._slo_finished: dict[str, int] = {}
        self._slo_attained: dict[str, int] = {}
        self.brownout_level = 0
        self.brownout_raises = 0
        self.degraded_admissions = 0
        # self-speculative decode counters
        self.spec_verify_steps = 0
        self.spec_draft_tokens = 0
        self.spec_accepted_tokens = 0
        self._t0: float | None = None           # first ADMISSION (compute)
        self._t0_submit: float | None = None    # first submit (queue open)
        self._t1: float | None = None

    # ------------------------------------------------------------- recording
    def _touch(self):
        now = time.time()
        if self._t0 is None:
            self._t0 = now
        self._t1 = now

    def on_submit(self, req) -> None:
        self.requests_submitted += 1
        # submits open the SUBMIT window only: the throughput wall-clock
        # (_t0) starts at the first admission, and a submit never advances
        # the window END either — tok/s must not amortize queue-idle time,
        # neither before any compute ran nor after the last token (both
        # windows are reported by summary() so bench history stays
        # comparable)
        if self._t0_submit is None:
            self._t0_submit = time.time()

    def on_admit(self, req, n_prompt_tokens: int | None = None,
                 resumed: bool = False) -> None:
        """One admission.  ``n_prompt_tokens`` overrides the prompt width
        (a preemption-resumed request prefills prompt + generated tokens);
        ``resumed`` re-admissions skip the queue-wait sample — queue_ms
        measures submit -> FIRST admission only — but still count their
        prefill traffic so prefix/suffix hit rates stay true rates."""
        if not resumed:
            self.queue_ms.append((req.started_at - req.submitted_at) * 1e3)
        self.prompt_tokens += int(n_prompt_tokens
                                  if n_prompt_tokens is not None
                                  else req.tokens.shape[-1])
        self.requests_active += 1
        self.requests_active_peak = max(self.requests_active_peak,
                                        self.requests_active)
        self._touch()

    def on_token(self, req, first: bool) -> None:
        self.tokens_out += 1
        now = time.time()
        if first:
            self.ttft_ms.append((now - req.submitted_at) * 1e3)
        elif req.last_token_at is not None:
            # identity check, not truthiness: a last_token_at of exactly 0.0
            # (monkeypatched clocks in tests) is a real timestamp and its
            # ITL sample must not be dropped
            self.itl_ms.append((now - req.last_token_at) * 1e3)
        self._touch()

    def on_finish(self, req) -> None:
        self.requests_finished += 1
        self.requests_active = max(self.requests_active - 1, 0)
        self.on_slo_finish(req)
        self._touch()

    # ------------------------------------------------------ paged-KV counters
    def on_prefix_lookup(self, hit_tokens: int, prompt_tokens: int,
                         suffix_tokens: int = 0) -> None:
        """One radix prefix-cache admission lookup: ``hit_tokens`` prompt
        positions were served from cached prompt blocks (0 on a miss) and
        ``suffix_tokens`` from generated-suffix blocks."""
        self.prefix_lookups += 1
        if hit_tokens > 0:
            self.prefix_hits += 1
            self.prefix_hit_tokens += int(hit_tokens)
        if suffix_tokens > 0:
            self.suffix_hits += 1
            self.suffix_hit_tokens += int(suffix_tokens)

    def on_preempt(self, req) -> None:
        """One mid-flight preemption: the request's blocks were released and
        it went back to the queue (its re-admission recomputes)."""
        self.preemptions += 1
        self.requests_active = max(self.requests_active - 1, 0)

    def on_recompute(self, n_tokens: int) -> None:
        """A preemption-resumed admission re-prefilled ``n_tokens`` positions
        whose KV had already been computed before the preemption (suffix
        radix hits make this approach zero)."""
        self.recomputed_tokens += int(n_tokens)

    def on_evictions(self, n_blocks: int) -> None:
        self.blocks_evicted += int(n_blocks)

    def on_kv_blocks(self, in_use: int, total: int) -> None:
        """Pool occupancy gauge (called on every allocation/release wave)."""
        self.kv_blocks_in_use = int(in_use)
        self.kv_blocks_total = int(total)
        self.kv_blocks_peak = max(self.kv_blocks_peak, int(in_use))

    # ------------------------------------------------- adaptive serving
    def register_slo(self, name: str, ttft_ms: float, itl_ms: float) -> None:
        """Declare an SLO class's attainment targets (adaptive serving)."""
        self.slo_targets[name] = {"ttft_ms": float(ttft_ms),
                                  "itl_ms": float(itl_ms)}
        self._slo_ttft.setdefault(name, [])
        self._slo_itl.setdefault(name, [])
        self._slo_finished.setdefault(name, 0)
        self._slo_attained.setdefault(name, 0)

    def on_step(self, queue_depth: int, pool_in_use: int | None = None,
                pool_total: int | None = None, active: int = 0,
                util: float | None = None) -> None:
        """One SCHEDULER STEP tick — the controller-signal sample point.

        This is deliberately per-step, not per-admission: an admission-driven
        gauge freezes at whatever the last admission wave saw, so a burst
        followed by an idle queue would pin the brownout controller at its
        burst reading forever (nothing admits, nothing re-samples, the
        ladder never recovers).  Stepping the scheduler IS the clock.

        ``util`` overrides the utilization sample directly (the adaptive
        server's byte ledger spans lanes whose blocks cost different byte
        amounts, so a block-count ratio would be meaningless there)."""
        self.scheduler_steps += 1
        self._step_queue.append(int(queue_depth))
        if pool_in_use is not None and pool_total:
            self.kv_blocks_in_use = int(pool_in_use)
            self.kv_blocks_total = int(pool_total)
            self.kv_blocks_peak = max(self.kv_blocks_peak, int(pool_in_use))
        if util is None:
            util = (self.kv_blocks_in_use / self.kv_blocks_total
                    if self.kv_blocks_total else 0.0)
        self._step_util.append(float(util))
        self._step_active.append(int(active))

    def controller_signals(self, tail: int = 32) -> dict:
        """The brownout controller's per-step view: CURRENT queue depth and
        pool utilization (latest scheduler-step sample, not an admission-time
        snapshot) plus windowed means and the recent TTFT/ITL tail
        percentiles (last ``tail`` samples)."""
        q_now = self._step_queue[-1] if self._step_queue else 0
        u_now = self._step_util[-1] if self._step_util else 0.0
        n = max(len(self._step_queue), 1)
        slots = max(self.n_slots, 1)
        return {
            "queue_depth": q_now,
            "queue_per_slot": q_now / slots,
            "queue_depth_mean": sum(self._step_queue) / n,
            "pool_utilization": u_now,
            "pool_utilization_mean": sum(self._step_util) / n,
            "active": self._step_active[-1] if self._step_active else 0,
            "ttft_p90_ms": _pcts(self.ttft_ms[-tail:])["p90"],
            "itl_p90_ms": _pcts(self.itl_ms[-tail:])["p90"],
            "steps": self.scheduler_steps,
        }

    def on_brownout(self, level: int, degraded_admission: bool = False
                    ) -> None:
        """Controller tick outcome: current rung, and whether an admission
        this tick was routed below full fidelity."""
        if level > self.brownout_level:
            self.brownout_raises += 1
        self.brownout_level = int(level)
        if degraded_admission:
            self.degraded_admissions += 1

    def on_spec_round(self, drafted: int, accepted: int) -> None:
        """One draft/verify round: ``drafted`` tokens proposed across the
        batch, ``accepted`` tokens emitted from the single verify step."""
        self.spec_verify_steps += 1
        self.spec_draft_tokens += int(drafted)
        self.spec_accepted_tokens += int(accepted)

    def on_slo_finish(self, req) -> None:
        """Fold a finished request into its SLO class's attainment: TTFT
        under target AND the request's mean ITL under target."""
        name = getattr(req, "slo", None)
        if name not in self.slo_targets:
            return
        tgt = self.slo_targets[name]
        ttft = (req.first_token_at - req.submitted_at) * 1e3
        n_gap = max(len(req.output) - 1, 0)
        itl = ((req.last_token_at - req.first_token_at) * 1e3 / n_gap
               if n_gap else 0.0)
        self._slo_ttft[name].append(ttft)
        self._slo_itl[name].append(itl)
        self._slo_finished[name] += 1
        if ttft <= tgt["ttft_ms"] and itl <= tgt["itl_ms"]:
            self._slo_attained[name] += 1

    # --------------------------------------------------------------- summary
    @property
    def wall_s(self) -> float:
        """Serving window: first ADMISSION -> last event.  Excludes pure
        queue-idle time before any compute ran (requests submitted into an
        idle scheduler no longer deflate tok/s)."""
        if self._t0 is None or self._t1 is None:
            return 0.0
        return self._t1 - self._t0

    @property
    def wall_since_submit_s(self) -> float:
        """Legacy window: first SUBMIT -> last event (what summary() reported
        before the admission-window fix; kept for bench comparability)."""
        if self._t0_submit is None or self._t1 is None:
            return 0.0
        return self._t1 - self._t0_submit

    def summary(self) -> dict:
        wall = max(self.wall_s, 1e-9)
        wall_sub = max(self.wall_since_submit_s, 1e-9)
        decode_cap = max(self.decode_steps * max(self.n_slots, 1), 1)
        return {
            "requests": {"submitted": self.requests_submitted,
                         "finished": self.requests_finished},
            "tokens": {"prompt": self.prompt_tokens, "generated": self.tokens_out},
            "queue_ms": _pcts(self.queue_ms),
            "ttft_ms": _pcts(self.ttft_ms),
            "itl_ms": _pcts(self.itl_ms),
            "throughput": {
                # primary window starts at the first admission (compute)
                "window": "admission",
                "wall_s": self.wall_s,
                "tok_per_s": self.tokens_out / wall,
                "req_per_s": self.requests_finished / wall,
                # legacy submit-anchored window, for bench-history continuity
                "since_submit": {
                    "wall_s": self.wall_since_submit_s,
                    "tok_per_s": self.tokens_out / wall_sub,
                    "req_per_s": self.requests_finished / wall_sub,
                },
            },
            "scheduler": {
                "decode_steps": self.decode_steps,
                "prefill_chunks": self.prefill_chunks,
                "prefill_full": self.prefill_full,
                # fraction of decode-slot capacity that produced a token
                "slot_occupancy": self.decode_slot_tokens / decode_cap,
                "preemptions": self.preemptions,
                "recomputed_tokens": self.recomputed_tokens,
                # admitted-concurrency high-water mark (requests resident
                # at once — the overcommit capacity number)
                "active_peak": self.requests_active_peak,
            },
            "kv_cache": {
                "prefix": {
                    "lookups": self.prefix_lookups,
                    "hits": self.prefix_hits,
                    "hit_tokens": self.prefix_hit_tokens,
                    # fraction of admitted prompt tokens served from cache
                    "hit_rate": self.prefix_hit_tokens / max(self.prompt_tokens, 1),
                },
                # generated-suffix (decode-written, release/preempt-registered)
                # block hits, split from the prompt-prefix counters above
                "suffix": {
                    "hits": self.suffix_hits,
                    "hit_tokens": self.suffix_hit_tokens,
                    "hit_rate": self.suffix_hit_tokens / max(self.prompt_tokens, 1),
                },
                "blocks": {
                    "total": self.kv_blocks_total,
                    "in_use": self.kv_blocks_in_use,
                    "peak_in_use": self.kv_blocks_peak,
                    "utilization": self.kv_blocks_in_use / max(self.kv_blocks_total, 1),
                    "peak_utilization": self.kv_blocks_peak / max(self.kv_blocks_total, 1),
                },
                "evicted_blocks": self.blocks_evicted,
            },
        } | self._adaptive_summary()

    def _adaptive_summary(self) -> dict:
        """The adaptive-serving sections (empty when the features are off,
        so pre-redesign summary consumers see an unchanged dict)."""
        out = {}
        if self.slo_targets:
            out["slo"] = {
                name: {
                    "target": dict(tgt),
                    "finished": self._slo_finished[name],
                    "attained": self._slo_attained[name],
                    "attainment": (self._slo_attained[name]
                                   / max(self._slo_finished[name], 1)),
                    "ttft_ms": _pcts(self._slo_ttft[name]),
                    "itl_ms": _pcts(self._slo_itl[name]),
                }
                for name, tgt in self.slo_targets.items()
            }
        if self.brownout_level or self.brownout_raises \
                or self.degraded_admissions:
            out["brownout"] = {
                "level": self.brownout_level,
                "raises": self.brownout_raises,
                "degraded_admissions": self.degraded_admissions,
            }
        if self.spec_verify_steps:
            out["speculative"] = {
                "verify_steps": self.spec_verify_steps,
                "draft_tokens": self.spec_draft_tokens,
                "accepted_tokens": self.spec_accepted_tokens,
                # emitted tokens per fp verify dispatch: > 1.0 means the
                # low-bit drafts bought real batched-decode work
                "accepted_per_verify": (self.spec_accepted_tokens
                                        / max(self.spec_verify_steps, 1)),
                # legacy blended rate: accepted over drafted + verify steps
                # (mixes draft tokens with dispatch counts — kept verbatim
                # for bench-history continuity; prefer draft_accept_rate)
                "accept_rate": (self.spec_accepted_tokens
                                / max(self.spec_draft_tokens
                                      + self.spec_verify_steps, 1)),
                # fraction of DRAFTED tokens the fp verify confirmed — the
                # unit-consistent acceptance number draft-window autotuning
                # should read
                "draft_accept_rate": (self.spec_accepted_tokens
                                      / max(self.spec_draft_tokens, 1)),
            }
        return out

    def format(self) -> str:
        s = self.summary()
        t, q, i = s["ttft_ms"], s["queue_ms"], s["itl_ms"]
        th, sc = s["throughput"], s["scheduler"]
        return (
            f"served {s['requests']['finished']}/{s['requests']['submitted']} reqs, "
            f"{s['tokens']['generated']} tok in {th['wall_s']:.2f} s "
            f"({th['tok_per_s']:.1f} tok/s)\n"
            f"  ttft ms  p50 {t['p50']:.1f}  p90 {t['p90']:.1f}  p99 {t['p99']:.1f}\n"
            f"  itl  ms  p50 {i['p50']:.1f}  p90 {i['p90']:.1f}  p99 {i['p99']:.1f}\n"
            f"  queue ms p50 {q['p50']:.1f}  p90 {q['p90']:.1f}  p99 {q['p99']:.1f}\n"
            f"  decode steps {sc['decode_steps']} (occupancy "
            f"{sc['slot_occupancy']:.2f}), prefill chunks {sc['prefill_chunks']}, "
            f"full prefills {sc['prefill_full']}"
            + (f"\n  kv blocks {kc['blocks']['in_use']}/{kc['blocks']['total']}"
               f" (peak {kc['blocks']['peak_in_use']}), prefix hit rate "
               f"{kc['prefix']['hit_rate']:.2f} "
               f"({kc['prefix']['hit_tokens']} tok), "
               f"suffix hits {kc['suffix']['hit_tokens']} tok, "
               f"evicted {kc['evicted_blocks']}"
               if (kc := s["kv_cache"])["blocks"]["total"] else "")
            + (f"\n  preemptions {sc['preemptions']} "
               f"(recomputed {sc['recomputed_tokens']} tok), "
               f"peak concurrent {sc['active_peak']}"
               if sc["preemptions"] else ""))
