"""PagedBatcher — continuous batching over the paged, quantized KV cache
(``repro.runtime.kvcache.batcher``).

A :class:`repro_torch.runtime.serving.ContinuousBatcher` whose KV state is a
block pool + per-slot page tables instead of dense (n_slots, s_max) slabs:

  * **Admission** looks the prompt up in the radix prefix cache; matched
    full blocks are referenced into the new request's page table and their
    prefill is skipped.  ``reserve="prompt"`` (the default) reserves only
    the prompt's blocks; ``reserve="budget"`` reserves every block through
    the generation budget up front (decode never allocates, nothing is
    preempted).
  * **Decode** allocates lazily: a slot crossing a block boundary takes one
    block right before the batched step.  On pool exhaustion the
    latest-admitted request is **preempted** (the mid-flight admission
    before any active slot): its blocks are released and it re-enters the
    queue head with its generated tokens; re-admission prefills prompt +
    generated tokens, mostly as radix hits.  With ``preemption="off"`` a
    starved slot stalls instead, and the scheduler raises when every active
    slot is stalled with no admission in flight.
  * **Generated-suffix sharing**: release and preemption register the
    decode-written full blocks in the radix tree (kind ``suffix``).
  * **Prefill chunks** write their KV into the owning blocks through the
    admission's page-table row (no admission cache, no slot-join copy).
  * **kv_bits** ∈ {16, 8, 4}: blocks hold raw model-dtype KV or int8/int4
    codes + per-position scales (the dense cache's quantizer).

The loop is host-driven, like the port's dense batcher: each decode step
gathers the live slots' tokens, positions and page-table rows on the host
(``slot_map``: the live slots, padded to a power-of-two occupancy bucket by
repeating the last one), makes one host->device copy of them, selects the
next tokens on the device from the compact (L, V) logits (the greedy
argmax, or :func:`~repro_torch.runtime.serving.select_tokens` for sampled
rows, whose noise depends on (seed, rid, n_out) only, so a padding row
repeats its slot's draw) and makes one device->host copy of them.  The
flight recorder adds the paged events of the reference (admission and
re-admission flows, ``evict``, the ``kv_blocks`` counter, ``preempt`` and
``stall``).

Over a mesh (``ServingConfig.mesh``) every rank runs this loop on the same
requests.  Pure DP replicates the whole step on every rank, as the
reference's shard-local step does: the pool cannot split over data (its
blocks are shared by every slot).  Tensor parallelism cuts the params and
the pool's KV heads over 'model' (``parallel.sharding.pool_specs``).
Speculative decoding takes no mesh (the reference's rule).

**Self-speculative decoding** (``ServingConfig.speculative``): a low-bit
variant of the float weights (``draft_precision``, packed by ``to_serving``)
drafts up to ``draft_k`` tokens a slot through the same ragged dispatch,
writing its approximate KV into the same pool; one windowed decode of the
float weights (``decode_window_paged``) over (last token, drafts) rewrites
that KV exactly and gives the float model's token after each prefix, and
the longest confirmed draft prefix is emitted.  Each draft step copies only
the (n_slots,) next tokens to the host.  Sampled rows select with the same
(seed, rid, n_out) noise as the sequential step, so speculative streams,
greedy or sampled, are the non-speculative streams wherever the window's
logits equal the sequential step's.

**Cross-lane byte ledger**: the adaptive server may install a
:class:`~repro_torch.runtime.adaptive.ByteLedger` (``_ledger``); allocation
then also has to fit the lanes' shared byte budget.

Progress: the earliest-admitted active request is never a preemption victim
and a sole resident request never needs more than ``blocks_per_seq`` blocks,
so every admitted request eventually finishes even on an overcommitted
pool.
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from repro_torch.runtime.errors import PoolFootprintError
from repro_torch.runtime.serving import (ContinuousBatcher, Request,
                                         ServingConfig, _Admission,
                                         bucket_length, select_tokens)

from .pool import BlockPool
from .radix import RadixPrefixCache

KV_BITS_CHOICES = (16, 8, 4)
RESERVE_CHOICES = ("prompt", "budget")
PREEMPTION_CHOICES = ("recompute", "off")


def paged_block_bytes(cfg, block_size: int, kv_bits: int) -> int:
    """Device bytes one physical block costs across the whole layer stack."""
    kvh, dh = cfg.n_kv_heads, cfg.dh
    n_attn = sum(1 for m in cfg.layer_pattern if m.startswith("attn")) \
        * cfg.n_periods
    if kv_bits < 16:
        dh_store = dh // 2 if kv_bits == 4 else dh
        per_layer = 2 * block_size * kvh * (dh_store + 4)    # codes + f32 scale
    else:
        from repro_torch.models.layers import pdtype
        per_layer = 2 * block_size * kvh * dh * pdtype(cfg).itemsize
    return per_layer * n_attn


def paged_capacity_blocks(cfg, pool_bytes: int, block_size: int,
                          kv_bits: int) -> int:
    """Allocatable blocks (excluding the null block) a byte budget buys."""
    return max(pool_bytes // paged_block_bytes(cfg, block_size, kv_bits) - 1, 0)


class PagedBatcher(ContinuousBatcher):
    """Slot-based continuous batching over a paged KV pool.

    Paged fields of :class:`ServingConfig`:
      kv_bits      : 16 (raw) | 8 | 4 (codes + per-position scales)
      block_size   : positions per physical block (s_max rounds up to it)
      num_blocks   : pool size incl. the null block (default: every slot can
                     hold a full sequence, plus one sequence of slack)
      pool_bytes   : size the pool to a byte budget instead
      prefix_cache : radix prefix sharing (on by default)
      reserve      : "prompt" (default) | "budget"
      preemption   : "recompute" (default) | "off"
      fused_decode : one engine dispatch per decode layer (attention + wo)
      ragged_decode: decode over live slots in occupancy buckets (else the
                     padded (n_slots, 1) batch)
      speculative  : self-speculative decoding with the ``draft_precision``
                     variant drafting ``draft_k`` tokens a round
    """

    _split_rows = False

    def __init__(self, model, params, config: ServingConfig, *,
                 metrics=None, tracer=None):
        if not isinstance(config, ServingConfig):
            raise TypeError(f"config must be a ServingConfig, got "
                            f"{type(config).__name__}")
        if config.kv_bits not in KV_BITS_CHOICES:
            raise ValueError(f"kv_bits must be one of {KV_BITS_CHOICES}, "
                             f"got {config.kv_bits}")
        if config.reserve not in RESERVE_CHOICES:
            raise ValueError(f"reserve must be one of {RESERVE_CHOICES}, "
                             f"got {config.reserve!r}")
        if config.preemption not in PREEMPTION_CHOICES:
            raise ValueError(f"preemption must be one of "
                             f"{PREEMPTION_CHOICES}, got {config.preemption!r}")
        if model.decode_step_paged is None:
            raise ValueError(
                f"{model.cfg.name}: the paged KV cache needs an "
                "attention-only token LM (SSM state has no sequence dim to "
                "page; embeds/enc-dec stacks have no token stream to share)")
        if model.cfg.kv_bits:
            raise ValueError(
                "paged serving owns KV quantization (kv_bits=...); build the "
                "model with cfg.kv_bits=0")
        self.kv_bits = int(config.kv_bits)
        self.block_size = int(config.block_size)
        self._fused = bool(config.fused_decode)
        self._ragged = bool(config.ragged_decode)
        self.prefix_cache = bool(config.prefix_cache)
        self.reserve = config.reserve
        self.preemption = config.preemption
        # cross-lane byte budget (the adaptive server installs one; None:
        # the lane's own pool is the only limit)
        self._ledger = None
        self.spec = bool(config.speculative)
        self.spec_k = int(config.draft_k)
        self.draft_precision = config.draft_precision
        if self.spec:
            from repro_torch.core.precision import (W_FLOAT, get_precision,
                                                    signed)
            if config.mesh is not None:
                raise ValueError(
                    "speculative decoding is single-host for now (the "
                    "windowed verify step has no sharded dispatch)")
            if self.spec_k < 1:
                raise ValueError(f"draft_k must be >= 1, got {self.spec_k}")
            if model.decode_window_paged is None:
                raise ValueError(
                    f"{model.cfg.name}: speculative decoding needs the "
                    "windowed paged decode path (attention-only token LM)")
            if signed(get_precision(model.cfg.precision)).w_mode != W_FLOAT:
                raise ValueError(
                    f"{model.cfg.precision}: self-speculative serving needs "
                    "a float-weight primary — float weights are what the "
                    "draft variant packs down from.  (Quantized-act "
                    "primaries are fine: per-row act scales keep the verify "
                    "window's rows bit-identical to sequential decode.)")
            get_precision(self.draft_precision)   # unknown name raises here
        super().__init__(model, params, config, metrics=metrics,
                         tracer=tracer)
        if config.autotune and self._ragged:
            # the ragged decode runs every matmul at an occupancy bucket's
            # rows: tune those M rows too (the base class covered n_slots)
            self.tuned = self._autotune(model.cfg, self._occupancy_buckets(),
                                        self.chunk_size)
        if self.spec:
            self._build_speculative(model.cfg)

    # ------------------------------------------------------------- runtime
    def _build_runtime(self, cfg):
        if not self.chunk_size:
            raise ValueError(
                f"{cfg.name}: paged serving admits prompts through chunked "
                "prefill; pass a chunk_size > 0")
        bs = self.block_size
        self.s_pad = bucket_length(self.s_max, bs)
        self.blocks_per_seq = self.s_pad // bs
        if self.config.num_blocks is not None:
            num_blocks = int(self.config.num_blocks)
        elif self.config.pool_bytes is not None:
            num_blocks = 1 + paged_capacity_blocks(
                cfg, self.config.pool_bytes, bs, self.kv_bits)
        else:
            num_blocks = 1 + (self.n_slots + 1) * self.blocks_per_seq
        # budget reservation must serve any admissible request; prompt
        # reservation needs per-request footprints to fit (checked at submit)
        min_blocks = 1 + (self.blocks_per_seq if self.reserve == "budget"
                          else 1)
        if num_blocks < min_blocks:
            raise ValueError(
                f"pool of {num_blocks} blocks cannot hold one "
                + (f"{self.blocks_per_seq}-block sequence "
                   if self.reserve == "budget" else "block ")
                + f"(s_max={self.s_max}, block_size={bs}, "
                  f"reserve={self.reserve!r})")
        self.num_blocks = num_blocks

        self.pool_meta = BlockPool(num_blocks)
        self.radix = RadixPrefixCache(self.pool_meta, bs) \
            if self.prefix_cache else None
        from repro_torch.models import transformer as tfm
        self.pool = tfm.make_pool(cfg, num_blocks, bs, self.kv_bits,
                                  self.device, mesh=self.mesh)
        self._pt = np.zeros((self.n_slots, self.blocks_per_seq), np.int32)
        self._slot_blocks: list[list[int] | None] = [None] * self.n_slots
        # admission order = preemption priority (earlier admitted wins)
        self._slot_seq = np.zeros(self.n_slots, np.int64)
        self._seq_counter = 0
        # rid -> positions computed before its preemption: the
        # re-admission's recomputed_tokens debt, net of radix hits
        self._recompute_debt = {}
        self.metrics.on_kv_blocks(0, num_blocks - 1)

    def _build_speculative(self, cfg):
        """Draft-variant wiring: pack the float weights down to the draft
        precision (``to_serving`` with its default ``tp``, as the
        reference), register both variants with the engine, and under
        ``autotune`` tune the verify window's ``n_slots * (k+1)`` rows and
        the draft's rows (the occupancy buckets of the ragged dispatch)."""
        from repro_torch.core.precision import get_precision, signed
        from repro_torch.kernels import engine
        from repro_torch.models import build_model, to_serving
        draft_cfg = dataclasses.replace(cfg, precision=self.draft_precision)
        draft_pcfg = signed(get_precision(self.draft_precision))
        self._draft_model = build_model(draft_cfg)
        self._draft_params = to_serving(self.params, draft_cfg)
        engine.register_variant(cfg.name, "primary",
                                signed(get_precision(cfg.precision)),
                                self.params)
        engine.register_variant(cfg.name, self.draft_precision, draft_pcfg,
                                self._draft_params)
        if self.config.autotune:
            window = (self.n_slots * (self.spec_k + 1),)
            self.tuned = self.tuned + self._autotune(
                cfg, window, self.chunk_size) + engine.tune_serving_shapes(
                draft_cfg, draft_pcfg, n_slots=self.n_slots,
                chunk_size=self.chunk_size,
                extra_m=self._occupancy_buckets(), device=self.device)

    # -------------------------------------------------------------- submit
    def _blocks_needed(self, length: int, max_new: int) -> int:
        """Blocks covering every position the request can ever write: decode
        writes stop at position s_max-2, except the first decode write at
        position L, which activation never caps."""
        n_pos = min(length + max_new - 1, max(length + 1, self.s_max - 1))
        return -(-n_pos // self.block_size)

    def _validate(self, req: Request):
        super()._validate(req)
        # lifetime capacity check (both reserve policies): a sole resident
        # request must eventually hold its whole footprint at once
        length = req.tokens.shape[-1]
        need = self._blocks_needed(length, req.max_new)
        if need > self.num_blocks - 1:
            raise PoolFootprintError(
                f"request {req.rid}: needs {need} KV blocks "
                f"(prompt {length} + max_new {req.max_new} at "
                f"block_size {self.block_size}) but the pool holds only "
                f"{self.num_blocks - 1} allocatable blocks",
                rid=req.rid, required_blocks=need,
                available_blocks=self.num_blocks - 1)

    # ----------------------------------------------------------- admission
    def _resume_prompt(self, req: Request) -> np.ndarray:
        """Admission token view: the prompt, plus every token already
        generated for a request re-queued by preemption."""
        if not req.output:
            return req.tokens
        gen = np.asarray(req.output, req.tokens.dtype)[None]
        return np.concatenate([req.tokens, gen], axis=1)

    def _match_prefix(self, tokens: np.ndarray) -> list[tuple[int, bool]]:
        """Radix lookup of (block, is_suffix) pairs, capped so the last
        token is still prefilled (its logits seed generation) and the match
        ends on a chunk boundary as well as a block boundary (per-chunk
        activation quantization must see the chunks a fresh prefill would).
        Metrics are recorded by the caller on a successful admission only."""
        if self.radix is None:
            return []
        length = tokens.shape[-1]
        matched = self.radix.match_with_kinds(tokens.reshape(-1))
        align = math.lcm(self.block_size, self.chunk_size)
        max_match = (length - 1) // align * align
        return matched[:max_match // self.block_size]

    def _advance_admission(self):
        if self._adm is None:
            slot = self._free_slot()
            if not self.queue or slot is None:
                return
            req = self.queue[0]
            toks = self._resume_prompt(req)
            length = toks.shape[1]
            matched = self._match_prefix(toks)
            shared = [bid for bid, _ in matched]
            for bid in shared:                   # hold before any eviction
                self.pool_meta.acquire(bid)
            if self.reserve == "prompt":
                need_total = -(-length // self.block_size)
            else:
                need_total = self._blocks_needed(
                    length, req.max_new - len(req.output))
            blocks = self._alloc(need_total - len(shared))
            if blocks is None:
                # pool held by resident requests: stay queued
                for bid in shared:
                    self.pool_meta.release(bid)
                return
            self.queue.popleft()
            readmission = req.started_at != 0.0   # preempted earlier
            req.started_at = time.time()
            self.metrics.on_admit(req, n_prompt_tokens=length,
                                  resumed=readmission)
            start = len(shared) * self.block_size
            if self.tracer.enabled:
                self.tracer.instant(
                    "admit", "scheduler", track=self.trace_track,
                    rid=req.rid, slot=slot, prompt_tokens=length,
                    resumed=readmission, prefix_hit_tokens=start)
                # a re-admission continues the request's existing flow
                self.tracer.flow("t" if readmission else "s", req.rid,
                                 track=self.trace_track)
            if self.radix is not None:
                n_sfx = sum(1 for _, sfx in matched if sfx)
                self.metrics.on_prefix_lookup(
                    (len(shared) - n_sfx) * self.block_size, length,
                    suffix_tokens=n_sfx * self.block_size)
            debt = self._recompute_debt.pop(req.rid, 0)
            if debt:
                self.metrics.on_recompute(max(0, debt - start))
            owned = shared + blocks
            self._slot_blocks[slot] = owned
            self._slot_seq[slot] = self._seq_counter
            self._seq_counter += 1
            # the slot's live page-table row stays ZEROED until activation:
            # the interleaved decode steps write a dead KV row for every
            # not-yet-active slot, and those writes must land in the null
            # block, not in the blocks being prefilled.  Chunks use the
            # admission's private row.
            row = np.zeros((1, self.blocks_per_seq), np.int32)
            row[0, :len(owned)] = owned
            self._adm_row = row
            self._gauge()
            l_pad = bucket_length(length - start, self.chunk_size)
            padded = np.zeros((1, l_pad), np.int64)
            padded[:, :length - start] = toks[:, start:]
            self._adm = _Admission(req, slot, padded, length, start=start)
            self.slots[slot] = req               # reserve (done stays True)

        adm, c = self._adm, self.chunk_size
        start = adm.start
        chunk = torch.from_numpy(
            adm.tokens[:, adm.next_pos:adm.next_pos + c]).to(self.device)
        self.metrics.prefill_chunks += 1
        with self._span("prefill_chunk", rid=adm.req.rid,
                        pos=start + adm.next_pos):
            if self.tracer.enabled:
                self.tracer.flow("t", adm.req.rid, track=self.trace_track)
            logits, self.pool = self._profiled(
                "prefill_chunk", lambda: self.model.prefill_chunk_paged(
                    self.params, chunk, self.pool,
                    torch.from_numpy(self._adm_row).to(self.device),
                    start + adm.next_pos, self.kv_bits,
                    **self._shard_kw(self._admit_shard)))
        adm.next_pos += c
        if adm.next_pos >= adm.tokens.shape[1]:
            row = logits[0, (adm.length - 1 - start) % c]
            self._adm = None
            self._register_written(adm.req, adm.slot, adm.length)
            self._pt[adm.slot, :] = self._adm_row[0]
            self._activate(adm.req, adm.slot, None, row)

    def _alloc(self, n: int) -> list[int] | None:
        """Pool allocation with LRU radix eviction as the fallback; ``None``
        only when resident requests hold the pool.  Eviction drops FREEABLE
        leaves only (radix-only references)."""
        if n <= 0:
            return []
        if self._ledger is not None and not self._ledger.affords(self, n):
            # the lanes' shared byte budget is spent although this lane's
            # pool has room: reclaim freeable radix blocks across the lanes,
            # then re-check; a refusal acts as pool exhaustion (admission
            # waits, decode preempts within this lane)
            self._ledger.reclaim(self, n)
            if not self._ledger.affords(self, n):
                return None
        blocks = self.pool_meta.alloc(n)
        if blocks is None and self.radix is not None and len(self.radix):
            # an infeasible allocation must not strip the warm cache: the
            # radix blocks at refcount 1 bound what eviction can buy
            freeable = sum(1 for b in self.radix.blocks()
                           if self.pool_meta.refcount(b) == 1)
            if self.pool_meta.free_blocks + freeable < n:
                return None
            while blocks is None:
                dropped = self.radix.evict(
                    max(n - self.pool_meta.free_blocks, 1),
                    freeable_only=True)
                self.metrics.on_evictions(dropped)
                if dropped and self.tracer.enabled:
                    self.tracer.instant("evict", "kvcache",
                                        track=self.trace_track,
                                        blocks=dropped)
                if dropped == 0:
                    break
                blocks = self.pool_meta.alloc(n)
        return blocks

    def _gauge(self):
        """Refresh the pool-occupancy metrics, folding in the pool's own
        ``peak_used`` watermark (transient highs inside an
        allocate-then-preempt wave)."""
        self.metrics.on_kv_blocks(self.pool_meta.used_blocks,
                                  self.num_blocks - 1)
        self.metrics.kv_blocks_peak = max(self.metrics.kv_blocks_peak,
                                          self.pool_meta.peak_used)
        if self.tracer.enabled:
            self.tracer.counter("kv_blocks", "kvcache",
                                track=self.trace_track,
                                in_use=self.pool_meta.used_blocks,
                                total=self.num_blocks - 1)

    def _register_written(self, req: Request, slot: int, n_written: int):
        """Publish the full blocks of the first ``n_written`` positions of
        (prompt + generated) to the radix tree; blocks past the original
        prompt register as kind ``suffix``."""
        if self.radix is None:
            return
        toks = self._resume_prompt(req).reshape(-1)[:n_written]
        n_prompt = req.tokens.shape[1] // self.block_size
        full = n_written // self.block_size
        if full:
            self.radix.insert(toks, self._slot_blocks[slot][:full],
                              suffix_from=n_prompt)

    def _join_slot(self, slot: int, one_cache):
        pass                  # prefill chunks already wrote the slot's blocks

    def _admit_full(self):
        raise NotImplementedError(
            "paged serving always admits through chunked prefill")

    # ------------------------------------------------------------- decode
    def _pre_decode(self):
        """Dynamic allocation: hand every active slot crossing a block
        boundary one fresh block before the batched step.  On exhaustion,
        preempt latest-admitted-first, but never a request admitted before
        the one asking, so the earliest-admitted request always advances."""
        if self.reserve != "prompt":
            return
        order = sorted((i for i in range(self.n_slots)
                        if not self.done[i] and self.slots[i] is not None),
                       key=lambda i: self._slot_seq[i])
        moved = False
        for i in order:
            if self.done[i]:                # preempted by an earlier slot
                continue
            self.stalled[i] = False
            b_idx = int(self.pos[i]) // self.block_size
            if self._pt[i, b_idx] != 0:
                continue
            blk = self._alloc(1)
            while blk is None:
                victim = self._lowest_priority_after(int(self._slot_seq[i]))
                if victim is None or self.preemption != "recompute":
                    break
                self._preempt(victim)
                moved = True
                blk = self._alloc(1)
            if blk is None:
                if self.preemption == "recompute":
                    # the asking slot is itself the lowest priority left
                    self._preempt(("slot", i))
                    moved = True
                else:
                    self.stalled[i] = True
                    if self.tracer.enabled:
                        self.tracer.instant(
                            "stall", "scheduler", track=self.trace_track,
                            rid=self.slots[i].rid, slot=i)
                continue
            self._slot_blocks[i].append(blk[0])
            self._pt[i, b_idx] = blk[0]
            moved = True
        if moved:
            self._gauge()
        if self.preemption != "recompute":
            active = [i for i in range(self.n_slots)
                      if not self.done[i] and self.slots[i] is not None]
            if active and all(self.stalled[i] for i in active) \
                    and self._adm is None:
                raise RuntimeError(
                    f"pool deadlock: all {len(active)} active slots are "
                    "stalled on block allocation and nothing can release "
                    "(preemption='off'); use preemption='recompute' or a "
                    "larger pool")

    def _lowest_priority_after(self, seq: int):
        """The preemption victim for a request admitted at ``seq``: the
        mid-flight admission if any, else the latest-admitted active slot —
        only ever one admitted strictly after ``seq``."""
        if self._adm is not None:
            return ("adm", self._adm)
        best = None
        for j in range(self.n_slots):
            if self.done[j] or self.slots[j] is None:
                continue
            if self._slot_seq[j] > seq and (
                    best is None or self._slot_seq[j] > self._slot_seq[best]):
                best = j
        return None if best is None else ("slot", best)

    def _preempt(self, victim):
        """Release a victim back to the queue head: register its computed
        full blocks, drop its references, zero its live page-table row, and
        re-queue it with its stream intact."""
        kind, v = victim
        if kind == "adm":
            req, slot = v.req, v.slot
            n_written = min(v.start + v.next_pos, v.length)
            self._adm = None
        else:
            slot = v
            req = self.slots[slot]
            n_written = int(self.pos[slot])   # decode wrote [0, pos)
        self._register_written(req, slot, n_written)
        self._recompute_debt[req.rid] = n_written
        for bid in self._slot_blocks[slot] or ():
            self.pool_meta.release(bid)
        self._slot_blocks[slot] = None
        self._pt[slot, :] = 0               # dead decode writes -> null block
        self._requeue(req, slot)
        self.metrics.on_preempt(req)
        if self.tracer.enabled:
            self.tracer.instant("preempt", "scheduler",
                                track=self.trace_track, rid=req.rid,
                                slot=slot, n_written=n_written)
            self.tracer.flow("t", req.rid, track=self.trace_track)
        self._gauge()

    def _occupancy_bucket(self, n_live: int) -> int:
        """Decode batch for ``n_live`` live slots: the smallest power of two
        >= n_live, capped at n_slots."""
        b = 1
        while b < n_live:
            b *= 2
        return min(b, self.n_slots)

    def _occupancy_buckets(self) -> tuple[int, ...]:
        """Every decode batch the ragged dispatch can run."""
        return tuple(sorted({self._occupancy_bucket(n)
                             for n in range(1, self.n_slots + 1)}))

    def _slot_map(self, live: list[int]) -> np.ndarray:
        """The decode step's rows: the live slots padded to their occupancy
        bucket by repeating the last one (a duplicate row recomputes
        identical values and rewrites its KV row with identical bytes), or
        every slot without ragged decode."""
        if not self._ragged:
            return np.arange(self.n_slots)
        sm = list(live)
        sm += [sm[-1]] * (self._occupancy_bucket(len(sm)) - len(sm))
        return np.asarray(sm)

    def _step_rows(self, model, params, live: list[int], tokens: np.ndarray,
                   pos: np.ndarray):
        """One decode step of ``model`` over the rows of the slot map:
        tokens, positions and page-table rows gathered on the host and
        copied to the device at once.  Returns (slot map, compact (L, V)
        logits)."""
        sm = self._slot_map(live)
        host = np.concatenate([self._pt[sm], tokens[sm], pos[sm, None]],
                              axis=1).astype(np.int32)
        dev = torch.from_numpy(host).to(self.device)
        nb = self.blocks_per_seq
        pt, tok, p = dev[:, :nb].contiguous(), dev[:, nb:nb + 1], dev[:, nb + 1]
        logits, self.pool = model.decode_step_paged(
            params, tok, self.pool, pt, p, self.kv_bits, fused=self._fused,
            **self._shard_kw(self._admit_shard))
        return sm, logits[:, 0]

    def _dispatch_decode(self, live: list[int]) -> np.ndarray:
        """One decode step over the rows of the slot map, the next tokens
        selected on the device from the compact logits (each row under its
        slot's request) and copied back.  Returns the (n_slots,) next-token
        vector (rows outside the slot map keep their previous token)."""
        sm, lg = self._step_rows(self.model, self.params, live, self.tokens,
                                 self.pos)
        nxt = self.tokens[:, 0].copy()
        rows = [self.slots[i] if i in live else None for i in sm]
        nxt[sm] = select_tokens(lg, lg.argmax(dim=-1), rows).cpu().numpy()
        return nxt

    def _tick(self):
        if not self.tick:
            return
        active = sum(1 for i in range(self.n_slots)
                     if self.slots[i] is not None and not self.done[i])
        self.metrics.on_step(
            len(self.queue) + (1 if self._adm is not None else 0),
            pool_in_use=self.pool_meta.used_blocks,
            pool_total=self.num_blocks - 1, active=active)

    # -------------------------------------------- self-speculative decode
    def _extend_windows(self) -> np.ndarray:
        """Back each active slot's draft window where blocks are free:
        positions ``pos .. pos + draft_k`` need resident blocks for the
        window's KV writes to land (an unbacked position's write deflects
        to the null block).  Never preempts: a short window only means
        fewer drafts.  Returns the per-slot usable draft count (0: plain
        decode for that slot, row 0 of the window being the sequential
        step)."""
        limits = np.zeros(self.n_slots, np.int32)
        for i in range(self.n_slots):
            req = self.slots[i]
            if req is None or self.done[i] or self.stalled[i]:
                continue
            p = int(self.pos[i])
            # cap by the sequence budget (decode retires at s_max-1) and the
            # request's remaining tokens
            lim = min(self.spec_k, self.s_max - 1 - p,
                      req.max_new - len(req.output) - 1)
            if lim <= 0:
                continue
            b0, b_last = p // self.block_size, (p + lim) // self.block_size
            for b in range(b0 + 1, min(b_last, self.blocks_per_seq - 1) + 1):
                if self._pt[i, b] != 0:
                    continue
                blk = self._alloc(1)
                if blk is None:
                    break
                self._slot_blocks[i].append(blk[0])
                self._pt[i, b] = blk[0]
            bb = b0
            while bb < b_last and bb + 1 < self.blocks_per_seq \
                    and self._pt[i, bb + 1] != 0:
                bb += 1
            limits[i] = min(lim, (bb + 1) * self.block_size - 1 - p)
        if limits.any():
            self._gauge()
        return limits

    def _spec_round(self, limits: np.ndarray):
        """One draft/verify round in place of the batched decode step.

        The draft variant decodes up to ``limits[i]`` tokens for slot i, one
        ragged step at a time, into the same pool; then one windowed
        decode of the float weights over (last token, drafts) of every slot
        rewrites the KV of each window position and gives the float model's
        next-token logits after each prefix.  Emission accepts the longest
        draft prefix those tokens confirm, so every emitted token is the
        sequential step's; KV left past the acceptance point is rewritten by
        the next window before a query attends to it, or causally masked."""
        w = self.spec_k + 1
        base_pos = self.pos.copy()
        window = np.zeros((self.n_slots, w), np.int64)
        window[:, 0] = self.tokens[:, 0]
        toks = self.tokens.copy()
        n_draft = int(limits.max(initial=0))
        with self._span("draft", rounds=n_draft):
            for j in range(n_draft):
                live = [i for i in range(self.n_slots) if limits[i] > j]
                sm, lg = self._step_rows(self._draft_model,
                                         self._draft_params, live, toks,
                                         base_pos + j)
                toks[sm, 0] = lg.argmax(dim=-1).cpu().numpy()
                window[:, j + 1] = toks[:, 0]
        with self._span("verify"):
            def verify():
                dev = torch.from_numpy(np.concatenate(
                    [self._pt, window, base_pos[:, None]], axis=1)).to(
                        self.device)
                nb = self.blocks_per_seq
                logits, self.pool = self.model.decode_window_paged(
                    self.params, dev[:, nb:nb + w], self.pool,
                    dev[:, :nb].to(torch.int32), dev[:, nb + w], self.kv_bits)
                return logits, logits.argmax(dim=-1).cpu().numpy()
            logits, greedy = self._profiled("verify", verify)
        self.metrics.decode_steps += 1
        drafted = accepted = 0
        for i, req in enumerate(self.slots):
            if req is None or self.done[i] or self.stalled[i]:
                continue
            lim = int(limits[i])
            drafted += lim
            j = 0
            while True:
                tok = int(greedy[i, j]) if req.temperature <= 0.0 \
                    else self._sample(req, logits[i, j])
                self.metrics.decode_slot_tokens += 1
                self.pos[i] += 1
                full = (len(req.output) + 1 >= req.max_new
                        or (req.eos_id is not None and tok == req.eos_id)
                        or self.pos[i] >= self.s_max - 1)
                self._emit(req, tok, full)
                if full:
                    self._finish(req, i)
                    accepted += j
                    break
                if j < lim and int(window[i, j + 1]) == tok:
                    # the draft predicted this token: the next window row
                    # already holds the float model's continuation
                    j += 1
                    continue
                self.tokens[i, 0] = tok
                accepted += j
                break
        self.metrics.on_spec_round(drafted, accepted)
        if self.tracer.enabled:
            self.tracer.instant("spec_round", "scheduler",
                                track=self.trace_track,
                                drafted=drafted, accepted=accepted)

    def _step_impl(self):
        if not self.spec:
            return super()._step_impl()
        self._tick()
        self._advance_admission()
        if not all(self.done):
            self._pre_decode()
        if not all(self.done):
            self._spec_round(self._extend_windows())
        finished, self._just_finished = self._just_finished, []
        return finished

    # -------------------------------------------------------------- finish
    def _release_slot(self, req: Request, slot: int):
        # decode wrote [0, L + g - 1): the final emitted token's KV was
        # never written (the loop ends before feeding it)
        self._register_written(
            req, slot, req.tokens.shape[1] + len(req.output) - 1)
        for bid in self._slot_blocks[slot] or ():
            self.pool_meta.release(bid)
        self._slot_blocks[slot] = None
        self._pt[slot, :] = 0               # dead decode writes -> null block
        self._gauge()

    # ---------------------------------------------------------- invariants
    # --------------------------------------------------------------- audit
    def audit_steps(self, backend: str | None = None) -> list:
        """The paged step functions for the contract checker, under the
        reference's names: ``paged:decode`` (every slot's row, as a
        decode step without ragged occupancy runs) and ``paged:chunk`` over
        a scratch copy of the block pool, ``paged:draft_decode`` and
        ``paged:verify`` when speculation is on, and ``paged:select``.  The
        fused single-dispatch contract binds where the fused kernel runs:
        fused wiring, the ``cuda`` contract, float weights (a quantized
        ``wo`` takes the engine's two-dispatch composition)."""
        from repro_torch.analysis.report import StepSpec
        from repro_torch.core.precision import (A_FLOAT, W_FLOAT,
                                                get_precision, signed)
        flags = self._audit_flags(backend)
        dev, n, nb = self.device, self.n_slots, self.blocks_per_seq
        pt = torch.from_numpy(self._pt).to(dev)
        pos = torch.from_numpy(self.pos.astype(np.int32)).to(dev)
        toks = torch.from_numpy(self.tokens).to(dev)
        kw_shard = self._shard_kw(self._admit_shard)
        pcfg = signed(get_precision(self.model.cfg.precision))
        fused_layers = self.model.cfg.n_layers \
            if (self._fused and flags["backend"] == "cuda"
                and pcfg.w_mode == W_FLOAT) else None

        def paged_decode(model, fused):
            def fn(p, t, pool, table, ps, **kw):
                return model.decode_step_paged(p, t, pool, table, ps,
                                               self.kv_bits, fused=fused,
                                               **kw_shard, **kw)
            return fn
        m = self.model
        steps = [
            StepSpec(name="paged:decode",
                     fn=paged_decode(m, self._fused),
                     args=(self.params, toks, self._scratch(self.pool), pt,
                           pos),
                     inplace=(2,), fused_layers=fused_layers, **flags),
            StepSpec(name="paged:chunk",
                     fn=lambda p, t, pool, row, start, **kw:
                     m.prefill_chunk_paged(p, t, pool, row, start,
                                           self.kv_bits, **kw_shard, **kw),
                     args=(self.params,
                           torch.zeros((1, self.chunk_size),
                                       dtype=torch.int64, device=dev),
                           self._scratch(self.pool),
                           # the admission's page-table row shape (writes
                           # land in the null block under an all-zero row)
                           torch.zeros((1, nb), dtype=torch.int32,
                                       device=dev), 0),
                     inplace=(2,), **flags),
        ]
        if self.spec:
            draft = signed(get_precision(self.draft_precision))
            draft_flags = dict(
                flags, quantized_weights=draft.w_mode != W_FLOAT,
                quantized_acts=draft.w_mode != W_FLOAT
                and draft.a_mode != A_FLOAT and draft.a_bits <= 8)
            steps.append(StepSpec(
                name="paged:draft_decode",
                fn=paged_decode(self._draft_model, self._fused),
                args=(self._draft_params, toks, self._scratch(self.pool), pt,
                      pos),
                inplace=(2,), **draft_flags))
            w = self.spec_k + 1
            steps.append(StepSpec(
                name="paged:verify",
                fn=lambda p, win, pool, table, ps, **kw:
                m.decode_window_paged(p, win, pool, table, ps, self.kv_bits,
                                      **kw),
                args=(self.params,
                      torch.zeros((n, w), dtype=torch.int64, device=dev),
                      self._scratch(self.pool), pt, pos),
                inplace=(2,), **flags))
        steps.append(self._select_audit_step("paged:select", flags, n))
        return steps

    def check_pool(self):
        """Cross-check the pool against every live holder (the slots' and
        the mid-flight admission's block lists, plus the radix tree)."""
        self.pool_meta.check(
            (blocks for blocks in self._slot_blocks if blocks),
            self.radix.blocks() if self.radix is not None else ())
