"""Continuous-batching serving scheduler with chunked prefill — the dense
``ContinuousBatcher`` of ``repro.runtime.serving``.

  * a request queue; admission at prefill-*chunk* granularity — prompts
    pad up to a multiple of the chunk size and are admitted one chunk per
    scheduler step, interleaved with the batched decode of the running
    requests (or whole-prompt admission with ``chunk_size=0``);
  * fixed-capacity decode slots over one (n_slots, s_max) cache, built once
    on the device and reused: an admitted request's cache is copied into its
    slot (:func:`write_slot`);
  * per-slot sampling: greedy by default (the argmax taken on the device,
    so that only the (n_slots,) next-token vector crosses to the host each
    step), temperature/top-k through :func:`sample_core` with noise drawn
    per (seed, rid, token index);
  * per-token streaming callbacks (``RequestOptions.on_token``) and
    EOS/budget handling;
  * latency accounting per request (queue / TTFT / inter-token) by
    :class:`repro_torch.runtime.metrics.Metrics`, and the flight recorder
    (``ServingConfig.trace``: :mod:`.tracing` spans, instants and flows,
    :class:`.profile.StepProfiler` around each step call).

Over a mesh (``ServingConfig.mesh``, a mesh of ranks from
``launch.mesh``; every rank runs this same host loop on the same requests)
the batcher is SPMD, as the reference's sharded batcher:

  * **pure DP** (``parallel.sharding.pure_dp``: d_model < 1024 or
    ``force_pure_dp``): params replicated; the slot cache and the decode
    batch split over ``_batch_axes(cfg, mesh, n_slots)``; the admission
    prefill and chunks run replicated on every rank and only the slot's
    owner copies the result into its local slot cache; each rank decodes
    its local slots and the next-token vector is all-gathered, so every
    rank's scheduler holds the same state and makes the same decisions
    (where no axis set divides the slots, decode runs replicated);
  * **TP**: params cut by ``param_specs`` (heads, FFN hidden, experts and
    vocabulary over 'model'), the caches' KV heads over 'model', the decode
    batch over the data axes; column-parallel projections yield local
    heads, row-parallel ones end in an all-reduce (``models.layers``).

Exactness contract: greedy generations equal isolated sequential runs for
attention-only stacks with dense FFNs, and the same schedule gives the same
streams as the JAX package's batcher — on any mesh at integer activations
(per-row scales, exact integer partial sums), within float rounding at
float activations under TP (partial sums in another order).  SSM and
hybrid stacks take whole-prompt admission (padding tokens would pollute
the recurrent state).
An MoE layer's expert capacity depends on the rows of the call (dead
decode slots included), so its streams depend on the schedule as the
reference's do.

Sampling contract.  The draw is split in two.  :func:`sample_core` is the
deterministic part: given the logits and one (V,) Gumbel noise row per
sampled row, it returns the reference's ``_sample_rows`` token bit for bit
(``jax.random.categorical(key, z)`` is ``argmax(z + gumbel(key))``), so fed
the reference's own ``jax.random.gumbel`` noise it reproduces the
reference's streams.  The noise is the port's own (:func:`gumbel_noise`):
torch cannot reproduce ``jax.random``'s bits, so each sampled row draws
from a ``torch.Generator`` on the batcher's device seeded only by
:func:`noise_seed` (seed, rid, n_out), a fixed 64-bit mix.  A stream
therefore does not depend on batch shape, occupancy, slot, or dense against
paged serving, and it reproduces from (seed, rid, n_out); it differs from
the reference's stream, and a stream on the card differs from the same
request's stream on the CPU (their generators differ).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque
from collections.abc import Callable
from typing import Any

import numpy as np
import torch

from .errors import EmptyPromptError, InvalidBudgetError, PromptTooLongError
from .metrics import Metrics
from .profile import StepProfiler, sync
from .tracing import Tracer


@dataclasses.dataclass
class RequestOptions:
    """Per-request options, with the reference's names and defaults.
    ``slo`` names the service tier the adaptive server routes by (the plain
    batchers ignore it)."""
    max_new: int = 16
    eos_id: int | None = None
    # sampling: temperature <= 0 -> greedy; top_k 0 -> full distribution
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0
    # service tier for SLO-routed adaptive serving (runtime.adaptive)
    slo: str = "standard"
    # per-token streaming: called as on_token(req, token, finished)
    on_token: Callable[["Request", int, bool], None] | None = None


@dataclasses.dataclass
class ServingConfig:
    """Batcher configuration: the reference's ``ServingConfig`` fields but
    its prompt length, with its names and defaults.  The paged
    fields (``kv_bits`` .. ``ragged_decode``) are read by
    :class:`repro_torch.runtime.kvcache.PagedBatcher` and ignored by
    :class:`ContinuousBatcher`; the adaptive fields (``slo_classes`` ..
    ``draft_k``) are read by :class:`repro_torch.runtime.adaptive.
    AdaptiveServer` and, for speculative decoding, by the paged batcher."""
    n_slots: int = 8
    s_max: int = 128
    chunk_size: int | None = None      # None -> min(32, s_max), or 0 (whole
                                       # prompts) where chunks are refused
    # pre-tune the kernel choice of every matmul shape class the batcher
    # dispatches (kernels.tuning; persists, so serving only looks up)
    autotune: bool = False
    # a mesh of ranks (launch.mesh.make_mesh in a process group, or a rank
    # of launch.mesh.spawn): serve SPMD over it; None: one device
    mesh: Any = None
    # ---- paged KV cache (PagedBatcher) ----------------------------------
    kv_bits: int = 16
    block_size: int = 16
    num_blocks: int | None = None
    pool_bytes: int | None = None
    prefix_cache: bool = True
    reserve: str = "prompt"
    preemption: str = "recompute"
    # one engine dispatch per decode layer for attention + wo (False: the
    # two-dispatch layer), over live slots bucketed to power-of-two
    # occupancy (ragged_decode=False pads to the full (n_slots, 1) batch)
    fused_decode: bool = True
    ragged_decode: bool = True
    # ---- adaptive precision serving (AdaptiveServer / speculative) ------
    slo_classes: dict[str, Any] | None = None   # name -> policy.SLOClass
    brownout: bool = False
    brownout_policy: Any = None                 # policy.BrownoutPolicy
    speculative: bool = False
    draft_precision: str | None = "2xT"         # PAPER_CONFIGS key
    draft_k: int = 3
    # ---- observability (runtime.tracing flight recorder) ----------------
    # a tracing.TraceConfig (or None): structured event tracing, periodic
    # metrics snapshots, and per-step device/host profiling
    trace: Any = None


class Request:
    """One generation request: prompt tokens (1, S) + options.  Timing
    fields are filled by the scheduler."""

    def __init__(self, rid: int, tokens: np.ndarray,
                 options: RequestOptions | None = None):
        self.rid = rid
        self.tokens = tokens
        self.options = options if options is not None else RequestOptions()
        self.submitted_at = 0.0
        self.started_at = 0.0
        self.first_token_at = 0.0
        self.last_token_at: float | None = None
        self.finished_at = 0.0
        self.output: list[int] = []
        # the ladder rung the adaptive server routed this request to
        self.routed_rung: int | None = None

    @property
    def max_new(self) -> int:
        return self.options.max_new

    @property
    def eos_id(self) -> int | None:
        return self.options.eos_id

    @property
    def temperature(self) -> float:
        return self.options.temperature

    @property
    def top_k(self) -> int:
        return self.options.top_k

    @property
    def seed(self) -> int:
        return self.options.seed

    @property
    def slo(self) -> str:
        return self.options.slo

    @property
    def on_token(self):
        return self.options.on_token


@dataclasses.dataclass
class _Admission:
    """One request mid-chunked-prefill (its cache is not yet slot-resident)."""
    req: Request
    slot: int
    tokens: np.ndarray                 # (1, L_pad) bucket-padded prompt tail
    length: int                        # true prompt length L
    next_pos: int = 0                  # next chunk start (relative to start)
    start: int = 0                     # first position to prefill (> 0 when a
                                       # radix prefix-cache hit covers [0, start))


def supports_chunked_prefill(cfg) -> bool:
    """Chunk admission preserves exactness only when no recurrent state
    crosses padded positions: attention-only layer stacks over token ids."""
    from repro_torch.models.transformer import attention_only
    return (getattr(cfg, "kind", "") == "lm"
            and getattr(cfg, "frontend", "none") == "none"
            and attention_only(cfg))


def bucket_length(length: int, chunk: int) -> int:
    """Pad a prompt length up to the next chunk multiple (its shape bucket)."""
    return -(-length // chunk) * chunk


# ---------------------------------------------------------------------------
# next-token selection: the deterministic core and the port's noise source
# ---------------------------------------------------------------------------
_M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def noise_seed(seed: int, rid: int, n_out: int) -> int:
    """The generator seed of one sampled token: (seed, rid, n_out) folded
    through splitmix64's finalizer, one word at a time (a fixed function of
    the three numbers alone, 0 <= result < 2**64)."""
    h = 0
    for word in (seed, rid, n_out):
        h = _splitmix64(h ^ (int(word) & _M64))
    return h


def gumbel_noise(seed: int, rid: int, n_out: int, vocab: int,
                 device: torch.device) -> torch.Tensor:
    """(vocab,) f32 standard Gumbel noise for the token ``n_out`` of request
    ``rid``, drawn on ``device`` from a generator seeded by
    :func:`noise_seed`: ``-log(-log(u))`` with ``u`` uniform in
    [tiny, 1), as ``jax.random.gumbel`` forms it.  The CPU's and the card's
    generators give different bits for one seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(noise_seed(seed, rid, n_out))
    u = torch.rand(vocab, generator=gen, device=device, dtype=torch.float32)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample_core(logits: torch.Tensor, greedy: torch.Tensor,
                temps: torch.Tensor, topks: torch.Tensor,
                gumbel: torch.Tensor) -> torch.Tensor:
    """Next token of every row of (R, V) ``logits`` — the deterministic part
    of the reference's ``_sample_rows``, row for row:

      1. ``z`` = f32 logits / T, with T <= 0 taken as 1;
      2. where k > 0, every ``z`` below the k-th largest (index
         ``clip(k, 1, V) - 1`` of a descending sort) becomes -inf;
      3. ``argmax(z + gumbel)``, or the row's ``greedy`` token where T <= 0.

    ``greedy`` (R,), ``temps`` (R,) f32, ``topks`` (R,) int and ``gumbel``
    (R, V) f32 lie on the logits' device.  Both ``torch.argmax`` and
    ``jnp.argmax`` return the first of equal maxima."""
    z = logits.to(torch.float32) / torch.where(
        temps <= 0.0, torch.ones_like(temps), temps)[:, None]
    v = z.shape[-1]
    idx = (topks.clamp(1, v) - 1).to(torch.int64)[:, None]
    kth = torch.sort(z, dim=-1, descending=True).values.gather(-1, idx)
    z = torch.where((topks > 0)[:, None] & (z < kth),
                    torch.full_like(z, float("-inf")), z)
    samp = torch.argmax(z + gumbel, dim=-1)
    return torch.where(temps <= 0.0, greedy.to(samp.dtype), samp)


def select_tokens(logits: torch.Tensor, greedy: torch.Tensor,
                  reqs: list) -> torch.Tensor:
    """Next token of every row of (R, V) ``logits``: ``reqs[r]`` is the
    request row ``r`` decodes for (``None`` for a dead row).  Rows of greedy
    requests (and dead rows) keep ``greedy``, the argmax taken on the
    device; sampled rows go through :func:`sample_core` with their own
    :func:`gumbel_noise`, drawn on the logits' device.  With no sampled row
    nothing but ``greedy`` is touched."""
    sampled = [r for r, req in enumerate(reqs)
               if req is not None and req.temperature > 0.0]
    if not sampled:
        return greedy
    dev, (n_rows, vocab) = logits.device, logits.shape
    temps = np.zeros(n_rows, np.float32)
    topks = np.zeros(n_rows, np.int64)
    noise = torch.zeros((n_rows, vocab), dtype=torch.float32, device=dev)
    for r in sampled:
        req = reqs[r]
        temps[r], topks[r] = req.temperature, req.top_k
        noise[r] = gumbel_noise(req.seed, req.rid, len(req.output), vocab,
                                dev)
    return sample_core(logits, greedy, torch.from_numpy(temps).to(dev),
                       torch.from_numpy(topks).to(dev), noise)


def write_slot(cache, one, i: int) -> None:
    """Copy a batch-1 cache ``one`` into slot ``i`` of the slot cache, in
    place.  KV leaves are (periods, B, S, ...): the admission cache may be
    longer than the slot cache, so its sequence axis is cut first.  A Mamba
    layer's ``conv`` / ``ssm`` leaves have no sequence axis: their axis 2 is
    the same length in both caches, so the cut copies them whole."""
    for name, c in cache.items():
        if one.get(name) is None:
            # the reference's tree-mapped write refuses the same tree
            raise ValueError(
                f"admission cache has no {name!r}: a one-position prompt "
                "returns no recurrent state (reference rule)")
        if isinstance(c, dict):
            write_slot(c, one[name], i)
        else:
            s = min(c.shape[2], one[name].shape[2])
            c[:, i:i + 1, :s] = one[name][:, :, :s]


class ContinuousBatcher:
    """Slot-based continuous batching: chunked (or whole-prompt) prefill
    interleaved with batched decode, on the device of the params.  Stacks
    with a Mamba layer admit whole prompts only."""

    # over a mesh, split the decode batch over the batch axes (the paged
    # batcher's pool cannot split: its steps run on every row)
    _split_rows = True

    def __init__(self, model, params, config: ServingConfig, *,
                 metrics: Metrics | None = None, tracer: Tracer | None = None):
        if not isinstance(config, ServingConfig):
            raise TypeError(f"config must be a ServingConfig, got "
                            f"{type(config).__name__}")
        self.config = config
        self.model = model
        self.params = params
        self.device = params["embed"]["w"].device
        self.n_slots = n_slots = config.n_slots
        self.s_max = s_max = config.s_max
        self.mesh = config.mesh
        cfg = model.cfg
        # the StepSharding of admission calls (rows replicated) and of the
        # decode step, and the global slots this rank decodes
        self._admit_shard = self._decode_shard = None
        self._local = range(n_slots)
        if self.mesh is not None:
            self._shard_params(cfg, self.mesh)
        chunk_size = config.chunk_size
        chunkable = supports_chunked_prefill(cfg)
        if chunk_size is None:
            chunk_size = min(32, s_max) if chunkable else 0
        if chunk_size and not chunkable:
            raise ValueError(
                f"{cfg.name}: chunked prefill needs an attention-only token "
                "LM (recurrent state cannot cross padded chunk positions); "
                "pass chunk_size=0 for whole-prompt admission")
        self.chunk_size = int(chunk_size)
        # the admission cache is rounded up so every chunk call is full-size
        self.s_adm = (bucket_length(s_max, self.chunk_size)
                      if self.chunk_size else s_max)
        # the tuning-cache entries this batcher's autotune swept or found
        self.tuned: list[dict] = []
        if config.autotune:
            # every matmul shape class of the chunk prefill and the decode
            # step, so the serving loop only ever hits the cache (whole
            # prompts vary in length: s_max stands for them)
            self.tuned = self._autotune(cfg, (), self.chunk_size or s_max)

        self._adm_cache = None             # reused (1, s_adm) admission cache
        self.metrics = metrics if metrics is not None else Metrics(n_slots)
        # flight recorder: host-side only, around the model's step calls
        # (the adaptive server passes one tracer shared by its lanes, each
        # on its own track)
        self.tracer = Tracer.from_config(config.trace) if tracer is None \
            else tracer
        self.trace_track = "scheduler"
        self.profiler = StepProfiler(self.tracer) \
            if getattr(config.trace, "profile", False) else None
        # per-step controller-signal sample (the adaptive server turns this
        # off in its lanes and takes one consolidated sample itself)
        self.tick = True
        self.queue: deque[Request] = deque()
        self.slots: list[Request | None] = [None] * n_slots
        self.pos = np.zeros(n_slots, np.int64)
        self.done = np.ones(n_slots, bool)
        # slots paused by the paged batcher (block-pool exhaustion with
        # preemption off): they stay out of the decode step's live set
        self.stalled = np.zeros(n_slots, bool)
        self.tokens = np.zeros((n_slots, 1), np.int64)
        self._adm: _Admission | None = None
        self._just_finished: list[Request] = []
        self._build_runtime(cfg)

    def _shard_params(self, cfg, mesh):
        """Over a mesh: cut the params to this rank's slices (replicated
        under pure DP) on the rank's device, and set the calls' shardings
        and the local slots."""
        from repro_torch.parallel import sharding as shd
        from repro_torch.parallel.comm import StepSharding
        from repro_torch.tree import tree_map
        tp = None if shd.pure_dp(cfg, mesh) else mesh.axis("model")
        if mesh.device is not None:
            self.device = mesh.device
        self.params = tree_map(
            lambda t: t.to(self.device),
            shd.shard_tree(self.params,
                           shd.param_specs(self.params, cfg, mesh), mesh))
        baxes = shd._batch_axes(cfg, mesh, self.n_slots) \
            if self._split_rows else None
        rows = mesh.axis(baxes) if baxes else None
        if tp is not None or rows is not None:
            self._admit_shard = StepSharding(mesh, tp=tp)
            self._decode_shard = StepSharding(mesh, tp=tp, rows=rows)
        if rows is not None:
            n_loc = self.n_slots // rows.size
            self._local = range(rows.index * n_loc, (rows.index + 1) * n_loc)

    @staticmethod
    def _shard_kw(shard) -> dict:
        """The ``shard`` keyword of a model call (none on one device)."""
        return {} if shard is None else {"shard": shard}

    def _autotune(self, cfg, extra_m, chunk_size: int) -> list[dict]:
        """Tune the batcher's shape classes (with a mesh: the ranks' local
        shapes too).  Over a mesh only rank 0 sweeps and writes the tuning
        cache; the other ranks wait for it and read the file."""
        from repro_torch.core.precision import get_precision, signed
        from repro_torch.kernels import engine, tuning
        mesh = self.mesh
        tuned = []
        if mesh is None or mesh.rank == 0:
            tuned = engine.tune_serving_shapes(
                cfg, signed(get_precision(cfg.precision)),
                n_slots=self.n_slots, chunk_size=chunk_size, extra_m=extra_m,
                device=self.device, mesh=mesh)
        if mesh is not None and mesh.size > 1:
            mesh.barrier()
            if mesh.rank != 0:
                tuning.reset(clear_stats=False)
        return tuned

    def _build_runtime(self, cfg):
        """KV state construction: one (n_slots, s_max) slot cache.  The
        paged batcher overrides this with a block pool + page tables."""
        from repro_torch.models import transformer as tfm
        self._make_cache = lambda b, s: tfm.make_cache(cfg, b, s, self.device,
                                                       mesh=self.mesh)
        self.cache = self._make_cache(self.n_slots, self.s_max)

    # ---------------------------------------------------------------- steps
    @contextlib.contextmanager
    def _span(self, name: str, **args):
        """A ``name`` span on this batcher's track (nothing when the tracer
        is off); an exception inside still closes it and propagates."""
        tr = self.tracer
        if not tr.enabled:
            yield
            return
        tr.begin(name, "scheduler", track=self.trace_track, **args)
        try:
            yield
        finally:
            tr.end(name, "scheduler", track=self.trace_track)

    def _profiled(self, label: str, call):
        """``call()``, bracketed by the profiler when one is on, with the
        device synced inside the bracket."""
        if self.profiler is None:
            return call()
        with self.profiler.step(label):
            out = call()
            sync(self.device)
        return out

    def _dispatch_decode(self, live: list[int]) -> np.ndarray:
        """One batched decode step and the next-token selection on the
        device; returns the (n_slots,) next tokens through the step's only
        device->host copy.  Over a mesh whose batch axes split the slots,
        the step runs this rank's slots and the next tokens are
        all-gathered."""
        lo, hi = self._local.start, self._local.stop
        tok = torch.from_numpy(self.tokens[lo:hi]).to(self.device)
        pos_t = torch.from_numpy(self.pos[lo:hi]).to(self.device)
        shard = self._decode_shard
        logits, self.cache = self.model.decode_step(
            self.params, tok, self.cache, pos_t, **self._shard_kw(shard))
        lg = logits[:, 0]
        rows = [self.slots[i] if i in live else None for i in self._local]
        nxt = select_tokens(lg, lg.argmax(dim=-1), rows)
        if shard is not None and shard.rows is not None:
            nxt = shard.rows.all_gather(nxt)
        return nxt.cpu().numpy()

    def _decode_call(self, live: list[int]) -> np.ndarray:
        """The decode step of the live slots inside the ``decode`` span and
        the profiler's bracket; returns the (n_slots,) next tokens (dead
        and stalled rows carry no meaning)."""
        with self._span("decode"):
            return self._profiled("decode",
                                  lambda: self._dispatch_decode(live))

    # ---------------------------------------------------------------- submit
    def _validate(self, req: Request):
        """Admission validation; raises a typed AdmissionError subclass."""
        if req.tokens.size == 0 or req.tokens.shape[-1] < 1:
            raise EmptyPromptError(
                f"request {req.rid}: empty prompt (0 tokens); prompts must "
                "contain at least one token", rid=req.rid)
        if req.max_new < 1:
            raise InvalidBudgetError(
                f"request {req.rid}: max_new={req.max_new} must be >= 1 "
                "(the first token is sampled from the prefill logits, so "
                "every admitted request emits at least one token)",
                rid=req.rid, max_new=req.max_new)
        length = req.tokens.shape[-1]
        if length >= self.s_max:
            raise PromptTooLongError(
                f"request {req.rid}: prompt length {length} needs s_max > "
                f"{length} (got {self.s_max}); the cache budget admits "
                f"prompts up to {self.s_max - 1} tokens, so this prompt is "
                f"{length - (self.s_max - 1)} tokens over the remaining "
                "budget", rid=req.rid, length=length, s_max=self.s_max)

    def submit(self, req: Request):
        self._validate(req)
        if req.submitted_at == 0.0:
            # the adaptive server stamps and counts a request when it enters
            # the central queue; routing it into a lane does not re-count it
            req.submitted_at = time.time()
            self.metrics.on_submit(req)
        self.queue.append(req)

    # ---------------------------------------------------------- token stream
    def _emit(self, req: Request, tok: int, finished: bool):
        req.output.append(tok)
        first = req.first_token_at == 0.0
        now = time.time()
        if first:
            req.first_token_at = now
        self.metrics.on_token(req, first)
        req.last_token_at = now
        if first and self.tracer.enabled:
            self.tracer.instant("first_token", "scheduler",
                                track=self.trace_track, rid=req.rid, tok=tok)
            self.tracer.flow("t", req.rid, track=self.trace_track)
        if req.on_token is not None:
            req.on_token(req, tok, finished)

    def _sample(self, req: Request, logits_row) -> int:
        """Next token from one slot's (V,) logits row under the request's
        sampling params: :func:`select_tokens` on one row (the first token
        of an admission; the decode step selects all rows at once)."""
        return int(select_tokens(logits_row[None], logits_row.argmax()[None],
                                 [req])[0])

    def _finish(self, req: Request, slot: int):
        req.finished_at = time.time()
        self.metrics.on_finish(req)
        if self.tracer.enabled:
            self.tracer.instant("finish", "scheduler", track=self.trace_track,
                                rid=req.rid, slot=slot,
                                n_out=len(req.output))
            self.tracer.flow("f", req.rid, track=self.trace_track)
        self._release_slot(req, slot)
        self.done[slot] = True
        self.slots[slot] = None
        self._just_finished.append(req)

    def _release_slot(self, req: Request, slot: int):
        """Dense slots hold no shared state; the paged batcher releases the
        request's block references (and registers its prefix) here."""

    def _requeue(self, req: Request, slot: int):
        """Preemption: return an admitted request to the FRONT of the queue
        with its slot freed.  ``rid`` and ``output`` survive, so
        re-admission prefills prompt + generated tokens and the stream
        continues from the next token.  Victims are preempted
        latest-admitted-first, so successive appendlefts keep admission
        order at the queue head."""
        self.slots[slot] = None
        self.done[slot] = True
        self.stalled[slot] = False
        self.queue.appendleft(req)

    # ----------------------------------------------------------------- admit
    def _free_slot(self) -> int | None:
        for i in range(self.n_slots):
            if self.done[i] and self.slots[i] is None:
                return i
        return None

    def _activate(self, req: Request, slot: int, one_cache, first_logits_row):
        """First token of this admission chosen from the prefill logits; the
        admission cache joins the slot cache.

        A preemption-resumed request (non-empty ``output``) re-enters here
        mid-stream: ``length`` counts prompt + generated tokens, the budget
        check runs against the whole stream, and the cache-budget cap the
        decode loop would have applied fires here instead."""
        tok = self._sample(req, first_logits_row)
        resumed = bool(req.output)
        length = req.tokens.shape[1] + len(req.output)
        finished = (len(req.output) + 1 >= req.max_new
                    or (req.eos_id is not None and tok == req.eos_id)
                    or (resumed and length >= self.s_max - 1))
        self._emit(req, tok, finished)
        if finished:
            self._finish(req, slot)
            return
        self._join_slot(slot, one_cache)
        self.tokens[slot, 0] = tok
        self.pos[slot] = length
        self.done[slot] = False

    def _join_slot(self, slot: int, one_cache):
        """Copy the admission cache into slot ``slot`` — over a mesh on the
        rank that decodes it only (a no-op for the paged batcher, whose
        prefill chunks write blocks in place)."""
        if slot in self._local:
            write_slot(self.cache, one_cache, slot - self._local.start)

    def _admit_request(self) -> tuple[Request, int] | None:
        slot = self._free_slot()
        if not self.queue or slot is None:
            return None
        req = self.queue.popleft()
        req.started_at = time.time()
        self.metrics.on_admit(req)
        if self.tracer.enabled:
            self.tracer.instant("admit", "scheduler", track=self.trace_track,
                                rid=req.rid, slot=slot,
                                prompt_tokens=req.tokens.shape[1])
            self.tracer.flow("s", req.rid, track=self.trace_track)
        self.slots[slot] = req             # reserve (done stays True)
        return req, slot

    def _advance_admission(self):
        """Chunked path: at most ONE prefill chunk per scheduler step, so
        active slots never wait longer than a chunk for their next decode."""
        if self._adm is None:
            picked = self._admit_request()
            if picked is None:
                return
            req, slot = picked
            length = req.tokens.shape[1]
            padded = np.zeros((1, bucket_length(length, self.chunk_size)),
                              np.int64)
            padded[:, :length] = req.tokens
            if self._adm_cache is None:
                self._adm_cache = self._make_cache(1, self.s_adm)
            self._adm = _Admission(req, slot, padded, length)

        adm, c = self._adm, self.chunk_size
        chunk = torch.from_numpy(
            adm.tokens[:, adm.next_pos:adm.next_pos + c]).to(self.device)
        self.metrics.prefill_chunks += 1
        with self._span("prefill_chunk", rid=adm.req.rid, pos=adm.next_pos):
            if self.tracer.enabled:
                self.tracer.flow("t", adm.req.rid, track=self.trace_track)
            logits, self._adm_cache = self._profiled(
                "prefill_chunk", lambda: self.model.prefill_chunk(
                    self.params, chunk, self._adm_cache, adm.next_pos,
                    **self._shard_kw(self._admit_shard)))
        adm.next_pos += c
        if adm.next_pos >= adm.tokens.shape[1]:
            # the final chunk always holds the last real position L-1
            row = logits[0, (adm.length - 1) % c]
            self._adm = None
            self._activate(adm.req, adm.slot, self._adm_cache, row)

    def _admit_full(self):
        """Whole-prompt admission (SSM / hybrid stacks, or chunk_size=0):
        exact-length prefill per request — stalls decode for its
        duration."""
        while (picked := self._admit_request()) is not None:
            req, slot = picked
            self.metrics.prefill_full += 1
            tokens = torch.as_tensor(req.tokens, dtype=torch.int64,
                                     device=self.device)
            with self._span("prefill", rid=req.rid):
                logits, one_cache = self._profiled(
                    "prefill", lambda: self.model.prefill(
                        self.params, {"tokens": tokens}, self.s_adm,
                        **self._shard_kw(self._admit_shard)))
            self._activate(req, slot, one_cache, logits[0, -1])

    # ----------------------------------------------------------------- step
    def _live_slots(self) -> list[int]:
        """Slots the decode step advances: occupied, not done, not stalled
        (computed after :meth:`_pre_decode`)."""
        return [i for i in range(self.n_slots)
                if self.slots[i] is not None and not self.done[i]
                and not self.stalled[i]]

    def _pre_decode(self):
        """Hook before the batched decode step; the paged batcher allocates
        blocks here (and may preempt or stall slots)."""

    def _tick(self):
        """Per-step scheduler sample (queue depth, active slots), unless the
        adaptive server took ticking over (``tick = False``)."""
        if not self.tick:
            return
        active = sum(1 for i in range(self.n_slots)
                     if self.slots[i] is not None and not self.done[i])
        self.metrics.on_step(
            len(self.queue) + (1 if self._adm is not None else 0),
            active=active)

    def step(self):
        """One scheduler iteration: a prefill chunk (if a request is being
        admitted) plus one decode step for every active slot.  Returns the
        requests finished this step.

        This is the flight-recorder wrapper (the ``step`` span, the
        tuning-cache counter sample and the metrics-snapshot cadence) around
        :meth:`_step_impl`."""
        tr = self.tracer
        with self._span("step", queue_depth=len(self.queue)):
            finished = self._step_impl()
        tr.maybe_tuning_counter()
        if self.tick and tr.snapshotter is not None:
            tr.tick_snapshot(self.metrics)
        return finished

    def _step_impl(self):
        self._tick()
        if self.chunk_size:
            self._advance_admission()
        else:
            self._admit_full()
        if not all(self.done):
            self._pre_decode()
        live = self._live_slots()
        if live:
            nxt = self._decode_call(live)
            self.metrics.decode_steps += 1
            for i in live:
                req = self.slots[i]
                tok = int(nxt[i])
                self.metrics.decode_slot_tokens += 1
                self.pos[i] += 1
                full = (len(req.output) + 1 >= req.max_new
                        or (req.eos_id is not None and tok == req.eos_id)
                        or self.pos[i] >= self.s_max - 1)
                self._emit(req, tok, full)
                if full:
                    self._finish(req, i)
                else:
                    self.tokens[i, 0] = tok
        finished, self._just_finished = self._just_finished, []
        return finished

    @property
    def idle(self) -> bool:
        return not self.queue and self._adm is None and bool(all(self.done))

    # ---------------------------------------------------------------- audit
    def _audit_flags(self, backend: str | None) -> dict:
        """Shared StepSpec fields for this batcher's serving contracts:
        precision flags, the contract's backend (``backend``, else this
        device's: the kernels on a card, the plain versions on the host),
        what the steps run (the contract's backend on a card; the device
        decides on the host, where the engine refuses ``cuda``) and
        pure-DP-ness (a batcher with no mesh is collective-free)."""
        from repro_torch.core.precision import (A_FLOAT, W_FLOAT,
                                                get_precision, signed)
        from repro_torch.parallel import sharding as shd
        pcfg = signed(get_precision(self.model.cfg.precision))
        qw = pcfg.w_mode != W_FLOAT
        on_card = self.device.type == "cuda"
        backend = backend or ("cuda" if on_card else "torch")
        return {
            "quantized_weights": qw,
            "quantized_acts": qw and pcfg.a_mode != A_FLOAT
            and pcfg.a_bits <= 8,
            "backend": backend,
            "run_backend": backend if on_card else None,
            "pure_dp": self.mesh is None
            or shd.pure_dp(self.model.cfg, self.mesh),
        }

    def _scratch(self, tree):
        """A copy of a cache or pool tree for an audit step to write into
        (the live batcher's state is never touched)."""
        from repro_torch.tree import tree_map
        return tree_map(lambda t: t.clone(), tree)

    def audit_steps(self, backend: str | None = None) -> list:
        """This batcher's step functions as
        :class:`repro_torch.analysis.report.StepSpec`\\ s, the reference's
        step names (``decode``, ``prefill``, ``chunk`` with chunked
        admission, ``select``) with example arguments shaped as the hot
        loop passes them: this rank's decode rows, scratch copies of the
        slot cache and the admission cache.  ``backend``: the engine
        backend of the contract ("cuda" | "torch"; None: this device's)."""
        from repro_torch.analysis.report import StepSpec
        flags = self._audit_flags(backend)
        m = self.model
        lo, hi = self._local.start, self._local.stop
        dev = self.device
        decode_kw = self._shard_kw(self._decode_shard)
        admit_kw = self._shard_kw(self._admit_shard)
        steps = [
            StepSpec(name="decode",
                     fn=lambda p, t, c, pos, **kw: m.decode_step(
                         p, t, c, pos, **decode_kw, **kw),
                     args=(self.params,
                           torch.from_numpy(self.tokens[lo:hi]).to(dev),
                           self._scratch(self.cache),
                           torch.from_numpy(self.pos[lo:hi]).to(dev)),
                     inplace=(2,), **flags),
            StepSpec(name="prefill",
                     fn=lambda p, batch, **kw: m.prefill(
                         p, batch, self.s_adm, **admit_kw, **kw),
                     args=(self.params, {"tokens": torch.zeros(
                         (1, min(8, self.s_adm)), dtype=torch.int64,
                         device=dev)}),
                     **flags),
        ]
        if self.chunk_size:
            adm = self._adm_cache if self._adm_cache is not None \
                else self._make_cache(1, self.s_adm)
            steps.append(StepSpec(
                name="chunk",
                fn=lambda p, t, c, pos, **kw: m.prefill_chunk(
                    p, t, c, pos, **admit_kw, **kw),
                args=(self.params,
                      torch.zeros((1, self.chunk_size), dtype=torch.int64,
                                  device=dev), self._scratch(adm), 0),
                inplace=(2,), **flags))
        steps.append(self._select_audit_step("select", flags, hi - lo))
        return steps

    def _select_audit_step(self, name: str, flags: dict, n_rows: int):
        """The next-token selection of a decode step's rows (greedy argmax
        and, for sampled rows, :func:`sample_core`), every row sampled at
        temperature 1, top-k 5.  It runs no matmul, so the precision flags are off:
        it is audited for collective-freedom under pure DP."""
        from repro_torch.analysis.report import StepSpec
        v = self.model.cfg.padded_vocab
        rows = [Request(i, np.zeros((1, 1), np.int64),
                        RequestOptions(temperature=1.0, top_k=5))
                for i in range(n_rows)]

        def select(lg, **kw):
            return select_tokens(lg, lg.argmax(dim=-1), rows)
        return StepSpec(
            name=name, fn=select,
            args=(torch.zeros((n_rows, v), dtype=torch.float32,
                              device=self.device),),
            **dict(flags, quantized_weights=False, quantized_acts=False))

    def run(self, max_steps: int = 10_000):
        """Drain the queue; returns all finished requests.  On any exception
        the flight recorder dumps its ring next to the crash before
        re-raising."""
        out = []
        try:
            for _ in range(max_steps):
                out.extend(self.step())
                if self.idle:
                    break
        except BaseException:
            self.tracer.on_crash()
            raise
        return out
