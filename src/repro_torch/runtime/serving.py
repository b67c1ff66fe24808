"""Continuous-batching serving scheduler with chunked prefill — the dense
``ContinuousBatcher`` of ``repro.runtime.serving``.

  * a request queue; admission at prefill-*chunk* granularity — prompts
    pad up to a multiple of the chunk size and are admitted one chunk per
    scheduler step, interleaved with the batched decode of the running
    requests (or whole-prompt admission with ``chunk_size=0``);
  * fixed-capacity decode slots over one (n_slots, s_max) cache, built once
    on the device and reused: an admitted request's cache is copied into its
    slot (:func:`write_slot`);
  * greedy decoding, with the argmax fused into the decode step so that
    only the (n_slots,) next-token vector crosses to the host each step;
  * latency accounting per request (queue / TTFT / inter-token) by
    :class:`repro_torch.runtime.metrics.Metrics`.

Exactness contract: greedy generations equal isolated sequential runs for
attention-only stacks, and the same schedule gives the same streams as the
JAX package's batcher.  Sampling (temperature > 0) is not ported yet and is
refused at submit.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from .errors import EmptyPromptError, InvalidBudgetError, PromptTooLongError
from .metrics import Metrics


@dataclasses.dataclass
class RequestOptions:
    """Per-request options.  ``temperature`` > 0 (sampling) is not ported
    yet: submit refuses it."""
    max_new: int = 16
    eos_id: int | None = None
    temperature: float = 0.0


@dataclasses.dataclass
class ServingConfig:
    """Dense batcher configuration (the dense fields of the reference's
    ``ServingConfig``)."""
    n_slots: int = 8
    s_max: int = 128
    chunk_size: int | None = None      # None -> min(32, s_max); 0 -> whole


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

    @property
    def max_new(self) -> int:
        return self.options.max_new

    @property
    def eos_id(self) -> int | None:
        return self.options.eos_id

    @property
    def temperature(self) -> float:
        return self.options.temperature


@dataclasses.dataclass
class _Admission:
    """One request mid-chunked-prefill (its cache is not yet slot-resident)."""
    req: Request
    slot: int
    tokens: np.ndarray                 # (1, L_pad) bucket-padded prompt
    length: int                        # true prompt length L
    next_pos: int = 0                  # next chunk start


def bucket_length(length: int, chunk: int) -> int:
    """Pad a prompt length up to the next chunk multiple (its shape bucket)."""
    return -(-length // chunk) * chunk


def write_slot(cache, one, i: int) -> None:
    """Copy a batch-1 cache ``one`` into slot ``i`` of the slot cache, in
    place.  Leaves are (periods, B, S, ...); the admission cache may be
    longer than the slot cache, so its sequence axis is cut first."""
    for name, c in cache.items():
        if isinstance(c, dict):
            write_slot(c, one[name], i)
        else:
            s = min(c.shape[2], one[name].shape[2])
            c[:, i:i + 1, :s] = one[name][:, :, :s]


class ContinuousBatcher:
    """Slot-based continuous batching: chunked (or whole-prompt) prefill
    interleaved with batched greedy decode, on the device of the params
    (the port serves attention-only token LMs, so chunk admission is always
    exact)."""

    def __init__(self, model, params, config: ServingConfig, *,
                 metrics: Metrics | None = None):
        if not isinstance(config, ServingConfig):
            raise TypeError(f"config must be a ServingConfig, got "
                            f"{type(config).__name__}")
        self.config = config
        self.model = model
        self.params = params
        self.device = params["embed"]["w"].device
        self.n_slots = n_slots = config.n_slots
        self.s_max = s_max = config.s_max
        cfg = model.cfg
        chunk_size = config.chunk_size
        self.chunk_size = int(min(32, s_max) if chunk_size is None
                              else chunk_size)
        # the admission cache is rounded up so every chunk call is full-size
        self.s_adm = (bucket_length(s_max, self.chunk_size)
                      if self.chunk_size else s_max)

        from repro_torch.models import transformer as tfm
        self._make_cache = lambda b, s: tfm.make_cache(cfg, b, s, self.device)
        self.cache = self._make_cache(n_slots, s_max)
        self._adm_cache = None             # reused (1, s_adm) admission cache

        self.metrics = metrics if metrics is not None else Metrics(n_slots)
        self.queue: deque[Request] = deque()
        self.slots: list[Request | None] = [None] * n_slots
        self.pos = np.zeros(n_slots, np.int64)
        self.done = np.ones(n_slots, bool)
        self.tokens = np.zeros((n_slots, 1), np.int64)
        self._adm: _Admission | None = None
        self._just_finished: list[Request] = []

    # ---------------------------------------------------------------- steps
    def _decode(self, tokens: np.ndarray, pos: np.ndarray) -> np.ndarray:
        """One batched decode step with the greedy argmax fused in: returns
        the (n_slots,) next tokens — the step's only device->host copy."""
        tok = torch.from_numpy(tokens).to(self.device)
        pos_t = torch.from_numpy(pos).to(self.device)
        logits, self.cache = self.model.decode_step(
            self.params, tok, self.cache, pos_t)
        return logits[:, 0].argmax(dim=-1).cpu().numpy()

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
        if req.temperature > 0.0:
            raise NotImplementedError(
                f"request {req.rid}: temperature={req.temperature} — "
                "sampling is not ported yet; the port decodes greedily "
                "(temperature 0)")

    def submit(self, req: Request):
        self._validate(req)
        req.submitted_at = time.time()
        self.metrics.on_submit(req)
        self.queue.append(req)

    # ---------------------------------------------------------- token stream
    def _emit(self, req: Request, tok: int):
        req.output.append(tok)
        first = req.first_token_at == 0.0
        now = time.time()
        if first:
            req.first_token_at = now
        self.metrics.on_token(req, first)
        req.last_token_at = now

    def _finish(self, req: Request, slot: int):
        req.finished_at = time.time()
        self.metrics.on_finish(req)
        self.done[slot] = True
        self.slots[slot] = None
        self._just_finished.append(req)

    # ----------------------------------------------------------------- admit
    def _free_slot(self) -> int | None:
        for i in range(self.n_slots):
            if self.done[i] and self.slots[i] is None:
                return i
        return None

    def _activate(self, req: Request, slot: int, one_cache, first_logits_row):
        """First token chosen from the prefill logits; the admission cache
        joins the slot cache."""
        tok = int(first_logits_row.argmax())
        finished = (req.max_new <= 1
                    or (req.eos_id is not None and tok == req.eos_id))
        self._emit(req, tok)
        if finished:
            self._finish(req, slot)
            return
        write_slot(self.cache, one_cache, slot)
        self.tokens[slot, 0] = tok
        self.pos[slot] = req.tokens.shape[1]
        self.done[slot] = False

    def _admit_request(self) -> tuple[Request, int] | None:
        slot = self._free_slot()
        if not self.queue or slot is None:
            return None
        req = self.queue.popleft()
        req.started_at = time.time()
        self.metrics.on_admit(req)
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
        logits, self._adm_cache = self.model.prefill_chunk(
            self.params, chunk, self._adm_cache, adm.next_pos)
        adm.next_pos += c
        if adm.next_pos >= adm.tokens.shape[1]:
            # the final chunk always holds the last real position L-1
            row = logits[0, (adm.length - 1) % c]
            self._adm = None
            self._activate(adm.req, adm.slot, self._adm_cache, row)

    def _admit_full(self):
        """Whole-prompt admission (chunk_size=0): exact-length prefill per
        request — stalls decode for its duration."""
        while (picked := self._admit_request()) is not None:
            req, slot = picked
            self.metrics.prefill_full += 1
            tokens = torch.as_tensor(req.tokens, dtype=torch.int64,
                                     device=self.device)
            logits, one_cache = self.model.prefill(
                self.params, {"tokens": tokens}, self.s_adm)
            self._activate(req, slot, one_cache, logits[0, -1])

    # ----------------------------------------------------------------- step
    def step(self):
        """One scheduler iteration: a prefill chunk (if a request is being
        admitted) plus one decode step for every active slot.  Returns the
        requests finished this step."""
        active = sum(1 for i in range(self.n_slots)
                     if self.slots[i] is not None and not self.done[i])
        self.metrics.on_step(
            len(self.queue) + (1 if self._adm is not None else 0),
            active=active)
        if self.chunk_size:
            self._advance_admission()
        else:
            self._admit_full()
        live = [i for i in range(self.n_slots)
                if self.slots[i] is not None and not self.done[i]]
        if live:
            nxt = self._decode(self.tokens, self.pos)
            self.metrics.decode_steps += 1
            for i in live:
                req = self.slots[i]
                tok = int(nxt[i])
                self.metrics.decode_slot_tokens += 1
                self.pos[i] += 1
                full = (len(req.output) + 1 >= req.max_new
                        or (req.eos_id is not None and tok == req.eos_id)
                        or self.pos[i] >= self.s_max - 1)
                self._emit(req, tok)
                if full:
                    self._finish(req, i)
                else:
                    self.tokens[i, 0] = tok
        finished, self._just_finished = self._just_finished, []
        return finished

    @property
    def idle(self) -> bool:
        return not self.queue and self._adm is None and bool(all(self.done))

    def run(self, max_steps: int = 10_000):
        """Drain the queue; returns all finished requests."""
        out = []
        for _ in range(max_steps):
            out.extend(self.step())
            if self.idle:
                break
        return out
