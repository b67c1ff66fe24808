"""Model facade: ``build_model(cfg)`` returns a ``Model`` with the functional
serving API of ``repro.models.Model`` for every LM family: decoder-only
stacks (attention, Mamba and hybrid, dense or MoE FFNs; token ids or the
stub frontend's embeddings) and the enc-dec backbone:

    model.init(generator, device)                      -> params
    model.forward(params, batch)                       -> (logits, aux)
    model.loss(params, batch, shard=None)              -> scalar
    model.prefill(params, batch, s_max)                -> (logits, cache)
    model.prefill_chunk(params, tokens, cache, pos)    -> (logits, cache)
    model.decode_step(params, token, cache, pos)       -> (logits, cache)
    model.prefill_chunk_paged(params, tokens, pool, page_table, pos, kv_bits)
    model.decode_step_paged(params, token, pool, page_table, pos, kv_bits,
                            slot_map=None, fused=True)  -> (logits, pool)
    model.decode_window_paged(params, tokens, pool, page_table, pos, kv_bits)
                                                       -> (logits, pool)

The three paged entry points are None for a stack with a Mamba layer (its
state has no sequence axis to page), for the embeds frontend and for the
enc-dec backbone, whose ``prefill_chunk`` is None too, as in the reference.

``batch`` is {"tokens": (B, S)} for token LMs, {"embeds": (B, S, D)} for
the embeds frontend (whose decode step takes (B, 1, D) embeddings), plus
{"frames": (B, S_enc, D)} for enc-dec, and {"labels": (B, S)} for
``loss``; :func:`make_batch` draws one from a generator.
Every call takes an optional ``backend`` ("cuda" | "torch"); None picks by
the device of the inputs.  The token-LM calls also take ``shard`` (a
``parallel.comm.StepSharding``; None on one device), as the batchers and
the train step pass it over a mesh.  ``forward`` and ``loss`` are
differentiable with float params: ``loss.backward()`` gives the
reference's ``jax.grad(model.loss)`` (straight-through fake-quant at a
quantized precision; ``launch.steps.make_train_step`` trains on it, on
one device or over a mesh).
"""
from __future__ import annotations

import dataclasses
from collections.abc import Callable
from typing import Any

import torch

from . import encdec, frontends, transformer  # noqa: F401
from .config import SHAPES, ModelConfig, ShapeConfig, reduce_for_smoke  # noqa: F401
from .convert import to_serving  # noqa: F401


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable
    prefill: Callable
    decode_step: Callable
    forward: Callable
    # chunked prefill: (params, tokens, cache, pos) -> (logits, cache); None
    # for the enc-dec backbone (no cache-append path)
    prefill_chunk: Callable | None = None
    # paged-KV serving (runtime.kvcache): block pool + page table; None for
    # stacks the paged cache does not cover (SSM / hybrid, embeds, enc-dec)
    prefill_chunk_paged: Callable | None = None
    decode_step_paged: Callable | None = None
    # multi-token decode window with per-slot start positions (the verify
    # step of self-speculative decoding); (params, tokens (B, W), pool,
    # page_table, pos (B,), kv_bits) -> (logits (B, W, V), pool)
    decode_window_paged: Callable | None = None

    def loss(self, params, batch, backend=None, shard=None):
        """Next-token NLL of ``batch["labels"]`` under the forward's logits,
        averaged over (B, S-1), plus 0.01 * aux.

        ``shard`` (a token LM over a mesh): ``batch`` holds this rank's
        rows, whose NLL mean this is (a train step averages the ranks');
        vocabulary-sharded logits stay this rank's slice, the NLL taken
        vocabulary-parallel (:func:`_vocab_parallel_nll`)."""
        kw = {} if shard is None else {"shard": shard, "gather": False}
        logits, aux = self.forward(params, batch, backend=backend, **kw)
        tgt = batch["labels"][:, 1:].to(torch.int64)
        logits = logits[:, :-1].to(torch.float32)
        if logits.shape[-1] != self.cfg.padded_vocab:
            nll = _vocab_parallel_nll(logits, tgt, shard.tp)
        else:
            logp = torch.log_softmax(logits, dim=-1)
            nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
        return nll.mean() + 0.01 * aux


def _vocab_parallel_nll(logits, tgt, tp):
    """-log softmax(logits)[tgt] of logits cut over the vocabulary (this
    rank's ``logits.shape[-1]`` columns at ``tp.index``) without gathering
    them: the rows' max over the axis (a stabilizer, no gradient), then the
    sum of exp and the target's logit summed over the axis in one
    all-reduce."""
    v = logits.shape[-1]
    m = tp.all_reduce_max(logits.detach().amax(dim=-1, keepdim=True))
    local = tgt - tp.index * v
    mine = (local >= 0) & (local < v)
    picked = torch.gather(logits, -1, local.clamp(0, v - 1)[..., None])[..., 0]
    sumexp, target = tp.all_reduce_sum(torch.stack([
        torch.exp(logits - m).sum(dim=-1),
        torch.where(mine, picked, torch.zeros_like(picked))]))
    return torch.log(sumexp) + m[..., 0] - target


def _lm_inputs(batch, cfg: ModelConfig):
    return batch["embeds"] if cfg.frontend == "embeds" else batch["tokens"]


def build_model(cfg: ModelConfig) -> Model:
    if cfg.kind == "encdec":
        return Model(
            cfg=cfg,
            init=lambda generator, device: encdec.init_params(
                cfg, generator, device),
            forward=lambda p, b, backend=None, shard=None, gather=True:
                encdec.forward(p, b["tokens"], b["frames"], cfg,
                               backend=backend, shard=shard),
            prefill=lambda p, b, s_max, backend=None, shard=None:
                encdec.prefill(p, b["tokens"], b["frames"], cfg, s_max,
                               backend=backend, shard=shard),
            decode_step=lambda p, tok, cache, pos, backend=None, shard=None:
                encdec.decode_step(p, tok, cache, pos, cfg, backend=backend,
                                   shard=shard),
        )
    if cfg.kind != "lm":
        raise ValueError(cfg.kind)
    pageable = cfg.frontend == "none" and transformer.attention_only(cfg)
    return Model(
        cfg=cfg,
        init=lambda generator, device: transformer.init_params(
            cfg, generator, device),
        forward=lambda p, b, backend=None, shard=None, gather=True:
            transformer.forward(p, _lm_inputs(b, cfg), cfg, backend=backend,
                                shard=shard, gather=gather),
        prefill=lambda p, b, s_max, backend=None, shard=None:
            transformer.prefill(p, _lm_inputs(b, cfg), cfg, s_max,
                                backend=backend, shard=shard),
        decode_step=lambda p, tok, cache, pos, backend=None, shard=None:
            transformer.decode_step(p, tok, cache, pos, cfg, backend=backend,
                                    shard=shard),
        prefill_chunk=lambda p, tok, cache, pos, backend=None, shard=None:
            transformer.prefill_chunk(p, tok, cache, pos, cfg,
                                      backend=backend, shard=shard),
        prefill_chunk_paged=(
            lambda p, tok, pool, pt, pos, kv_bits, backend=None, shard=None:
            transformer.prefill_chunk_paged(
                p, tok, pool, pt, pos, cfg, kv_bits, backend=backend,
                shard=shard)
        ) if pageable else None,
        decode_step_paged=(
            lambda p, tok, pool, pt, pos, kv_bits, slot_map=None,
            fused=True, backend=None, shard=None:
            transformer.decode_step_paged(
                p, tok, pool, pt, pos, cfg, kv_bits, slot_map=slot_map,
                fused=fused, backend=backend, shard=shard)
        ) if pageable else None,
        decode_window_paged=(
            lambda p, tok, pool, pt, pos, kv_bits, backend=None:
            transformer.decode_window_paged(
                p, tok, pool, pt, pos, cfg, kv_bits, backend=backend)
        ) if pageable else None,
    )


def make_batch(cfg: ModelConfig, shape: ShapeConfig,
               generator: torch.Generator) -> dict[str, Any]:
    """An input batch of ``shape`` drawn from ``generator``, on the
    generator's device: frames and tokens for enc-dec, the stub's
    embeddings for the embeds frontend, else tokens; labels when
    ``shape.mode == "train"``."""
    b = shape.global_batch
    s = shape.seq_len

    def tokens():
        return torch.randint(0, cfg.vocab, (b, s), generator=generator,
                             device=generator.device)
    batch: dict[str, Any] = {}
    if cfg.kind == "encdec":
        batch["frames"] = frontends.audio_frames_stub(generator, b, s,
                                                      cfg.d_model)
        batch["tokens"] = tokens()
    elif cfg.frontend == "embeds":
        batch["embeds"] = frontends.vision_patches_stub(generator, b, s,
                                                        cfg.d_model)
    else:
        batch["tokens"] = tokens()
    if shape.mode == "train":
        batch["labels"] = tokens()
    return batch
