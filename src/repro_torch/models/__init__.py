"""Model facade: ``build_model(cfg)`` returns a ``Model`` with the functional
serving API of ``repro.models.Model`` for dense token LMs:

    model.init(generator, device)                      -> params
    model.prefill(params, batch, s_max)                -> (logits, cache)
    model.prefill_chunk(params, tokens, cache, pos)    -> (logits, cache)
    model.decode_step(params, token, cache, pos)       -> (logits, cache)

``batch`` is {"tokens": (B, S)}.  Every step takes an optional ``backend``
("cuda" | "torch"); None picks by the device of the inputs.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Callable

from . import transformer
from .config import ModelConfig, reduce_for_smoke  # noqa: F401
from .convert import to_serving  # noqa: F401


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable
    prefill: Callable
    decode_step: Callable
    prefill_chunk: Callable


def build_model(cfg: ModelConfig) -> Model:
    if cfg.kind != "lm" or cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: the port serves token LMs only (kind={cfg.kind!r}, "
            f"frontend={cfg.frontend!r})")
    return Model(
        cfg=cfg,
        init=lambda generator, device: transformer.init_params(
            cfg, generator, device),
        prefill=lambda p, b, s_max, backend=None: transformer.prefill(
            p, b["tokens"], cfg, s_max, backend=backend),
        decode_step=lambda p, tok, cache, pos, backend=None:
            transformer.decode_step(p, tok, cache, pos, cfg, backend=backend),
        prefill_chunk=lambda p, tok, cache, pos, backend=None:
            transformer.prefill_chunk(p, tok, cache, pos, cfg,
                                      backend=backend),
    )
