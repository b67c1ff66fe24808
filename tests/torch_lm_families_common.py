"""Shared set-up of the port's parity tests for the last decoder-only LM
families (``tests/test_torch_lm_families_*.py``): the reduced gemma2-27b
(local / global attention, softcaps, post-norms, the embedding scale; also
with its window cut to 8 so that reduced prompts reach it), glm4-9b (16
query heads a KV head at full size), starcoder2-15b (non-gated gelu FFN),
internvl2-76b (the embeds frontend) and kimi-k2-1t-a32b (MoE) through
``repro_torch.models`` against ``repro.models``.

Params are the reference's own, through ``interop``.  Logit tolerance atol
1e-4 (f32 summation order, as tests/test_torch_model.py); greedy streams
identical.  MoE capacity depends on the rows of a call, so every
comparison runs the same batch through both packages.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild
from repro.models import reduce_for_smoke as jreduce
from repro.models import to_serving as jto_serving
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import build_model
from repro_torch.models import reduce_for_smoke
from torch_testing import reference_jit

ATOL = 1e-4
S_MAX = 32
# "gemma2-w8": gemma2-27b with window 8 on both sides (reduce_for_smoke
# keeps 4096, which no reduced prompt reaches)
ARCHS = ["gemma2-27b", "gemma2-w8", "glm4-9b", "starcoder2-15b",
         "internvl2-76b", "kimi-k2-1t-a32b"]
PAGEABLE = [a for a in ARCHS if a != "internvl2-76b"]
CASES = [("fp32", 0), ("fp32", 8), ("2xT", 0), ("2xT", 8)]
GRID = [(a, p, k) for a in ARCHS for p, k in CASES]
GRID_IDS = [f"{a.split('-')[0]}{'-w8' if 'w8' in a else ''}-{p}-kv{k}"
            for a, p, k in GRID]


@pytest.fixture(autouse=True)
def _tuning_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "tuning.json"))


def _cfgs(arch, precision, kv_bits):
    base = "gemma2-27b" if arch == "gemma2-w8" else arch
    jcfg = jreduce(jget_config(base, precision=precision, kv_bits=kv_bits))
    tcfg = reduce_for_smoke(get_config(base, precision=precision,
                                       kv_bits=kv_bits))
    if arch == "gemma2-w8":
        jcfg = dataclasses.replace(jcfg, window=8)
        tcfg = dataclasses.replace(tcfg, window=8)
    return jcfg, tcfg


_MODELS = {}
_PARAMS = {}


def _pair(arch, precision, kv_bits):
    """(jax model, jax serving params, port model, port serving params),
    the reference's prefill, decode step, forward (and so its loss) and
    prefill chunk jitted (an eager scan compiles its body on every call).
    The serving params do not depend on the KV cache's bits: one draw and
    packing serves every kv_bits of a precision."""
    key = (arch, precision, kv_bits)
    if key not in _MODELS:
        jcfg, tcfg = _cfgs(arch, precision, kv_bits)
        jm = jbuild(jcfg)
        if (arch, precision) not in _PARAMS:
            jsv = reference_jit(lambda k: jto_serving(jm.init(k), jcfg))(
                jax.random.PRNGKey(0))
            _PARAMS[arch, precision] = (jsv, params_from_numpy(
                jax.tree_util.tree_map(np.array, jsv), "cpu"))
        jsv, tp = _PARAMS[arch, precision]
        jm = dataclasses.replace(
            jm, prefill=reference_jit(jm.prefill, static_argnums=2),
            decode_step=reference_jit(jm.decode_step),
            forward=reference_jit(jm.forward),
            prefill_chunk=jm.prefill_chunk and reference_jit(
                jm.prefill_chunk))
        _MODELS[key] = (jm, jsv, build_model(tcfg), tp)
    return _MODELS[key]


def _inputs(cfg, b, s, seed):
    """Token ids (int32), or the embeds frontend's (B, S, D) f32 embeddings,
    as numpy."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "embeds":
        return rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    return rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _t(a):
    t = torch.from_numpy(np.asarray(a))
    return t if t.is_floating_point() else t.long()


def _batch(cfg, x):
    return {"embeds" if cfg.frontend == "embeds" else "tokens": x}


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
