"""Shared set-up of the port's parity tests for the MoE, Mamba and hybrid
stacks as a whole (``tests/test_torch_hybrid_*.py``): the reduced
granite-moe-1b-a400m (attention + MoE), falcon-mamba-7b (Mamba only) and
jamba-v0.1-52b (Mamba + attention, dense + MoE FFNs) through
``repro_torch.models`` against ``repro.models``.  Params are the
reference's own, through ``interop``.

Logit tolerance atol 1e-4 (f32 summation order, as
tests/test_torch_model.py); greedy streams identical.  MoE capacity
depends on the rows of a call, so every comparison runs the same batch
through both packages (never a solo run against a batched one).
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
ARCHS = ["granite-moe-1b-a400m", "falcon-mamba-7b", "jamba-v0.1-52b"]
CASES = [("fp32", 0), ("fp32", 8), ("2xT", 0), ("2xT", 8)]
GRID = [(a, p, k) for a in ARCHS for p, k in CASES]
GRID_IDS = [f"{a.split('-')[0]}-{p}-kv{k}" for a, p, k in GRID]


@pytest.fixture(autouse=True)
def _tuning_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "tuning.json"))


_MODELS = {}
_PARAMS = {}


def _pair(arch, precision, kv_bits):
    """(jax model, jax serving params, port model, port serving params).
    The reference model's prefill, decode step, forward (and so its loss)
    and prefill chunk are jitted (eager, the reduced jamba takes seconds a
    call, and an eager scan compiles its body on every call).  The serving
    params do not depend on the KV cache's bits: one draw and packing
    serves every kv_bits of a precision."""
    key = (arch, precision, kv_bits)
    if key not in _MODELS:
        jcfg = jreduce(jget_config(arch, precision=precision, kv_bits=kv_bits))
        tcfg = reduce_for_smoke(get_config(arch, precision=precision,
                                           kv_bits=kv_bits))
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


def _tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
