"""Port parity for the MoE, Mamba and hybrid stacks
(``tests/torch_hybrid_common.py``): ``Model.forward`` / ``Model.loss`` with
the MoE aux, and the chunked prefill, against the reference's.
"""
import pytest

torch = pytest.importorskip("torch")
from torch_testing import one_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from torch_hybrid_common import (  # noqa: E402,F401
    ARCHS, S_MAX, _close, _pair, _t, _tokens, _tuning_cache)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("precision", ["fp32", "2xT"])
def test_forward_logits_and_aux(arch, precision):
    """``Model.forward`` and ``Model.loss`` (which adds 0.01 * aux): logits
    within 1e-4, aux within 1e-5 (a sum of per-layer terms, each within
    1e-6)."""
    jm, jsv, tm, tp = _pair(arch, precision, 0)
    toks = _tokens(2, 20, tm.cfg.vocab, seed=5)
    lj, aj = jm.forward(jsv, {"tokens": jnp.asarray(toks)})
    lt, at = tm.forward(tp, {"tokens": _t(toks)})
    _close(lt, lj)
    assert abs(float(at) - float(aj)) <= 1e-5
    assert (float(at) > 0) == ("falcon" not in arch)
    batch = {"tokens": toks, "labels": _tokens(2, 20, tm.cfg.vocab, seed=6)}
    want = float(jm.loss(jsv, jax.tree_util.tree_map(jnp.asarray, batch)))
    got = float(tm.loss(tp, {k: _t(v) for k, v in batch.items()}))
    assert abs(got - want) <= 1e-4


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("precision,kv_bits", [("2xT", 8), ("fp32", 0)])
def test_prefill_chunk_logits(arch, precision, kv_bits):
    """Two chunks against a batch-1 cache, each held to the reference's
    chunk path: KV appends for attention, the conv / SSM state carried from
    chunk to chunk for Mamba."""
    jm, jsv, tm, tp = _pair(arch, precision, kv_bits)
    toks = _tokens(1, 16, tm.cfg.vocab, seed=1)
    cj = jtfm.make_cache(jm.cfg, 1, S_MAX)
    ct = tfm.make_cache(tm.cfg, 1, S_MAX, "cpu")
    for start in (0, 8):
        chunk = toks[:, start:start + 8]
        lj, cj = jm.prefill_chunk(jsv, jnp.asarray(chunk), cj, start)
        lt, ct = tm.prefill_chunk(tp, _t(chunk), ct, start)
        _close(lt, lj)
