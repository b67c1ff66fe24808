"""Port parity for the MoE, Mamba and hybrid stacks
(``tests/torch_hybrid_common.py``): a whole-prompt prefill then one decode
step, and a one-position prompt, against the reference's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_testing import one_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from torch_hybrid_common import (  # noqa: E402,F401
    ATOL, GRID, GRID_IDS, S_MAX, _close, _pair, _t, _tokens, _tuning_cache)


# ---------------------------------------------------------------------------
# model entry points
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,precision,kv_bits", GRID, ids=GRID_IDS)
def test_prefill_and_decode_logits(arch, precision, kv_bits):
    """A whole-prompt prefill (B=3), then one decode step at ragged
    per-slot positions; the cache the decode step reads is held too: Mamba
    states within atol 1e-4, KV codes within one step (a value on a
    rounding boundary may round either way under f32 summation order)."""
    jm, jsv, tm, tp = _pair(arch, precision, kv_bits)
    toks = _tokens(3, 10, tm.cfg.vocab, seed=2)
    lj, cj = jm.prefill(jsv, {"tokens": jnp.asarray(toks)}, S_MAX)
    lt, ct = tm.prefill(tp, {"tokens": _t(toks)}, S_MAX)
    _close(lt, lj)
    for name, leaf in ct.items():
        for k, v in leaf.items():
            if v.dtype == torch.int8:
                diff = np.abs(v.numpy().astype(np.int16)
                              - np.asarray(cj[name][k]).astype(np.int16))
                assert diff.max() <= 1, f"{name}/{k}"
            elif k in ("conv", "ssm"):
                np.testing.assert_allclose(v.numpy(), np.asarray(cj[name][k]),
                                           atol=ATOL, err_msg=f"{name}/{k}")
    pos = np.array([10, 7, 4], np.int32)
    step = toks[:, -1:]
    lj, _ = jm.decode_step(jsv, jnp.asarray(step), cj, jnp.asarray(pos))
    lt, _ = tm.decode_step(tp, _t(step), ct, torch.from_numpy(pos))
    _close(lt, lj)


def test_one_position_prompt_matches_reference():
    """A one-token prompt: the Mamba layers return no state, so the cache
    holds None there and the next decode step starts from a zero state, in
    both packages."""
    jm, jsv, tm, tp = _pair("falcon-mamba-7b", "fp32", 0)
    toks = _tokens(2, 1, tm.cfg.vocab, seed=7)
    lj, cj = jm.prefill(jsv, {"tokens": jnp.asarray(toks)}, S_MAX)
    lt, ct = tm.prefill(tp, {"tokens": _t(toks)}, S_MAX)
    _close(lt, lj)
    assert cj["layer_0"] is None and ct["layer_0"] is None
    lj, _ = jm.decode_step(jsv, jnp.asarray(toks), cj, 1)
    lt, _ = tm.decode_step(tp, _t(toks), ct, 1)
    _close(lt, lj)
