"""Port parity: the reduced smollm through ``repro_torch.models`` against
``repro.models`` — serving conversion, prefill / prefill_chunk / decode
logits, and greedy streams — starting from the reference's own params
(``model.init(PRNGKey(0))``) through ``repro_torch.interop``.

Logit tolerance (f32): atol 1e-4.  Both packages run the same elementwise
ops in the same order, and integer accumulators are exact; what differs is
the summation order of float matmuls, einsums and softmax sums between XLA
and torch (a few ulps), which the quantized activations see only when a
value sits within an ulp of a rounding boundary.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import reduce_for_smoke  # noqa: E402
from repro.models import to_serving as jto_serving  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import reduce_for_smoke as treduce  # noqa: E402
from repro_torch.models import to_serving  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

ATOL = 1e-4
S_MAX = 32
CASES = [("fp32", 0), ("fp32", 8), ("2xT", 0), ("2xT", 8)]


@pytest.fixture(autouse=True)
def _tuning_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "tuning.json"))


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


_CACHE = {}


def _pair(precision, kv_bits, dtype="float32"):
    """(jax model, jax serving params, port model, port serving params) —
    the port's params are the reference's serving params through interop."""
    key = (precision, kv_bits, dtype)
    if key not in _CACHE:
        jcfg = dataclasses.replace(reduce_for_smoke(jget_config(
            "smollm-135m", precision=precision, kv_bits=kv_bits)), dtype=dtype)
        tcfg = dataclasses.replace(treduce(get_config(
            "smollm-135m", precision=precision, kv_bits=kv_bits)), dtype=dtype)
        jm = jbuild(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        jsv = jto_serving(jp, jcfg)
        _CACHE[key] = (jm, jsv, build_model(tcfg),
                       params_from_numpy(_np_tree(jsv), "cpu"), jp)
    return _CACHE[key]


def _tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("precision", ["2xT", "4x4", "2x2"])
def test_to_serving_words_match(precision):
    """The port's to_serving of the interop'd float params: int32 words and
    int8 codes equal to the reference's (default tp=16 layout, so the
    reduced wo keeps int8 codes); scales within rtol 1e-6 (f32 means)."""
    jm, jsv, tm, _, jp = _pair(precision, 8)
    got = dict(_leaves(to_serving(params_from_numpy(_np_tree(jp), "cpu"),
                                  tm.cfg)))
    want = dict(_leaves(_np_tree(jsv)))
    assert got.keys() == want.keys()
    n_words = 0
    for path, w in want.items():
        g = got[path].numpy()
        if w.dtype in (np.int32, np.int8):
            np.testing.assert_array_equal(g, w, err_msg=str(path))
            n_words += w.dtype == np.int32
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=str(path))
    assert n_words > 0


@pytest.mark.parametrize("precision,kv_bits", CASES)
def test_prefill_logits(precision, kv_bits):
    jm, jsv, tm, tp, _ = _pair(precision, kv_bits)
    toks = _tokens(2, 12, tm.cfg.vocab)
    lj, cj = jm.prefill(jsv, {"tokens": jnp.asarray(toks)}, S_MAX)
    lt, ct = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()}, S_MAX)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)
    if kv_bits:
        # the cache codes, including the 1e-6 scale padding past the prompt
        np.testing.assert_array_equal(ct["layer_0"]["ks"][:, :, 12:].numpy(),
                                      np.asarray(cj["layer_0"]["ks"])[:, :, 12:])


@pytest.mark.parametrize("precision,kv_bits", CASES)
def test_prefill_chunk_logits(precision, kv_bits):
    """Two chunks against a batch-1 cache, each held to the reference's
    chunk path (never to its whole-prompt prefill)."""
    jm, jsv, tm, tp, _ = _pair(precision, kv_bits)
    toks = _tokens(1, 16, tm.cfg.vocab, seed=1)
    cj = jtfm.make_cache(jm.cfg, 1, S_MAX)
    ct = tfm.make_cache(tm.cfg, 1, S_MAX, "cpu")
    for start in (0, 8):
        chunk = toks[:, start:start + 8]
        lj, cj = jm.prefill_chunk(jsv, jnp.asarray(chunk), cj, start)
        lt, ct = tm.prefill_chunk(tp, torch.from_numpy(chunk).long(), ct, start)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)


@pytest.mark.parametrize("precision,kv_bits", CASES)
def test_decode_step_logits(precision, kv_bits):
    """One batched decode step at ragged per-slot positions."""
    jm, jsv, tm, tp, _ = _pair(precision, kv_bits)
    toks = _tokens(3, 10, tm.cfg.vocab, seed=2)
    _, cj = jm.prefill(jsv, {"tokens": jnp.asarray(toks)}, S_MAX)
    _, ct = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()}, S_MAX)
    pos = np.array([10, 7, 4], np.int32)
    step = toks[:, -1:]
    lj, _ = jm.decode_step(jsv, jnp.asarray(step), cj, jnp.asarray(pos))
    lt, _ = tm.decode_step(tp, torch.from_numpy(step).long(), ct,
                           torch.from_numpy(pos))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)


@pytest.mark.parametrize("precision,kv_bits", [("2xT", 8), ("fp32", 0)])
def test_greedy_tokens_identical(precision, kv_bits):
    """8 greedy tokens (f32 logits, first-maximum argmax in both)."""
    jm, jsv, tm, tp, _ = _pair(precision, kv_bits)
    toks = _tokens(2, 9, tm.cfg.vocab, seed=3)
    lj, cj = jm.prefill(jsv, {"tokens": jnp.asarray(toks)}, S_MAX)
    lt, ct = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()}, S_MAX)
    tj, tt = jnp.argmax(lj[:, -1], -1), lt[:, -1].argmax(-1)
    out_j, out_t = [np.asarray(tj)], [tt.numpy()]
    for i in range(7):
        pos = 9 + i
        lj, cj = jm.decode_step(jsv, tj[:, None].astype(jnp.int32), cj, pos)
        lt, ct = tm.decode_step(tp, tt[:, None], ct, pos)
        tj, tt = jnp.argmax(lj[:, 0], -1), lt[:, 0].argmax(-1)
        out_j.append(np.asarray(tj))
        out_t.append(tt.numpy())
    np.testing.assert_array_equal(np.stack(out_t), np.stack(out_j))


def test_bf16_logits():
    """bf16 model dtype, float weights, kv8 cache.  Tolerance atol 0.02,
    five bf16 ulps at the logits' magnitude (|logit| < 1 here): bf16 rounds
    at different points in the two frameworks (XLA keeps fused elementwise
    chains in f32).  Low-bit activation configs are held in f32 above: at
    bf16 one rounding step can flip a 2-bit code, which moves the logits
    by far more than any rounding bound."""
    jm, jsv, tm, tp, _ = _pair("fp32", 8, dtype="bfloat16")
    toks = _tokens(2, 12, tm.cfg.vocab, seed=4)
    lj, _ = jm.prefill(jsv, {"tokens": jnp.asarray(toks)}, S_MAX)
    lt, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()}, S_MAX)
    assert tp["embed"]["w"].dtype == torch.bfloat16
    assert lt.dtype == torch.float32
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=0.02)
