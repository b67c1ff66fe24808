"""Port parity across the paper's precision menu: the reduced smollm through
``repro_torch.models`` against ``repro.models``, f32, from the reference's
own serving params (``model.init(PRNGKey(0))`` then ``to_serving``) through
``repro_torch.interop``.

1. Every ``PAPER_CONFIGS`` precision but 8x8 and 8xB, with a dense KV
   cache of 0 (float), 4 or 8 bits: ``prefill_chunk`` logits (a (2, 12)
   prompt in chunks of 8 and 4) and four ``decode_step`` logits within
   ATOL = 1e-4, and identical greedy streams (five tokens).  The four
   combinations that ``tests/test_torch_model.py`` holds are left out.
2. 8x8 and 8xB: each of layer 0's seven projections, fed the reference's
   own input to it (captured from ``repro.models.layers.attn_apply`` /
   ``ffn_apply`` run eagerly), gives the reference's output exactly
   through ``engine.qmatmul`` with the port's serving params (every
   projection there has integer codes on both sides: an int32
   accumulator and the same f32 epilogue).  End to end these two are not
   held to 1e-4: an f32 summation-order difference in the attention
   (a few ulps) can move one value across an 8-bit rounding boundary of
   the per-row quantizer, and the flipped code moves the logits by ~1e-2.

Logit tolerance (f32): atol 1e-4, as in ``tests/test_torch_model.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_testing import one_thread, reference_jit  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.precision import PAPER_CONFIGS  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import reduce_for_smoke  # noqa: E402
from repro.models import to_serving as jto_serving  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.precision import get_precision, signed  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import engine  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import reduce_for_smoke as treduce  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

ATOL = 1e-4
S_MAX = 32
PROMPT, CHUNK, STEPS = 12, 8, 4
EIGHT_BIT = ("8x8", "8xB")
HELD_ELSEWHERE = {("fp32", 0), ("fp32", 8), ("2xT", 0), ("2xT", 8)}
GRID = [(p, kv) for p in PAPER_CONFIGS if p not in EIGHT_BIT
        for kv in (0, 4, 8) if (p, kv) not in HELD_ELSEWHERE]
GRID_IDS = [f"{p}-kv{kv}" for p, kv in GRID]
PROJECTIONS = [("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
               ("ffn", "w_gate"), ("ffn", "w_up"), ("ffn", "w_down")]


@pytest.fixture(autouse=True)
def _tuning_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "tuning.json"))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


_PARAMS = {}


def _pair(precision, kv_bits):
    """(jax model, jax serving params, port model, port serving params).
    The serving params do not depend on the KV cache's bits: one draw and
    packing serves every kv_bits of a precision."""
    jcfg = reduce_for_smoke(jget_config("smollm-135m", precision=precision,
                                        kv_bits=kv_bits))
    tcfg = treduce(get_config("smollm-135m", precision=precision,
                              kv_bits=kv_bits))
    assert jcfg.dtype == tcfg.dtype == "float32"
    jm = jbuild(jcfg)
    if precision not in _PARAMS:
        jsv = jto_serving(jm.init(jax.random.PRNGKey(0)), jcfg)
        _PARAMS[precision] = (jsv, params_from_numpy(_np_tree(jsv), "cpu"))
    jsv, tp = _PARAMS[precision]
    return jm, jsv, build_model(tcfg), tp


_RUNS = {}


def _run(precision, kv_bits):
    """Both models over one (2, 12) prompt in two chunks, then STEPS greedy
    decode steps; both sides are fed the reference's greedy tokens, so the
    logits compare like with like.  Returns {"chunk"/"decode": [(port,
    reference) logits], "tokens": (port, reference) greedy streams}."""
    key = (precision, kv_bits)
    if key in _RUNS:
        return _RUNS[key]
    jm, jsv, tm, tp = _pair(precision, kv_bits)
    # jitted: an eager scan compiles its body on every call
    prefill_chunk, decode_step = (reference_jit(jm.prefill_chunk),
                                  reference_jit(jm.decode_step))
    toks = np.random.default_rng(0).integers(
        0, tm.cfg.vocab, (2, PROMPT)).astype(np.int32)
    cj = jtfm.make_cache(jm.cfg, 2, S_MAX)
    ct = tfm.make_cache(tm.cfg, 2, S_MAX, "cpu")
    chunks = []
    for start in range(0, PROMPT, CHUNK):
        piece = toks[:, start:start + CHUNK]
        lj, cj = prefill_chunk(jsv, jnp.asarray(piece), cj, start)
        lt, ct = tm.prefill_chunk(tp, torch.from_numpy(piece).long(), ct,
                                  start)
        chunks.append((lt.numpy(), np.asarray(lj)))
    lt, lj = chunks[-1]
    out_t, out_j = [lt[:, -1].argmax(-1)], [lj[:, -1].argmax(-1)]
    decode = []
    for i in range(STEPS):
        step = out_j[-1][:, None].astype(np.int32)
        lj, cj = decode_step(jsv, jnp.asarray(step), cj, PROMPT + i)
        lt, ct = tm.decode_step(tp, torch.from_numpy(step).long(), ct,
                                PROMPT + i)
        decode.append((lt.numpy(), np.asarray(lj)))
        out_t.append(decode[-1][0][:, 0].argmax(-1))
        out_j.append(decode[-1][1][:, 0].argmax(-1))
    _RUNS[key] = {"chunk": chunks, "decode": decode,
                  "tokens": (np.stack(out_t), np.stack(out_j))}
    return _RUNS[key]


@pytest.mark.parametrize("precision,kv_bits", GRID, ids=GRID_IDS)
def test_prefill_chunk_logits(precision, kv_bits):
    for got, want in _run(precision, kv_bits)["chunk"]:
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("precision,kv_bits", GRID, ids=GRID_IDS)
def test_decode_step_logits(precision, kv_bits):
    for got, want in _run(precision, kv_bits)["decode"]:
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("precision,kv_bits", GRID, ids=GRID_IDS)
def test_greedy_streams_identical(precision, kv_bits):
    got, want = _run(precision, kv_bits)["tokens"]
    assert got.shape == (STEPS + 1, 2)
    np.testing.assert_array_equal(got, want)


_INPUTS = {}


def _projection_io(precision):
    """{(block, name): (input, reference output)} of layer 0's seven
    projections, captured while the reference's ``attn_apply`` and
    ``ffn_apply`` run eagerly over a (2, 12) prompt; and the port's layer-0
    serving params."""
    if precision in _INPUTS:
        return _INPUTS[precision]
    jm, jsv, tm, tp = _pair(precision, 8)
    lp = jax.tree_util.tree_map(lambda a: a[0], jsv["blocks"]["layer_0"])
    tl = {(blk, n): {a: w[0] for a, w in tp["blocks"]["layer_0"][blk][n].items()}
          for blk, n in PROJECTIONS}
    names = {id(lp[blk][n]): (blk, n) for blk, n in PROJECTIONS}
    seen = {}
    real = jlayers.qlinear_apply

    def spy(p, x, cfg, quantize_acts=True):
        out = real(p, x, cfg, quantize_acts)
        seen[names[id(p)]] = (np.array(x), np.array(out))
        return out

    toks = np.random.default_rng(0).integers(0, jm.cfg.vocab, (2, PROMPT))
    x0 = jsv["embed"]["w"][jnp.asarray(toks)]
    pos = jnp.broadcast_to(jnp.arange(PROMPT, dtype=jnp.int32)[None],
                           (2, PROMPT))
    mp = pytest.MonkeyPatch()
    mp.setattr(jlayers, "qlinear_apply", spy)
    try:
        attn, _ = jlayers.attn_apply(lp["attn"], x0, jm.cfg, pos, local=False)
        jlayers.ffn_apply(lp["ffn"], x0 + attn, jm.cfg)
    finally:
        mp.undo()
    assert set(seen) == set(PROJECTIONS)
    _INPUTS[precision] = (seen, tl, tm.cfg)
    return _INPUTS[precision]


@pytest.mark.parametrize("proj", PROJECTIONS, ids=[n for _, n in PROJECTIONS])
@pytest.mark.parametrize("precision", EIGHT_BIT)
def test_eight_bit_projection_matches_reference(precision, proj):
    """8-bit activations: the port's projection of the reference's own input
    equals the reference's output bit for bit (integer codes, integer
    accumulator, the same f32 epilogue)."""
    seen, tl, tcfg = _projection_io(precision)
    x, want = seen[proj]
    p = tl[proj]
    pcfg = signed(get_precision(tcfg.precision))
    assert pcfg.a_bits == 8 and not p["wt_packed"].is_floating_point()
    pw = engine.as_packed_weight(p, pcfg)
    with engine.dispatch_trace() as ev:
        got = engine.qmatmul(torch.from_numpy(x), pw, pcfg).numpy()
    assert [(e.op, e.a_bits) for e in ev] == [("qmatmul", 8)]
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.reshape(want.shape), want)
