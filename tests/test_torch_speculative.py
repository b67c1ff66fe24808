"""Port parity: self-speculative decoding (``PagedBatcher(speculative=
True)``, ``Model.decode_window_paged``) and the engine's precision-variant
registry against ``repro``.

* ``decode_window_paged``: logits against the reference's within 1e-4 of
  max|logit|, the pools equal after the call; window row j equals the
  port's sequential ``decode_step_paged`` at ``pos + j`` bit for bit.
* The speculative batcher stepped in lockstep with the reference's, for the
  drafts 8x8, 8xT, 2xT and 1x1: page tables after every step, the streams
  (equal to the port's non-speculative streams and to the sequential fp
  oracle too) and the ``speculative`` counters.  Sampled rows equal the
  port's non-speculative sampled streams.  Speculation over a tiny pool
  that preempts.  The refusals, with the reference's messages.
* The variant registry and ``variant_tune_plans`` against the reference's.
* The ``draft`` / ``verify`` spans and the ``spec_round`` instants of a
  traced speculative run against the reference's.

The reduced smollm in float32 with the reference's own params (through
``interop``), as tests/test_torch_kvcache.py.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_testing import one_thread, reference_jit  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.precision import get_precision as jget_precision  # noqa: E402
from repro.core.precision import signed as jsigned  # noqa: E402
from repro.kernels import engine as jengine  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import reduce_for_smoke  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.runtime import kvcache as jkv  # noqa: E402
from repro.runtime import serving as jserving  # noqa: E402
from repro.runtime import tracing as jtracing  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.precision import get_precision, signed  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import engine  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import reduce_for_smoke as treduce  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.runtime import kvcache as tkv  # noqa: E402
from repro_torch.runtime import serving as tserving  # noqa: E402
from repro_torch.runtime import tracing as ttracing  # noqa: E402

S_MAX, CHUNK, BLOCK = 24, 4, 4
DRAFTS = ["8x8", "8xT", "2xT", "1x1"]
SPEC_COUNTERS = ("decode_steps", "decode_slot_tokens", "tokens_out",
                 "prefill_chunks", "preemptions", "recomputed_tokens",
                 "kv_blocks_peak")


@pytest.fixture(autouse=True)
def _tuning_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "tuning.json"))
    yield
    engine.clear_variants()
    jengine.clear_variants()
    engine.set_dispatch_listener(None)


@pytest.fixture(scope="module")
def stack():
    """(jax model, jax params, port model, port params, oracle memo) of the
    reduced smollm at fp32 in float32, with ``kv_bits=0`` (the paged
    batcher owns KV quantization)."""
    jcfg = dataclasses.replace(reduce_for_smoke(jget_config(
        "smollm-135m", precision="fp32", kv_bits=0)), dtype="float32")
    tcfg = dataclasses.replace(treduce(get_config(
        "smollm-135m", precision="fp32", kv_bits=0)), dtype="float32")
    jm = jbuild(jcfg)
    jp = reference_jit(jm.init)(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.array, jp), "cpu")
    return jm, jp, build_model(tcfg), tp, {}


def _prompt(length, salt, vocab):
    rng = np.random.default_rng(1009 * length + salt)
    return rng.integers(0, vocab, (1, length)).astype(np.int32)


def _oracle(stack, prompt, max_new):
    """The port's sequential single-request fp-greedy stream (dense prefill
    and decode steps), memoized."""
    _, _, tm, tp, memo = stack
    key = (prompt.tobytes(), max_new)
    if key not in memo:
        logits, cache = tm.prefill(
            tp, {"tokens": torch.from_numpy(prompt).long()}, S_MAX)
        out, pos = [int(logits[0, -1].argmax())], prompt.shape[1]
        for _ in range(max_new - 1):
            logits, cache = tm.decode_step(
                tp, torch.tensor([[out[-1]]]), cache, pos)
            out.append(int(logits[0, 0].argmax()))
            pos += 1
        memo[key] = out
    return memo[key]


def _config(pkg, **kw):
    return pkg.ServingConfig(n_slots=3, s_max=S_MAX, chunk_size=CHUNK,
                             block_size=BLOCK, **kw)


def _submit(b, pkg, prompts, budgets, **opts):
    dtype = np.int32 if pkg is jserving else np.int64
    for rid, (p, n) in enumerate(zip(prompts, budgets)):
        b.submit(pkg.Request(rid, p.astype(dtype),
                             options=pkg.RequestOptions(max_new=n, **opts)))


def _lockstep(jb, tb, prompts, budgets):
    """Step the reference's and the port's batchers together on the same
    requests: page tables, positions and pool invariants checked after
    every step.  Returns both {rid: stream}."""
    _submit(jb, jserving, prompts, budgets)
    _submit(tb, tserving, prompts, budgets)
    jdone, tdone = [], []
    for _ in range(2000):
        jdone += jb.step()
        tdone += tb.step()
        jb.check_pool()
        tb.check_pool()
        np.testing.assert_array_equal(tb._pt, np.asarray(jb._pt))
        np.testing.assert_array_equal(tb.pos, np.asarray(jb.pos))
        if jb.idle and tb.idle:
            break
    assert jb.idle and tb.idle
    return ({r.rid: list(r.output) for r in jdone},
            {r.rid: list(r.output) for r in tdone})


# ---------------------------------------------------------------------------
# the windowed decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kv_bits", [16, 8, 4])
def test_decode_window_paged_matches_reference(stack, kv_bits):
    """Two slots prefilled through page tables (a third slot dead), then a
    (3, 4) window at per-slot starts: logits against the reference's
    within 1e-4 of max|logit|, pools equal after the call (codes exactly,
    float leaves within 1e-5); each window row equal, bit for bit, to the
    port's sequential paged decode step at ``pos + j``."""
    jm, jp, tm, tp, _ = stack
    rng = np.random.default_rng(kv_bits)
    pt = np.array([[1, 2, 3, 4, 5, 0], [6, 7, 8, 9, 0, 0], [0] * 6],
                  np.int32)
    jpool = jtfm.make_pool(jm.cfg, 12, BLOCK, kv_bits)
    tpool = tfm.make_pool(tm.cfg, 12, BLOCK, kv_bits, "cpu")
    for row, n in ((0, 12), (1, 8)):
        toks = rng.integers(0, tm.cfg.vocab, (1, n)).astype(np.int32)
        for start in range(0, n, CHUNK):
            chunk = toks[:, start:start + CHUNK]
            _, jpool = jm.prefill_chunk_paged(
                jp, jnp.asarray(chunk), jpool, jnp.asarray(pt[row:row + 1]),
                start, kv_bits)
            _, tpool = tm.prefill_chunk_paged(
                tp, torch.from_numpy(chunk).long(), tpool,
                torch.from_numpy(pt[row:row + 1]), start, kv_bits)
    pos = np.array([12, 8, 0], np.int32)
    win = rng.integers(0, tm.cfg.vocab, (3, 4)).astype(np.int32)
    seq_pool = {k: {n: t.clone() for n, t in v.items()}
                for k, v in tpool.items()}
    lj, jpool = jm.decode_window_paged(jp, jnp.asarray(win), jpool,
                                       jnp.asarray(pt), jnp.asarray(pos),
                                       kv_bits)
    lt, tpool = tm.decode_window_paged(tp, torch.from_numpy(win).long(),
                                       tpool, torch.from_numpy(pt),
                                       torch.from_numpy(pos), kv_bits)
    assert lt.shape == (3, 4, tm.cfg.padded_vocab)
    scale = float(np.abs(np.asarray(lj)[:2]).max())
    np.testing.assert_allclose(lt.numpy()[:2], np.asarray(lj)[:2],
                               atol=1e-4 * scale)
    for layer, leaves in tpool.items():
        for name, leaf in leaves.items():
            got, want = leaf.numpy()[:, 1:], np.asarray(
                jpool[layer][name])[:, 1:]   # block 0: the dead slot's rows
            if got.dtype == np.int8:
                np.testing.assert_array_equal(got, want, err_msg=name)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                           err_msg=name)
    for j in range(4):
        ls, seq_pool = tm.decode_step_paged(
            tp, torch.from_numpy(win[:, j:j + 1]).long(), seq_pool,
            torch.from_numpy(pt), torch.from_numpy(pos + j), kv_bits)
        assert torch.equal(ls[:2, 0], lt[:2, j]), j
    for layer, leaves in tpool.items():
        for name, leaf in leaves.items():
            assert torch.equal(leaf[:, 1:], seq_pool[layer][name][:, 1:])


# ---------------------------------------------------------------------------
# the speculative batcher
# ---------------------------------------------------------------------------
PROMPT_LENS = [3, 5, 7, 9]
BUDGETS = [9, 6, 12, 4]


def _prompts(vocab):
    return [_prompt(n, 17 + i, vocab) for i, n in enumerate(PROMPT_LENS)]


@pytest.mark.parametrize("draft", DRAFTS)
def test_speculative_matches_reference_and_is_lossless(stack, draft):
    """Three slots, four requests: the port's speculative batcher stepped in
    lockstep with the reference's (page tables and positions after every
    step); streams equal to the reference's, to the port's non-speculative
    batcher's and to the sequential fp oracle; the speculative counters
    and the scheduler counters equal to the reference's."""
    jm, jp, tm, tp, _ = stack
    sc = dict(speculative=True, draft_precision=draft, draft_k=3)
    jb = jkv.PagedBatcher(jm, jp, _config(jserving, **sc))
    tb = tkv.PagedBatcher(tm, tp, _config(tserving, **sc))
    prompts = _prompts(tm.cfg.vocab)
    want, got = _lockstep(jb, tb, prompts, BUDGETS)
    assert got == want
    plain = tkv.PagedBatcher(tm, tp, _config(tserving))
    _submit(plain, tserving, prompts, BUDGETS)
    assert {r.rid: r.output for r in plain.run()} == got
    assert got == {i: _oracle(stack, p, n)
                   for i, (p, n) in enumerate(zip(prompts, BUDGETS))}
    js, ts = jb.metrics.summary(), tb.metrics.summary()
    assert ts["speculative"] == js["speculative"]
    assert ts["speculative"]["verify_steps"] > 0
    for name in SPEC_COUNTERS:
        assert getattr(tb.metrics, name) == getattr(jb.metrics, name), name
    tb.check_pool()


def test_speculative_sampled_rows_equal_non_speculative(stack):
    """Sampled rows (T 0.8, top-k 50) beside greedy ones: the speculative
    batcher's streams equal the non-speculative batcher's (the verify
    window's row j selects with the sequential step's noise), and some
    draft was accepted."""
    _, _, tm, tp, _ = stack
    prompts = _prompts(tm.cfg.vocab)
    outs = []
    for spec in (True, False):
        b = tkv.PagedBatcher(tm, tp, _config(
            tserving, speculative=spec, draft_precision="8x8", draft_k=3))
        for rid, (p, n) in enumerate(zip(prompts, BUDGETS)):
            opts = dict(temperature=0.8, top_k=50, seed=5) if rid % 2 else {}
            b.submit(tserving.Request(rid, p.astype(np.int64),
                                      options=tserving.RequestOptions(
                                          max_new=n, **opts)))
        outs.append({r.rid: r.output for r in b.run()})
        if spec:
            s = b.metrics.summary()["speculative"]
            assert s["accepted_tokens"] > 0
    assert outs[0] == outs[1]


def test_speculative_survives_tiny_pool_preemption(stack):
    """An overcommitted pool (6 blocks) preempts mid-flight and windows
    shrink to the backing left: lockstep with the reference's batcher,
    the same streams, both equal to the fp oracle."""
    jm, jp, tm, tp, _ = stack
    sc = dict(num_blocks=1 + 6, speculative=True, draft_precision="8x8",
              draft_k=3)
    jb = jkv.PagedBatcher(jm, jp, dataclasses.replace(
        _config(jserving, **sc), n_slots=2))
    tb = tkv.PagedBatcher(tm, tp, dataclasses.replace(
        _config(tserving, **sc), n_slots=2))
    v = tm.cfg.vocab
    prompts = [_prompt(5, 3, v), _prompt(7, 4, v), _prompt(4, 5, v)]
    budgets = [10, 8, 10]
    want, got = _lockstep(jb, tb, prompts, budgets)
    assert got == want == {i: _oracle(stack, p, n)
                           for i, (p, n) in enumerate(zip(prompts, budgets))}
    assert tb.metrics.preemptions == jb.metrics.preemptions > 0
    assert tb.metrics.summary()["speculative"] == \
        jb.metrics.summary()["speculative"]


def test_speculative_refusals_match_reference(stack):
    """A quantized-weight primary and ``draft_k`` 0 are refused with the
    reference's messages; a quantized-activation float-weight primary is
    not."""
    jm, jp, tm, tp, _ = stack
    errs = []
    for pkg, kv, build, cfg, params, init in (
            (jserving, jkv, jbuild, jm.cfg, jp,
             lambda m: m.init(jax.random.PRNGKey(0))),
            (tserving, tkv, build_model, tm.cfg, tp,
             lambda m: m.init(torch.Generator().manual_seed(0), "cpu"))):
        qm = build(dataclasses.replace(cfg, precision="8x8"))
        with pytest.raises(ValueError, match="float-weight primary") as e1:
            kv.PagedBatcher(qm, init(qm), _config(pkg, speculative=True))
        model = build(cfg)
        with pytest.raises(ValueError, match="draft_k") as e2:
            kv.PagedBatcher(model, params, _config(pkg, speculative=True,
                                                   draft_k=0))
        errs.append((str(e1.value), str(e2.value)))
    assert errs[0] == errs[1]


# ---------------------------------------------------------------------------
# the precision-variant registry
# ---------------------------------------------------------------------------
def test_variant_registry_and_tune_plans_match_reference(stack):
    """A speculative batcher registers its primary and draft variants; the
    port's registry holds the same names and configs as the reference's,
    ``variant_tune_plans`` gives the reference's plans (the verify
    window's ``n_slots * (k+1)`` rows included), and ``clear_variants``
    empties both."""
    jm, jp, tm, tp, _ = stack
    jkv.PagedBatcher(jm, jp, _config(jserving, speculative=True,
                                     draft_precision="2xT"))
    tb = tkv.PagedBatcher(tm, tp, _config(tserving, speculative=True,
                                          draft_precision="2xT"))
    jv, tv = jengine.registered_variants(jm.cfg.name), \
        engine.registered_variants(tm.cfg.name)
    assert sorted(tv) == sorted(jv) == ["2xT", "primary"]
    for name in tv:
        assert tv[name].name == name
        assert dataclasses.asdict(tv[name].pcfg) == \
            dataclasses.asdict(jv[name].pcfg)
    assert tv["primary"].params is tp
    assert tv["2xT"].params is tb._draft_params
    assert tv["primary"].pcfg == signed(get_precision("fp32"))
    assert jv["2xT"].pcfg == jsigned(jget_precision("2xT"))
    kw = dict(n_slots=3, chunk_size=CHUNK, draft_window=3)
    jplans = jengine.variant_tune_plans(jm.cfg, **kw)
    tplans = engine.variant_tune_plans(tm.cfg, **kw)
    assert {k: [tuple(s) for s in v] for k, v in tplans.items()} == \
        {k: [tuple(s) for s in v] for k, v in jplans.items()}
    assert any(m == 12 for m, _, _ in tplans["2xT"])
    engine.register_variant("other", "x", tv["2xT"].pcfg, None)
    engine.clear_variants(tm.cfg.name)
    assert engine.registered_variants(tm.cfg.name) == {}
    assert list(engine.registered_variants("other")) == ["x"]
    engine.clear_variants()
    assert engine.registered_variants("other") == {}


# ---------------------------------------------------------------------------
# the flight recorder
# ---------------------------------------------------------------------------
def _scheduler_events(doc):
    return [{k: v for k, v in e.items() if k not in ("ts", "dur", "tid")}
            for e in doc["traceEvents"] if e["ph"] != "M"
            and e.get("cat") not in ("engine", "profile")
            and e.get("name") != "tuning_cache"]


def test_speculative_trace_matches_reference(stack):
    """A traced speculative run records the same scheduler events as the
    reference's (``draft`` / ``verify`` spans, ``spec_round`` instants with
    their drafted / accepted counts, in the same order); with the profiler
    on, the port's summary has a ``verify`` step kind."""
    jm, jp, tm, tp, _ = stack
    prompts = _prompts(tm.cfg.vocab)
    docs = []
    for pkg, kv, tracing, model, params in (
            (jserving, jkv, jtracing, jm, jp),
            (tserving, tkv, ttracing, tm, tp)):
        b = kv.PagedBatcher(model, params, _config(
            pkg, speculative=True, draft_precision="8x8",
            trace=tracing.TraceConfig(profile=pkg is tserving)))
        _submit(b, pkg, prompts, BUDGETS)
        b.run()
        b.tracer.detach_engine()
        docs.append(_scheduler_events(b.tracer.to_perfetto()))
        if pkg is tserving:
            assert b.profiler.summary()["verify"]["steps"] == \
                b.metrics.decode_steps
    assert docs[0] == docs[1]
    names = [e["name"] for e in docs[1]]
    assert {"draft", "verify", "spec_round"} <= set(names)
    rounds = [e["args"] for e in docs[1] if e["name"] == "spec_round"]
    assert sum(a["accepted"] for a in rounds) > 0
