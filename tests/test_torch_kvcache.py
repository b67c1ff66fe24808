"""Port parity: the paged KV-cache serving path of ``repro_torch`` against
``repro`` — block pool and radix tree on one scripted sequence, the paged
model entry points, and the ``PagedBatcher`` on a ragged, prefix-heavy
schedule over a tiny pool (preemption, eviction, suffix sharing), stepped in
lockstep with the reference's batcher.

Models are the reduced smollm in f32 from the reference's own params
(through ``interop``); low-bit configs are held in f32 on the CPU (a bf16
rounding step can flip a 2-bit activation code).  Logit tolerance atol 1e-4
(f32 summation order, as tests/test_torch_model.py); greedy streams, page
tables, pool codes and counters must be identical.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_testing import one_thread, reference_jit  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import reduce_for_smoke  # noqa: E402
from repro.models import to_serving as jto_serving  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.runtime import kvcache as jkv  # noqa: E402
from repro.runtime import serving as jserving  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import reduce_for_smoke as treduce  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.runtime import errors as terrors  # noqa: E402
from repro_torch.runtime import kvcache as tkv  # noqa: E402
from repro_torch.runtime import serving as tserving  # noqa: E402

S_MAX, CHUNK, BS = 32, 8, 8
COUNTERS = ("decode_steps", "prefill_chunks", "decode_slot_tokens",
            "tokens_out", "prompt_tokens", "prefix_lookups", "prefix_hits",
            "prefix_hit_tokens", "suffix_hits", "suffix_hit_tokens",
            "preemptions", "recomputed_tokens", "blocks_evicted",
            "kv_blocks_in_use", "kv_blocks_peak", "kv_blocks_total",
            "requests_active_peak")


@pytest.fixture(autouse=True)
def _tuning_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "tuning.json"))


_MODELS = {}


def _pair(precision):
    """(jax model, jax serving params, port model, port serving params) of
    the reduced smollm with ``kv_bits=0`` (the paged batcher owns KV
    quantization).  Init and conversion run under ``jax.jit`` (eager they
    take seconds); both packages get these same params."""
    if precision not in _MODELS:
        jcfg = dataclasses.replace(reduce_for_smoke(jget_config(
            "smollm-135m", precision=precision, kv_bits=0)), dtype="float32")
        tcfg = dataclasses.replace(treduce(get_config(
            "smollm-135m", precision=precision, kv_bits=0)), dtype="float32")
        jm = jbuild(jcfg)
        jsv = reference_jit(lambda key: jto_serving(jm.init(key), jcfg))(
            jax.random.PRNGKey(0))
        tp = params_from_numpy(jax.tree_util.tree_map(np.array, jsv), "cpu")
        _MODELS[precision] = (jm, jsv, build_model(tcfg), tp)
    return _MODELS[precision]


# ---------------------------------------------------------------------------
# block pool + radix tree
# ---------------------------------------------------------------------------
def _script(pkg):
    """One scripted sequence of pool/radix operations; returns everything
    observable: block ids, refcounts, matches, evictions, free counts."""
    pool = pkg.BlockPool(10)
    radix = pkg.RadixPrefixCache(pool, 4)
    log = []
    a = pool.alloc(3)
    b = pool.alloc(2)
    log += [a, b, pool.alloc(9), pool.free_blocks, pool.used_blocks]
    toks_a = np.arange(14, dtype=np.int32)
    toks_b = np.concatenate([np.arange(8), 100 + np.arange(6)]).astype(
        np.int32)
    log.append(radix.insert(toks_a, a, suffix_from=2))
    log.append(radix.insert(toks_b, [a[0], a[1]] + b[:1], suffix_from=3))
    log.append(radix.match_with_kinds(toks_a))
    log.append(radix.match_with_kinds(toks_b[:12]))
    log.append(radix.match(np.arange(3, dtype=np.int32)))
    for bid in a + b:
        pool.release(bid)
    log.append([pool.refcount(i) for i in range(10)])
    log.append(sorted(radix.blocks()))
    c = pool.alloc(4)
    log.append(c)
    log.append(radix.evict(1, freeable_only=True))
    log.append(sorted(radix.blocks()))
    pool.acquire(a[0])
    log.append(radix.evict(5, freeable_only=True))
    log.append([pool.refcount(i) for i in range(10)])
    log.append(radix.evict(5))
    log += [len(radix), pool.free_blocks, pool.peak_used,
            [pool.refcount(i) for i in range(10)]]
    pool.release(a[0])
    for bid in c:
        pool.release(bid)
    pool.check([], radix.blocks())
    log.append(pool.alloc(9))
    return log


def test_pool_and_radix_match_reference():
    assert _script(tkv) == _script(jkv)


def test_pool_check_guards_match_reference():
    for pkg in (tkv, jkv):
        pool = pkg.BlockPool(4)
        blocks = pool.alloc(2)
        with pytest.raises(RuntimeError, match="leaked"):
            pool.check([blocks[:1]])
        pool.check([blocks])
        with pytest.raises(ValueError):
            pool.release(0)
        with pytest.raises(ValueError):
            pkg.BlockPool(1)


# ---------------------------------------------------------------------------
# paged model entry points
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("precision,kv_bits",
                         [("2xT", 8), ("2xT", 4), ("fp32", 16), ("fp32", 8)])
def test_paged_steps_match_reference(precision, kv_bits):
    """Two prefill chunks through a page table (the second starting past
    0), then one decode step over three slots, fused and unfused: logits
    within atol 1e-4, pool codes equal (scales and raw KV within rtol
    1e-5)."""
    jm, jsv, tm, tp = _pair(precision)
    nb_pool, nb = 10, S_MAX // BS
    jpool = jtfm.make_pool(jm.cfg, nb_pool, BS, kv_bits)
    tpool = tfm.make_pool(tm.cfg, nb_pool, BS, kv_bits, "cpu")
    toks = np.random.default_rng(0).integers(0, 500, (1, 16)).astype(np.int32)
    row = np.array([[4, 7, 0, 0]], np.int32)
    for start in (0, 8):
        chunk = toks[:, start:start + CHUNK]
        lj, jpool = jm.prefill_chunk_paged(jsv, jnp.asarray(chunk), jpool,
                                           jnp.asarray(row), start, kv_bits)
        lt, tpool = tm.prefill_chunk_paged(tp, torch.from_numpy(chunk).long(),
                                           tpool, torch.from_numpy(row),
                                           start, kv_bits)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
    pt = np.array([[4, 7, 5, 0], [4, 2, 0, 0], [0, 0, 0, 0]], np.int32)
    pos = np.array([16, 9, 3], np.int32)       # slot 2's row is zeroed: dead
    step = toks[:3, -1:].repeat(3, 0)
    for fused in (True, False):
        jp, tq = jax.tree_util.tree_map(jnp.copy, jpool), \
            {k: {n: t.clone() for n, t in v.items()} for k, v in tpool.items()}
        lj, jp = jm.decode_step_paged(jsv, jnp.asarray(step), jp,
                                      jnp.asarray(pt), jnp.asarray(pos),
                                      kv_bits, fused=fused)
        lt, tq = tm.decode_step_paged(tp, torch.from_numpy(step).long(), tq,
                                      torch.from_numpy(pt),
                                      torch.from_numpy(pos), kv_bits,
                                      fused=fused)
        np.testing.assert_allclose(lt.numpy()[:2], np.asarray(lj)[:2],
                                   atol=1e-4, err_msg=f"fused={fused}")
        for name, leaf in tq["layer_0"].items():
            want = np.asarray(jp["layer_0"][name])
            got = leaf.numpy()
            # block 0 holds the dead slot's row; raw KV and scales are f32
            # values (summation order: 1e-5), codes must be equal
            if got.dtype == np.int8:
                np.testing.assert_array_equal(got[:, 1:], want[:, 1:],
                                              err_msg=name)
            else:
                np.testing.assert_allclose(got[:, 1:], want[:, 1:],
                                           rtol=1e-5, atol=1e-5, err_msg=name)


# ---------------------------------------------------------------------------
# the paged batcher
# ---------------------------------------------------------------------------
PROMPT_LENS = [20, 17, 9, 24, 18, 12, 21]
MAX_NEW = [7, 8, 5, 6, 4, 8, 6]


def _prompts():
    """Prefix-heavy: five prompts share a 16-token prefix (two blocks);
    one shares a different 8-token prefix; one stands alone."""
    rng = np.random.default_rng(11)
    base = rng.integers(0, 500, 16)
    other = rng.integers(0, 500, 8)
    out = []
    for i, n in enumerate(PROMPT_LENS):
        head = base if i in (0, 1, 3, 4, 6) else (other if i == 5 else
                                                 rng.integers(0, 500, 8))
        tail = rng.integers(0, 500, max(n - len(head), 0))
        out.append(np.concatenate([head, tail])[:n][None].astype(np.int32))
    return out


def _batcher(pkg, model, params, **kw):
    sc = pkg.ServingConfig(n_slots=3, s_max=S_MAX, chunk_size=CHUNK,
                           block_size=BS, **kw)
    return jkv.PagedBatcher(model, params, sc) if pkg is jserving else \
        tkv.PagedBatcher(model, params, sc)


def _lockstep(jb, tbs, prompts, max_new=MAX_NEW):
    """Submit the same requests to the reference batcher and the port's
    batchers ``tbs`` and step them together, checking every port batcher's
    page table and stalls against the reference's after every step, and
    every pool's invariants; returns the reference's streams, each port
    batcher's streams, and the most slots stalled at once."""
    for rid, (p, n) in enumerate(zip(prompts, max_new)):
        jb.submit(jserving.Request(
            rid, p, options=jserving.RequestOptions(max_new=n)))
        for tb in tbs:
            tb.submit(tserving.Request(
                rid, p.astype(np.int64),
                options=tserving.RequestOptions(max_new=n)))
    jdone, tdone, stalled = [], [[] for _ in tbs], 0
    for _ in range(400):
        jdone += jb.step()
        jb.check_pool()
        for tb, done in zip(tbs, tdone):
            done += tb.step()
            np.testing.assert_array_equal(tb._pt, np.asarray(jb._pt))
            np.testing.assert_array_equal(tb.stalled, jb.stalled)
            tb.check_pool()
        stalled = max(stalled, int(jb.stalled.sum()))
        if jb.idle and all(tb.idle for tb in tbs):
            break
    assert jb.idle and all(tb.idle for tb in tbs)
    streams = lambda done: {r.rid: list(r.output) for r in done}
    return streams(jdone), [streams(d) for d in tdone], stalled


CONFIGS = [("2xT", 8), ("2xT", 4), ("fp32", 16), ("fp32", 8)]
# the port's decode variants: (fused_decode, ragged_decode)
VARIANTS = [(True, True), (False, True), (True, False)]


@pytest.mark.parametrize("precision,kv_bits", CONFIGS,
                         ids=[f"{p}-kv{k}" for p, k in CONFIGS])
def test_paged_batcher_matches_reference(precision, kv_bits):
    """Seven prefix-heavy requests over three slots and a 6-block pool, the
    reference's (fused, ragged) batcher against the port's fused, unfused
    and padded (fused, n_slots rows) batchers, in lockstep: identical
    greedy streams, page tables and stalls after every step, and equal
    kv/prefix/preemption counters; every pool's invariants hold after every
    step.  (The reference's own streams do not depend on fused or ragged.)
    """
    jm, jsv, tm, tp = _pair(precision)
    jb = _batcher(jserving, jm, jsv, kv_bits=kv_bits, num_blocks=7)
    tbs = [_batcher(tserving, tm, tp, kv_bits=kv_bits, num_blocks=7,
                    fused_decode=f, ragged_decode=r) for f, r in VARIANTS]
    want, gots, _ = _lockstep(jb, tbs, _prompts())
    assert [len(want[i]) for i in range(len(MAX_NEW))] == MAX_NEW
    for (fused, ragged), tb, got in zip(VARIANTS, tbs, gots):
        assert got == want, (fused, ragged)
        for name in COUNTERS:
            assert getattr(tb.metrics, name) == getattr(jb.metrics, name), \
                (name, fused, ragged)
        assert sorted(tb.radix.blocks()) == sorted(jb.radix.blocks())
    assert jb.metrics.preemptions > 0 and jb.metrics.prefix_hit_tokens > 0


def test_preemption_off_stalls_then_deadlock_raises():
    """preemption="off": a starved slot stalls (same stalls as the
    reference, checked per step) and the run completes; a pool that every
    active slot starves on raises the deadlock error, as the reference."""
    jm, jsv, tm, tp = _pair("fp32")
    kw = dict(kv_bits=8, num_blocks=5, preemption="off")
    p = _prompts()
    prompts = [p[0][:, :12], p[1][:, :12], p[2][:, :4]]
    jb = _batcher(jserving, jm, jsv, **kw)
    want, (got,), stalled = _lockstep(
        jb, [_batcher(tserving, tm, tp, **kw)], prompts, max_new=[10, 10, 4])
    assert got == want and stalled > 0
    errs = []
    for pkg, model, params in ((jserving, jm, jsv), (tserving, tm, tp)):
        b = _batcher(pkg, model, params, kv_bits=8, num_blocks=5,
                     preemption="off", prefix_cache=False)
        for rid, p in enumerate(_prompts()[:2]):
            b.submit(pkg.Request(rid, p[:, :15].astype(np.int64),
                                 options=pkg.RequestOptions(max_new=8)))
        with pytest.raises(RuntimeError, match="pool deadlock") as ei:
            b.run()
        errs.append(str(ei.value))
    assert errs[0] == errs[1]


def test_pool_footprint_error_matches_reference():
    jm, jsv, tm, tp = _pair("fp32")
    errs = []
    for pkg, model, params in ((jserving, jm, jsv), (tserving, tm, tp)):
        b = _batcher(pkg, model, params, kv_bits=8, num_blocks=3)
        with pytest.raises(ValueError) as ei:
            b.submit(pkg.Request(4, np.zeros((1, 20), np.int32),
                                 options=pkg.RequestOptions(max_new=6)))
        errs.append(ei.value)
    j, t = errs
    assert isinstance(t, terrors.PoolFootprintError)
    assert type(t).__name__ == type(j).__name__ and str(t) == str(j)
    assert vars(t) == vars(j)


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_paged_streams_equal_dense(kv_bits):
    """Inside the port: paged kv16 gives the dense batcher's unquantized
    streams, paged kv8 the dense kv8 streams (same schedule, no
    preemption)."""
    _, _, tm, tp = _pair("2xT")
    dense = build_model(dataclasses.replace(
        tm.cfg, kv_bits=0 if kv_bits == 16 else kv_bits))
    prompts = [p.astype(np.int64) for p in _prompts()]
    outs = []
    for batcher in (
            tkv.PagedBatcher(tm, tp, tserving.ServingConfig(
                n_slots=3, s_max=S_MAX, chunk_size=CHUNK, block_size=BS,
                kv_bits=kv_bits)),
            tserving.ContinuousBatcher(dense, tp, tserving.ServingConfig(
                n_slots=3, s_max=S_MAX, chunk_size=CHUNK))):
        for rid, (p, n) in enumerate(zip(prompts, MAX_NEW)):
            batcher.submit(tserving.Request(
                rid, p, options=tserving.RequestOptions(max_new=n)))
        outs.append({r.rid: r.output for r in batcher.run()})
    assert outs[0] == outs[1]


def test_launcher_paged_cpu(capsys):
    done = tserve.main(["--paged", "--reduced", "--device", "cpu",
                        "--requests", "4", "--slots", "2", "--prompt-len",
                        "12", "--gen", "3", "--kv-bits", "0"])
    assert sorted(len(r.output) for r in done) == [3, 3, 3, 3]
    out = capsys.readouterr().out
    assert "paged KV cache:" in out and "kv_bits=16" in out
    assert "paged_attention=0" in out and "fused_decode=0" in out
    # --kv-block-size 0: the tuning cache's pick (cold here: the default)
    done = tserve.main(["--paged", "--reduced", "--device", "cpu",
                        "--requests", "2", "--prompt-len", "12", "--gen", "3",
                        "--kv-block-size", "0"])
    assert sorted(len(r.output) for r in done) == [3, 3]
    out = capsys.readouterr().out
    assert "--kv-block-size 0 -> 16 (tuning-cache pick)" in out
    assert "16 positions at kv_bits=8" in out
