"""Port parity: the adaptive precision server (``repro_torch.runtime.
adaptive``) and its policy layer (``runtime.policy``) against ``repro``.

* ``BrownoutController``, ``simulate_policy``, ``search_policy``,
  ``bursty_trace`` and the stock SLO classes equal the reference's on the
  same inputs.
* ``AdaptiveServer`` on a spike against premium requests already active
  (four rungs: kv 16 with speculation, kv 8, kv 4, the 8x8 weights at
  kv 4): each request's ``routed_rung``, the streams, ``brownout_raises``
  and ``degraded_admissions`` equal the reference's; premium stays on rung
  0 and its streams equal an unloaded run's and the sequential fp
  oracle's (brownout isolation).  The same spike under a shared byte budget
  (``ByteLedger``): the bound after every step, and the reference's
  routing and streams.  ``UnknownSLOClassError``'s fields, the per-class
  SLO keys, and the traced run's scheduler events (lane tracks, the
  ``brownout`` instants, the speculative lane's ``draft`` / ``verify``
  spans) against the reference's.
* The launcher's ``--brownout --speculative --slo mixed`` on the CPU, and
  its refusal of a quantized primary.

The reduced smollm in float32 with the reference's own params (through
``interop``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_testing import one_thread, reference_jit  # noqa: E402,F401
import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.kernels import engine as jengine  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import reduce_for_smoke  # noqa: E402
from repro.runtime import adaptive as jadaptive  # noqa: E402
from repro.runtime import errors as jerrors  # noqa: E402
from repro.runtime import policy as jpolicy  # noqa: E402
from repro.runtime import serving as jserving  # noqa: E402
from repro.runtime import tracing as jtracing  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import engine  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import reduce_for_smoke as treduce  # noqa: E402
from repro_torch.runtime import adaptive as tadaptive  # noqa: E402
from repro_torch.runtime import errors as terrors  # noqa: E402
from repro_torch.runtime import policy as tpolicy  # noqa: E402
from repro_torch.runtime import serving as tserving  # noqa: E402
from repro_torch.runtime import tracing as ttracing  # noqa: E402
from repro_torch.runtime.kvcache import paged_block_bytes  # noqa: E402

S_MAX, CHUNK, BLOCK = 24, 4, 4
N_PREMIUM, N_SPIKE = 2, 8


@pytest.fixture(autouse=True)
def _tuning_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "tuning.json"))
    yield
    engine.clear_variants()
    jengine.clear_variants()
    engine.set_dispatch_listener(None)


# ---------------------------------------------------------------------------
# the policy layer (host-side)
# ---------------------------------------------------------------------------
def test_slo_classes_and_ladder_match_reference():
    assert tpolicy.DEFAULT_KV_LADDER == jpolicy.DEFAULT_KV_LADDER
    t, j = tpolicy.default_slo_classes(), jpolicy.default_slo_classes()
    assert {k: dataclasses.asdict(v) for k, v in t.items()} == \
        {k: dataclasses.asdict(v) for k, v in j.items()}
    assert dataclasses.asdict(tpolicy.BrownoutPolicy()) == \
        dataclasses.asdict(jpolicy.BrownoutPolicy())


@pytest.mark.parametrize("cool,max_level", [(3, 3), (1, 2), (8, 1)])
def test_brownout_controller_matches_reference(cool, max_level):
    """One seeded series of controller signals (hot, calm and neither)
    through both controllers: the same rung after every observation, the
    same route levels per class, the same raise / lower counts."""
    rng = np.random.default_rng(cool * 10 + max_level)
    ctls = [pkg.BrownoutController(pkg.BrownoutPolicy(
        cool_steps=cool, max_level=max_level)) for pkg in (tpolicy, jpolicy)]
    classes = [pkg.default_slo_classes() for pkg in (tpolicy, jpolicy)]
    for _ in range(200):
        sig = {"pool_utilization": float(rng.choice([0.0, 0.7, 0.95])),
               "queue_per_slot": float(rng.choice([0.0, 1.0, 3.0]))}
        levels = [c.observe(sig) for c in ctls]
        assert levels[0] == levels[1]
        for name in classes[0]:
            assert ctls[0].route_level(classes[0][name]) == \
                ctls[1].route_level(classes[1][name])
    assert (ctls[0].raises, ctls[0].lowers) == (ctls[1].raises,
                                                ctls[1].lowers)
    assert ctls[0].raises > 0


@pytest.mark.parametrize("trace_kw", [dict(), dict(n_steps=96, burst_every=16,
                                                   burst=10, base=1)])
def test_simulate_and_search_policy_match_reference(trace_kw):
    trace = tpolicy.bursty_trace(**trace_kw)
    assert trace == jpolicy.bursty_trace(**trace_kw)
    for kw in (dict(), dict(max_level=0), dict(pool_high=0.7, cool_steps=2)):
        assert tpolicy.simulate_policy(tpolicy.BrownoutPolicy(**kw), trace) \
            == jpolicy.simulate_policy(jpolicy.BrownoutPolicy(**kw), trace)
    tp, tout = tpolicy.search_policy(trace, iters=24, capacity=3.0)
    jp, jout = jpolicy.search_policy(trace, iters=24, capacity=3.0)
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    assert tout == jout


# ---------------------------------------------------------------------------
# the adaptive server
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def stack():
    jcfg = dataclasses.replace(reduce_for_smoke(jget_config(
        "smollm-135m", precision="fp32", kv_bits=0)), dtype="float32")
    tcfg = dataclasses.replace(treduce(get_config(
        "smollm-135m", precision="fp32", kv_bits=0)), dtype="float32")
    jm = jbuild(jcfg)
    jp = reference_jit(jm.init)(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.array, jp), "cpu")
    return {"ref": (jserving, jadaptive, jtracing, jpolicy, jm, jp, np.int32),
            "port": (tserving, tadaptive, ttracing, tpolicy,
                     build_model(tcfg), tp, np.int64)}


def _prompt(length, salt, vocab, dtype):
    rng = np.random.default_rng(1009 * length + salt)
    return rng.integers(0, vocab, (1, length)).astype(dtype)


def _server(side, *, pool_blocks=None, pool_bytes=None, trace=False):
    """Four rungs (the stock SLO classes; a policy that raises on one
    queued request per free slot), speculation on rung 0 with the 8x8
    draft, which is rung 3's weights too."""
    pkg, adaptive, tracing, policy, model, params, _ = side
    return adaptive.AdaptiveServer(model, params, pkg.ServingConfig(
        n_slots=2, s_max=S_MAX, chunk_size=CHUNK, block_size=BLOCK,
        num_blocks=None if pool_blocks is None else 1 + pool_blocks,
        pool_bytes=pool_bytes, brownout=True,
        brownout_policy=policy.BrownoutPolicy(
            queue_high=1.0, queue_low=0.25, cool_steps=4, max_level=3),
        speculative=True, draft_precision="8x8", draft_k=3,
        trace=tracing.TraceConfig() if trace else None))


def _premium(side):
    pkg, _, _, _, model, _, dtype = side
    return [pkg.Request(i, _prompt(5, 100 + i, model.cfg.vocab, dtype),
                        options=pkg.RequestOptions(max_new=12,
                                                   slo="premium"))
            for i in range(N_PREMIUM)]


def _spike(side):
    pkg, _, _, _, model, _, dtype = side
    return [pkg.Request(100 + j, _prompt(3 + j % 3, 200 + j,
                                         model.cfg.vocab, dtype),
                        options=pkg.RequestOptions(
                            max_new=4, slo=("standard", "batch")[j % 2]))
            for j in range(N_SPIKE)]


def _run_spike(srv, side, each_step=None):
    """Premium requests go active, then the spike arrives; returns the
    finished requests."""
    for r in _premium(side):
        srv.submit(r)
    done = []
    for _ in range(4):
        done += srv.step()
    for r in _spike(side):
        srv.submit(r)
    for _ in range(3000):
        if srv.idle:
            break
        done += srv.step()
        if each_step is not None:
            each_step(srv)
    assert srv.idle
    return done


def _outcome(srv, done):
    return ({r.rid: list(r.output) for r in done},
            {r.rid: r.routed_rung for r in done},
            srv.metrics.brownout_raises, srv.metrics.degraded_admissions)


def _scheduler_events(doc):
    """Scheduler events without timestamps, tracks, engine / profile
    events, and the brownout instant's latency tails (wall-clock)."""
    out = []
    for e in doc["traceEvents"]:
        if e["ph"] == "M" or e.get("cat") in ("engine", "profile") \
                or e.get("name") == "tuning_cache":
            continue
        e = {k: v for k, v in e.items() if k not in ("ts", "dur", "tid")}
        if e["name"] == "brownout":
            e["args"] = {k: v for k, v in e["args"].items()
                         if k not in ("ttft_p90_ms", "itl_p90_ms")}
        out.append(e)
    return out


def _tracks(doc):
    return sorted(e["args"]["name"] for e in doc["traceEvents"]
                  if e["ph"] == "M" and e["name"] == "thread_name")


@pytest.fixture(scope="module")
def spike(stack):
    """The traced spike on both servers (block pools of 14 each)."""
    out = {}
    for name, side in stack.items():
        srv = _server(side, pool_blocks=14, trace=True)
        done = _run_spike(srv, side)
        srv.tracer.detach_engine()
        out[name] = (srv, done, srv.tracer.to_perfetto())
    return out


def test_adaptive_routing_and_streams_match_reference(stack, spike):
    (jsrv, jdone, _), (tsrv, tdone, _) = spike["ref"], spike["port"]
    assert _outcome(tsrv, tdone) == _outcome(jsrv, jdone)
    rids = sorted(r.rid for r in tdone)
    assert rids == list(range(N_PREMIUM)) + [100 + j for j in range(N_SPIKE)]
    assert len(tsrv.lanes) == 4
    assert [lane.kv_bits for lane in tsrv.lanes] == [16, 8, 4, 4]
    assert tsrv.lanes[0].spec and not tsrv.lanes[3].spec
    assert tsrv.lanes[3].model.cfg.precision == "8x8"
    rungs = {r.rid: r.routed_rung for r in tdone}
    assert all(rungs[i] == 0 for i in range(N_PREMIUM))
    assert tsrv.metrics.brownout_raises > 0
    assert tsrv.metrics.degraded_admissions > 0
    assert set(rungs.values()) > {0}
    tsrv.check_pool()
    sj, st = jsrv.metrics.summary(), tsrv.metrics.summary()
    assert st["speculative"] == sj["speculative"]
    assert st["speculative"]["verify_steps"] > 0


def test_brownout_never_changes_active_streams(stack, spike):
    """Premium streams of the loaded run equal an unloaded run's (premium
    alone) and the port's sequential fp-greedy stream."""
    side = stack["port"]
    _, _, _, _, model, params, _ = side
    _, tdone, _ = spike["port"]
    base_srv = _server(side, pool_blocks=14)
    for r in _premium(side):
        base_srv.submit(r)
    base = {r.rid: r.output for r in base_srv.run()}
    loaded = {r.rid: r.output for r in tdone if r.rid < N_PREMIUM}
    assert loaded == base
    for r in _premium(side):
        logits, cache = model.prefill(
            params, {"tokens": torch.from_numpy(r.tokens)}, S_MAX)
        out, pos = [int(logits[0, -1].argmax())], r.tokens.shape[1]
        while len(out) < r.max_new:
            logits, cache = model.decode_step(
                params, torch.tensor([[out[-1]]]), cache, pos)
            out.append(int(logits[0, 0].argmax()))
            pos += 1
        assert base[r.rid] == out


def test_adaptive_trace_matches_reference(spike):
    """Scheduler events of the traced spike (lane tracks included) equal
    the reference's: the ``brownout`` instants with their controller
    signals, the rung-0 lane's ``draft`` / ``verify`` spans and
    ``spec_round`` instants, admissions and finishes per lane."""
    jdoc, tdoc = spike["ref"][2], spike["port"][2]
    assert _scheduler_events(tdoc) == _scheduler_events(jdoc)
    assert _tracks(tdoc) == _tracks(jdoc)
    names = {e["name"] for e in _scheduler_events(tdoc)}
    assert {"brownout", "draft", "verify", "spec_round", "admit",
            "finish"} <= names
    assert {"server", "rung0-kv16-spec", "rung3-kv4"} <= set(_tracks(tdoc))


def test_slo_attainment_reported_per_class(spike):
    (jsrv, _, _), (tsrv, _, _) = spike["ref"], spike["port"]
    js, ts = jsrv.summary()["slo"], tsrv.summary()["slo"]
    assert set(ts) == set(js) == {"premium", "standard", "batch"}
    for name in ts:
        assert ts[name]["finished"] == js[name]["finished"]
        assert ts[name]["target"] == js[name]["target"]
        assert 0.0 <= ts[name]["attainment"] <= 1.0
    assert ts["premium"]["finished"] == N_PREMIUM


def test_byte_ledger_enforces_shared_budget(stack):
    """Lanes sharing ten kv16 blocks' worth of bytes: the ledger prices a
    kv16 block above a kv4 one, the bound holds after every step (through
    ``check_pool``), and routing and streams equal the reference's."""
    outs = []
    for name in ("ref", "port"):
        side = stack[name]
        b16 = paged_block_bytes(side[4].cfg, BLOCK, 16)
        srv = _server(side, pool_bytes=10 * b16)
        ledger = srv.ledger
        assert ledger.budget_bytes == 10 * b16
        assert ledger.block_bytes(srv.lanes[0]) > \
            ledger.block_bytes(srv.lanes[2])
        peak = []

        def check(s):
            s.check_pool()
            peak.append(s.ledger.used_bytes())
        done = _run_spike(srv, side, each_step=check)
        assert max(peak) <= ledger.budget_bytes
        outs.append(_outcome(srv, done))
        if name == "port":
            assert isinstance(ledger, tadaptive.ByteLedger)
            assert all(lane._ledger is ledger for lane in srv.lanes)
    assert outs[0] == outs[1]


def test_byte_ledger_overrun_fails_check_pool(stack):
    side = stack["port"]
    srv = _server(side, pool_bytes=1 << 20)
    srv.submit(_premium(side)[0])
    srv.step()                       # admission holds the prompt's blocks
    assert srv.ledger.used_bytes() > 0
    srv.check_pool()
    srv.ledger.budget_bytes = srv.ledger.used_bytes() - 1
    with pytest.raises(AssertionError, match="byte ledger overrun"):
        srv.check_pool()


def test_unknown_slo_class_error_fields(stack):
    errs = []
    for name, errors in (("ref", jerrors), ("port", terrors)):
        side = stack[name]
        pkg, _, _, _, model, _, dtype = side
        srv = _server(side, pool_blocks=12)
        with pytest.raises(errors.UnknownSLOClassError) as ei:
            srv.submit(pkg.Request(7, _prompt(4, 0, model.cfg.vocab, dtype),
                                   options=pkg.RequestOptions(
                                       slo="platinum")))
        errs.append(ei.value)
    j, t = errs
    assert (t.rid, t.slo, t.classes) == (7, "platinum",
                                         ("batch", "premium", "standard"))
    assert str(t) == str(j) and vars(t) == vars(j)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def test_launcher_brownout_speculative_cpu(capsys):
    done = tserve.main(["--device", "cpu", "--reduced", "--precision",
                        "fp32", "--brownout", "--speculative", "--slo",
                        "mixed", "--requests", "6", "--slots", "2",
                        "--prompt-len", "12", "--gen", "4", "--profile"])
    assert sorted(len(r.output) for r in done) == [4] * 6
    assert {r.slo for r in done} == {"premium", "standard", "batch"}
    out = capsys.readouterr().out
    assert "adaptive serving: 4 precision lanes (rung 0 speculative, kv " \
        "ladder 16/8/4, rung 3 = 2xT weights)" in out
    assert "SLO classes: ['batch', 'premium', 'standard']" in out
    assert "profile[verify]" in out and "profile[prefill_chunk]" in out
    done = tserve.main(["--device", "cpu", "--reduced", "--precision",
                        "fp32", "--speculative", "--draft-precision", "8x8",
                        "--draft-k", "2", "--requests", "3", "--slots", "2",
                        "--prompt-len", "12", "--gen", "4"])
    assert sorted(len(r.output) for r in done) == [4] * 3
    out = capsys.readouterr().out
    assert "paged KV cache:" in out
    assert "self-speculative decoding: 8x8 draft, k=2, fp-verified " \
        "(lossless)" in out


@pytest.mark.parametrize("flag", ["--speculative", "--brownout"])
def test_launcher_refuses_quantized_primary(flag):
    with pytest.raises(SystemExit, match="need a float primary"):
        tserve.main(["--device", "cpu", "--reduced", "--precision", "2xT",
                     flag])
