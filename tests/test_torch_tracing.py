"""Port parity: the serving flight recorder (``repro_torch.runtime.tracing``,
``runtime.profile``) against ``repro.runtime.tracing``.

* The reference's tracer unit tests (ring, export sanitization, crash
  dump, coverage, snapshots, profiler), run against the port's module.
* The reference's and the port's ``Tracer`` driven with one scripted event
  sequence (ring overflow included) export equal Perfetto documents once
  timestamps are stripped.
* The reference's and the port's batchers, traced on one workload, record
  the same scheduler events in the same order.
* Traced serving: streams equal the untraced run's, dense and paged, with
  and without the profiler; the document validates, its step spans cover
  the serving window, engine dispatches appear once per distinct event,
  and the tuning cache's counter is on the engine track.  An ``on_token`` that raises makes ``run()`` dump the ring and
  re-raise.  The launcher's sampling and observability flags run, dense
  and paged.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_testing import one_thread, reference_jit  # noqa: E402,F401
import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import reduce_for_smoke  # noqa: E402
from repro.models import to_serving as jto_serving  # noqa: E402
from repro.runtime import kvcache as jkv  # noqa: E402
from repro.runtime import serving as jserving  # noqa: E402
from repro.runtime import tracing as jtracing  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import engine  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import reduce_for_smoke as treduce  # noqa: E402
from repro_torch.runtime import (ContinuousBatcher, PagedBatcher,  # noqa: E402
                                 Request, RequestOptions, ServingConfig,
                                 StepProfiler, TraceConfig, Tracer,
                                 span_coverage)
from repro_torch.runtime import kvcache as tkv  # noqa: E402
from repro_torch.runtime import serving as tserving  # noqa: E402
from repro_torch.runtime import tracing as ttracing  # noqa: E402
from repro_torch.runtime.metrics import Metrics  # noqa: E402
from repro_torch.runtime.tracing import (NULL_TRACER,  # noqa: E402
                                         MetricsSnapshotter, _numeric_delta)


@pytest.fixture(autouse=True)
def _tuning_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "tuning.json"))
    yield
    engine.set_dispatch_listener(None)      # never leak a tracer's hook


def _validate_perfetto(doc):
    """Chrome-trace consistency: per-track B/E stacks balance (every B has
    an E, no E without a B), flow t/f edges only for ids that started, X
    events carry ts+dur."""
    stacks = {}
    flow_started = set()
    for e in doc["traceEvents"]:
        ph = e["ph"]
        if ph == "M":
            continue
        assert isinstance(e["ts"], float) and e["pid"] == 1
        if ph == "B":
            stacks.setdefault(e["tid"], []).append(e["name"])
        elif ph == "E":
            st = stacks.get(e["tid"])
            assert st, f"E without B: {e}"
            st.pop()
        elif ph == "X":
            assert e["dur"] >= 0.0
        elif ph == "s":
            flow_started.add(e["id"])
        elif ph in ("t", "f"):
            assert e["id"] in flow_started, f"flow edge before start: {e}"
            if ph == "f":
                assert e["bp"] == "e"
        elif ph == "i":
            assert e["s"] == "t"
    for tid, st in stacks.items():
        assert st == [], f"unclosed spans on tid {tid}: {st}"


# ---------------------------------------------------------------------------
# the reference's tracer unit tests, against the port's module
# ---------------------------------------------------------------------------
def test_ring_drops_oldest_and_counts():
    tr = Tracer(capacity=16)
    for i in range(40):
        tr.instant(f"e{i}", "test")
    assert len(tr.events) == 16
    assert tr.dropped == 24
    names = [e["name"] for e in tr.events]
    assert names == [f"e{i}" for i in range(24, 40)]   # oldest gone
    assert tr.to_perfetto()["otherData"]["dropped_events"] == 24


def test_capacity_floor():
    assert Tracer(capacity=1).capacity == 16


def test_disabled_tracer_records_nothing():
    tr = Tracer(enabled=False)
    tr.begin("a", "t")
    tr.end("a", "t")
    tr.instant("b", "t")
    tr.counter("c", "t", v=1)
    tr.complete("d", "t", 0.0, 1.0)
    tr.flow("s", 0)
    tr.maybe_tuning_counter()
    assert list(tr.events) == [] and tr.dropped == 0
    assert list(NULL_TRACER.events) == []              # shared singleton


def test_from_config_dispatch():
    assert Tracer.from_config(None) is NULL_TRACER
    existing = Tracer()
    assert Tracer.from_config(existing) is existing    # shared tracer
    t = Tracer.from_config(TraceConfig(enabled=True, buffer=64))
    assert t.enabled and t.capacity == 64
    t.detach_engine()                                  # don't leak the hook
    off = Tracer.from_config(TraceConfig(enabled=False))
    assert not off.enabled


def test_orphan_end_pruned_after_overflow():
    tr = Tracer(capacity=16)
    tr.begin("span", "t")                  # its B will fall off the ring
    for i in range(20):
        tr.instant(f"e{i}", "test")
    tr.end("span", "t")                    # orphan E
    doc = tr.to_perfetto()
    _validate_perfetto(doc)
    assert not any(e["ph"] == "E" for e in doc["traceEvents"])


def test_unclosed_begin_gets_synthetic_close():
    tr = Tracer(capacity=64)
    tr.begin("outer", "t")
    tr.begin("inner", "t")
    tr.instant("mark", "test")
    doc = tr.to_perfetto()
    _validate_perfetto(doc)
    closes = [e for e in doc["traceEvents"]
              if e["ph"] == "E" and e["args"].get("synthetic_close")]
    assert [e["name"] for e in closes] == ["inner", "outer"]  # LIFO order


def test_orphan_flow_edges_pruned():
    tr = Tracer(capacity=16)
    tr.flow("s", 7)                        # will fall off the ring
    for i in range(20):
        tr.instant(f"e{i}", "test")
    tr.flow("t", 7)                        # start dropped -> pruned
    tr.flow("s", 9)
    tr.flow("f", 9)                        # intact chain survives
    doc = tr.to_perfetto()
    _validate_perfetto(doc)
    ids = [(e["ph"], e["id"]) for e in doc["traceEvents"]
           if e.get("cat") == "flow"]
    assert ids == [("s", 9), ("f", 9)]


def test_dump_jsonl_header_and_tail(tmp_path):
    tr = Tracer(capacity=64)
    for i in range(10):
        tr.instant(f"e{i}", "test")
    p = tmp_path / "dump.jsonl"
    assert tr.dump_jsonl(str(p), last=4) == 4
    lines = [json.loads(x) for x in p.read_text().splitlines()]
    assert lines[0]["flight_recorder"] is True
    assert [x["name"] for x in lines[1:]] == ["e6", "e7", "e8", "e9"]


def test_span_coverage_union():
    tr = Tracer(capacity=64)
    tr.instant("lo", "t")                  # window anchors
    tr.begin("step", "t")
    tr.end("step", "t")
    tr.begin("step", "t")
    tr.end("step", "t")
    doc = tr.to_perfetto()
    cov = span_coverage(doc)
    assert 0.0 < cov <= 1.0
    assert span_coverage(doc, name="absent") == 0.0
    assert span_coverage({"traceEvents": []}) == 0.0


def test_numeric_delta():
    prev = {"a": 1, "b": {"c": 2.0, "s": "x"}, "gone": 5}
    cur = {"a": 4, "b": {"c": 2.5, "s": "y", "new": 3}, "flag": True}
    d = _numeric_delta(prev, cur)
    assert d == {"a": 3, "b": {"c": 0.5, "new": 3}}    # strings/bools dropped
    assert _numeric_delta(None, {"a": 2}) == {"a": 2}  # first snapshot: vs 0


def test_snapshotter_interval_and_final(tmp_path):
    p = tmp_path / "snaps.jsonl"
    snap = MetricsSnapshotter(str(p), interval=3)
    m = Metrics(n_slots=2)
    for _ in range(7):
        m.decode_steps += 1
        snap.tick(m)
    assert snap.lines_written == 2                     # steps 3 and 6
    snap.final(m)
    lines = [json.loads(x) for x in p.read_text().splitlines()]
    assert len(lines) == 3
    assert all("summary" in x and "t_wall" in x for x in lines)
    # deltas are per-interval: 3 + 3 + 1 decode steps
    deltas = [x["delta"]["scheduler"]["decode_steps"] for x in lines]
    assert deltas == [3, 3, 1]


def test_profiler_summary_and_trace_spans():
    tr = Tracer(capacity=256)
    prof = StepProfiler(tr)
    for _ in range(4):
        with prof.step("decode"):
            sum(range(2000))               # stand-in device work
    s = prof.summary()
    assert s["decode"]["steps"] == 4
    assert s["decode"]["device_ms"]["p50"] >= 0.0
    assert 0.0 <= s["decode"]["host_frac"] <= 1.0
    doc = tr.to_perfetto()
    _validate_perfetto(doc)
    dev = [e for e in doc["traceEvents"] if e.get("name") == "device:decode"]
    assert len(dev) == 4 and all(e["ph"] == "X" for e in dev)


# ---------------------------------------------------------------------------
# one scripted sequence through both packages' tracers
# ---------------------------------------------------------------------------
def _script(tr):
    """Spans (nested, on two tracks, one left open), instants, counters,
    complete events and flows, with enough events to overflow a 48-event
    ring: the oldest spans' B and a flow start fall off it."""
    tr.begin("step", "scheduler", queue_depth=3)
    tr.flow("s", 1)
    tr.begin("prefill_chunk", "scheduler", rid=1, pos=0)
    tr.end("prefill_chunk", "scheduler")
    for i in range(30):
        tr.instant("admit", "scheduler", rid=i, slot=i % 4, prompt_tokens=7)
        tr.counter("kv_blocks", "kvcache", in_use=i, total=40)
    tr.end("step", "scheduler")           # orphaned once its B is dropped
    tr.flow("t", 1)                       # orphaned with its start
    tr.begin("step", "scheduler", queue_depth=0)
    tr.flow("s", 2)
    tr.begin("decode", "scheduler")
    tr.complete("device:decode", "profile", 10.0, 2.5, track="device")
    tr.instant("dispatch:qmatmul", "engine", track="engine", kind="ternary",
               a_scale_shape=[4, 1])
    tr.end("decode", "scheduler")
    tr.instant("first_token", "scheduler", rid=2, tok=5)
    tr.flow("t", 2)
    tr.instant("finish", "scheduler", rid=2, slot=0, n_out=1)
    tr.flow("f", 2)
    tr.end("step", "scheduler")
    tr.begin("step", "scheduler", queue_depth=1)  # open: closed at export


N_SCRIPTED = 78                         # events _script records


def _stripped(doc):
    doc = json.loads(json.dumps(doc))
    for e in doc["traceEvents"]:
        e.pop("ts", None)
        e.pop("dur", None)
    doc["otherData"].pop("wall_t0")
    return doc


@pytest.mark.parametrize("capacity", [48, 4096], ids=["overflow", "whole"])
def test_perfetto_export_matches_reference(capacity):
    docs = []
    for mod in (jtracing, ttracing):
        tr = mod.Tracer(capacity=capacity)
        _script(tr)
        doc = tr.to_perfetto()
        _validate_perfetto(doc)
        docs.append(_stripped(doc))
    assert docs[0] == docs[1]
    assert docs[1]["otherData"]["dropped_events"] == \
        max(0, N_SCRIPTED - capacity)


# ---------------------------------------------------------------------------
# traced serving
# ---------------------------------------------------------------------------
_MODELS = {}


def _jcfg(paged: bool):
    return dataclasses.replace(reduce_for_smoke(jget_config(
        "smollm-135m", precision="2xT", kv_bits=0 if paged else 8)),
        dtype="float32")


def _model(paged: bool):
    """The reduced smollm at 2xT in f32 (serving-form params from the
    reference's init through ``interop``); the paged model leaves KV
    quantization to the pool."""
    if "params" not in _MODELS:
        jcfg = _jcfg(False)
        jm = jbuild(jcfg)
        jp = reference_jit(lambda k: jto_serving(jm.init(k), jcfg))(
            jax.random.PRNGKey(0))
        _MODELS["jparams"] = jp
        _MODELS["params"] = params_from_numpy(
            jax.tree_util.tree_map(np.array, jp), "cpu")
    tcfg = dataclasses.replace(treduce(get_config(
        "smollm-135m", precision="2xT", kv_bits=0 if paged else 8)),
        dtype="float32")
    return build_model(tcfg), _MODELS["params"]


def _requests(vocab, n=4, max_new=6, seed=3, **opts):
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, vocab, (1, int(rng.integers(4, 10)))),
                    options=RequestOptions(max_new=max_new, **opts))
            for i in range(n)]


def _batcher(paged: bool, trace=None, **kw):
    model, params = _model(paged)
    if paged:
        sc = ServingConfig(n_slots=3, s_max=24, chunk_size=4, kv_bits=8,
                           block_size=4, trace=trace, **kw)
        return PagedBatcher(model, params, sc)
    return ContinuousBatcher(model, params, ServingConfig(
        n_slots=3, s_max=24, chunk_size=4, trace=trace, **kw))


def _serve(b, reqs):
    for r in reqs:
        b.submit(r)
    return {r.rid: list(r.output) for r in b.run()}


@pytest.mark.parametrize("profile", [False, True], ids=["trace", "profile"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_traced_run_schema_coverage_and_identical_streams(tmp_path, paged,
                                                          profile):
    """One workload (greedy and sampled requests, and with ``paged`` a pool
    small enough to preempt) run with the recorder on and off: equal
    streams, a valid document whose step spans cover >= 95% of the serving
    window, the scheduler's events, each distinct engine dispatch once
    on the timeline, and the tuning cache's counter."""
    kw = dict(num_blocks=6) if paged else {}
    vocab = _model(paged)[0].cfg.vocab
    reqs = _requests(vocab, n=5)
    for r in reqs[1::2]:
        r.options = dataclasses.replace(r.options, temperature=0.8, top_k=7,
                                        seed=11)
    path = str(tmp_path / "t.json")
    b = _batcher(paged, TraceConfig(enabled=True, path=path,
                                    profile=profile), **kw)
    with engine.dispatch_trace() as events:
        traced = _serve(b, reqs)
    b.tracer.detach_engine()
    plain_reqs = _requests(vocab, n=5)
    for r in plain_reqs[1::2]:
        r.options = dataclasses.replace(r.options, temperature=0.8, top_k=7,
                                        seed=11)
    assert _serve(_batcher(paged, **kw), plain_reqs) == traced
    doc = b.tracer.to_perfetto(path)
    _validate_perfetto(doc)
    assert span_coverage(doc) >= 0.95
    names = {e.get("name") for e in doc["traceEvents"]}
    want = {"step", "decode", "prefill_chunk", "admit", "finish",
            "first_token", "req"}
    if paged:
        want |= {"kv_blocks", "preempt"}
        assert b.metrics.preemptions > 0
    if profile:
        want |= {"device:decode", "device:prefill_chunk", "host_gap"}
        s = b.profiler.summary()
        assert s["decode"]["steps"] == b.metrics.decode_steps
        assert s["prefill_chunk"]["steps"] == b.metrics.prefill_chunks
    else:
        assert b.profiler is None
    assert want <= names, want - names
    dispatch = [(e["name"], e["args"]) for e in doc["traceEvents"]
                if e.get("cat") == "engine" and e["ph"] == "i"]
    assert len(dispatch) == len(set(events)) > 0
    # the tuning cache's counter rides the engine track (first step at least)
    counters = [e for e in doc["traceEvents"]
                if e.get("name") == "tuning_cache"]
    assert counters and all(e["ph"] == "C" and set(e["args"]) ==
                            {"hits", "misses", "sweeps"} for e in counters)
    assert len({json.dumps(d, sort_keys=True) for d in dispatch}) == \
        len(dispatch)
    assert json.loads((tmp_path / "t.json").read_text()) == doc


def _scheduler_events(doc):
    """The document's scheduler and KV-pool events (no engine dispatches,
    no profiler spans, no tuning-cache counter), without timestamps."""
    return [{k: v for k, v in e.items() if k not in ("ts", "dur", "tid")}
            for e in doc["traceEvents"] if e["ph"] != "M"
            and e.get("cat") not in ("engine", "profile")
            and e.get("name") != "tuning_cache"]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_scheduler_events_match_reference(paged):
    """The reference's and the port's batchers, traced on one greedy
    workload (with ``paged`` a pool that preempts and evicts), record the
    same scheduler events with the same arguments in the same order."""
    _model(paged)
    docs = []
    for pkg, kv, tracing, build, params, dtype in (
            (jserving, jkv, jtracing, jbuild, _MODELS["jparams"], np.int32),
            (tserving, tkv, ttracing, None, _MODELS["params"], np.int64)):
        trace = tracing.TraceConfig()
        if paged:
            sc = pkg.ServingConfig(n_slots=3, s_max=24, chunk_size=4,
                                   kv_bits=8, block_size=4, num_blocks=6,
                                   trace=trace)
        else:
            sc = pkg.ServingConfig(n_slots=3, s_max=24, chunk_size=4,
                                   trace=trace)
        model = build(_jcfg(paged)) if build else _model(paged)[0]
        b = (kv.PagedBatcher if paged else pkg.ContinuousBatcher)(
            model, params, sc)
        rng = np.random.default_rng(3)
        for i in range(5):
            b.submit(pkg.Request(i, rng.integers(
                0, model.cfg.vocab, (1, int(rng.integers(4, 10)))).astype(
                    dtype), options=pkg.RequestOptions(max_new=6)))
        b.run()
        b.tracer.detach_engine()
        docs.append(_scheduler_events(b.tracer.to_perfetto()))
    assert docs[0] == docs[1]
    names = {e["name"] for e in docs[1]}
    assert {"step", "decode", "prefill_chunk", "admit", "first_token",
            "finish"} <= names
    if paged:
        assert {"kv_blocks", "preempt"} <= names


def test_untraced_batcher_uses_the_null_tracer():
    b = _batcher(False)
    assert b.tracer is NULL_TRACER and b.profiler is None
    _serve(b, _requests(_model(False)[0].cfg.vocab, n=2))
    assert list(NULL_TRACER.events) == []


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_crash_dumps_flight_recorder(tmp_path, paged):
    """An exception from ``on_token`` unwinding run() writes the JSONL
    flight recorder, then re-raises untouched."""
    crash = tmp_path / "boom.crash.jsonl"
    b = _batcher(paged, TraceConfig(enabled=True, crash_dump=str(crash)))

    class Boom(RuntimeError):
        pass

    def explode(req, tok, finished):
        if len(req.output) == 3:
            raise Boom("third token")

    reqs = _requests(b.model.cfg.vocab, n=2)
    reqs[0].options = RequestOptions(max_new=6, on_token=explode)
    for r in reqs:
        b.submit(r)
    with pytest.raises(Boom):
        b.run()
    b.tracer.detach_engine()
    lines = [json.loads(x) for x in crash.read_text().splitlines()]
    assert lines[0]["flight_recorder"] is True
    assert any(e.get("name") == "step" for e in lines[1:])
    # idempotent: a second unwind through a shared tracer doesn't rewrite
    crash.unlink()
    b.tracer.on_crash()
    assert not crash.exists()


def test_on_token_streams_every_token():
    seen = []
    b = _batcher(False)
    reqs = _requests(b.model.cfg.vocab, n=3, max_new=4,
                     on_token=lambda r, t, f: seen.append((r.rid, t, f)))
    out = _serve(b, reqs)
    for rid, toks in out.items():
        mine = [(t, f) for r, t, f in seen if r == rid]
        assert [t for t, _ in mine] == toks
        assert [f for _, f in mine] == [False] * (len(toks) - 1) + [True]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_launcher_sampling_and_observability_flags(tmp_path, capsys, paged):
    trace, metrics = str(tmp_path / "t.json"), str(tmp_path / "m.json")
    argv = ["--reduced", "--device", "cpu", "--requests", "3", "--slots",
            "2", "--prompt-len", "10", "--gen", "4", "--temperature", "0.8",
            "--top-k", "5", "--stream", "--trace", trace, "--profile",
            "--metrics-json", metrics, "--metrics-interval", "2"]
    done = tserve.main(argv + (["--paged"] if paged else []))
    assert sorted(len(r.output) for r in done) == [4, 4, 4]
    # the finished run's tracer no longer listens to the engine
    assert engine._DISPATCH_LISTENER is None
    out = capsys.readouterr().out
    assert out.count("] tok ") == 12 and out.count("<eos>") == 3
    assert "profile[decode]:" in out and "profile[prefill_chunk]:" in out
    doc = json.loads(open(trace).read())
    _validate_perfetto(doc)
    assert span_coverage(doc) >= 0.95
    snaps = [json.loads(x) for x in
             open(str(tmp_path / "m.snapshots.jsonl")).read().splitlines()]
    assert len(snaps) >= 2 and all("delta" in s for s in snaps)
    with pytest.raises(SystemExit, match="needs --metrics-json"):
        tserve.main(["--reduced", "--device", "cpu", "--metrics-interval",
                     "2"])
