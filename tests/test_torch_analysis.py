"""The invariant auditor of the port (``repro_torch.analysis``) against
the reference's (``repro.analysis``).

  * the linter is clean on the port's sources and each of its rules fires
    on a seeded source (the reference's ``test_lint_*`` cases);
  * each contract rule fires exactly on its seeded violation and on
    nothing else: every rule is applied to a clean step and to each seed.
    The seeds are recorded runs (the op walker's log, the dispatch
    events, the in-place pointers, the tuning delta of real CPU steps)
    joined to a clean record of a card step; the card-only rules are fed
    recorded events and op logs, as only the card runs the kernels;
  * the seven cells on a 1,1 mesh report zero findings through the CLI,
    the card-only rules listed as not bound, and the report survives a
    JSON round trip;
  * per cell, the step names and each step's rules equal the reference's
    ``audit_steps()`` / ``default_rules()`` under the id table of
    ``repro_torch.analysis.rules`` (the reference built once here);
  * one spawn of 2 gloo ranks audits ``tp-d1024`` on 1,2 and ``smollm-dp``
    on 2,1 (zero findings), and a pure-DP step seeded with an all-reduce
    fires ``no_collectives`` alone."""
import json
import os
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_testing import one_thread, ranks_one_thread  # noqa: E402,F401

from repro.analysis import steps as jsteps  # noqa: E402
from repro_torch.analysis import astlint, cli  # noqa: E402
from repro_torch.analysis import rules as R  # noqa: E402
from repro_torch.analysis import steps as S  # noqa: E402
from repro_torch.analysis.op_walker import OpLog, walk  # noqa: E402
from repro_torch.analysis.report import (CARD_ONLY_RULES, Finding,  # noqa: E402
                                         Report, StepSpec)
from repro_torch.core.precision import get_precision, signed  # noqa: E402
from repro_torch.kernels import engine, tuning  # noqa: E402
from repro_torch.kernels.engine import DispatchEvent  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_analysis_ranks as ranks  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _tuning_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "tuning.json"))
    tuning.reset()
    yield
    tuning.reset()


# ---------------------------------------------------------------------------
# the linter
# ---------------------------------------------------------------------------
def test_port_sources_are_lint_clean():
    findings = astlint.lint_paths(astlint.default_lint_roots(REPO),
                                  repo_root=REPO)
    assert findings == [], "\n".join(str(f) for f in findings)


LINT_SEEDS = {
    "kernel-import-boundary": (
        "from repro_torch.kernels import binary_matmul\n",
        "src/repro_torch/models/foo.py", "binary_matmul"),
    "batcher-config-bypass": (
        "b = PagedBatcher(model, params)\n", "tests/test_torch_x.py",
        "PagedBatcher"),
    "device-get-in-hot-loop": (
        "def _step_impl(self):\n    return self.tokens.cpu()\n",
        "src/repro_torch/runtime/foo.py", "_step_impl"),
    "tracing-in-jit": (
        "from repro_torch.runtime.tracing import Tracer\n",
        "src/repro_torch/parallel/foo.py", "flight recorder"),
}
LINT_CLEAN = {
    "kernel-import-boundary": ("from repro_torch.kernels import engine\n",
                               "src/repro_torch/models/foo.py"),
    "batcher-config-bypass": ("b = PagedBatcher(model, params, config=c)\n",
                              "tests/test_torch_x.py"),
    "device-get-in-hot-loop": ("def build(self):\n"
                               "    return self.tokens.cpu()\n",
                               "src/repro_torch/runtime/foo.py"),
    "tracing-in-jit": ("from repro_torch.runtime.tracing import Tracer\n",
                       "src/repro_torch/runtime/serving.py"),
}


@pytest.mark.parametrize("rule", astlint.AST_RULES)
def test_lint_rule_fires_on_its_seed_only(rule):
    src, path, word = LINT_SEEDS[rule]
    findings = astlint.lint_source(src, path)
    assert [f.rule for f in findings] == [rule], [str(f) for f in findings]
    assert word in findings[0].message + findings[0].locus
    src, path = LINT_CLEAN[rule]
    assert astlint.lint_source(src, path) == []


def test_lint_spellings_and_exemption():
    """The other host syncs and tracer calls of the port; the kernels
    package is exempt from the import boundary by path."""
    hot = ("def step(self):\n    a = x.item()\n    b = x.tolist()\n"
           "    torch.cuda.synchronize()\n    return a, b\n")
    assert [f.rule for f in astlint.lint_source(
        hot, "src/repro_torch/runtime/x.py")] == \
        ["device-get-in-hot-loop"] * 3
    call = "def f(tr):\n    tr.instant('x', 'y')\n"
    assert [f.rule for f in astlint.lint_source(
        call, "src/repro_torch/models/x.py")] == ["tracing-in-jit"]
    assert astlint.lint_source(call, "src/repro_torch/runtime/x.py") == []
    with tempfile.TemporaryDirectory() as d:
        for sub in ("kernels", "models"):
            p = os.path.join(d, "src", "repro_torch", sub, "x.py")
            os.makedirs(os.path.dirname(p))
            with open(p, "w") as fh:
                fh.write("import repro_torch.kernels.ternary_matmul\n")
        got = astlint.lint_paths([os.path.join(d, "src")], repo_root=d)
        assert [(f.rule, f.step) for f in got] == \
            [("kernel-import-boundary", "src/repro_torch/models/x.py:1")]
    assert [f.rule for f in astlint.lint_source("def broken(:\n", "x.py")] \
        == ["syntax-error"]


# ---------------------------------------------------------------------------
# the contract rules: seeded violations
# ---------------------------------------------------------------------------
PCFG = signed(get_precision("2xT"))


def _event(op="qmatmul", kind="ternary", impl="cuda", m=8, scale=(8, 1),
           a_bits=8):
    return DispatchEvent(op=op, kind=kind, requested_backend=impl,
                         impl_backend=impl, a_bits=a_bits, w_bits=2,
                         m_rows=m, a_scale_shape=scale)


def _clean_spec():
    """A step that binds every rule, on the card."""
    return StepSpec(name="seeded", fn=None, args=(), inplace=(0,),
                    pure_dp=True, quantized_acts=True,
                    quantized_weights=True, backend="cuda", run_backend="cuda",
                    fused_layers=1)


def _clean(**over):
    """A clean record of a card step: a ternary qmatmul and its row
    quantizer, one fused decode, each kernel launched once; no collective,
    a tuning hit, the cache in place, an empty op log."""
    kw = dict(events=[_event(op="act_quant_signed_grouped",
                             kind="signed_grouped"), _event(),
                      _event(op="fused_paged_decode", kind="fused_decode",
                             scale=None)],
              launches={"ternary_matmul": 1, "act_quant_signed_grouped": 1,
                        "fused_decode": 1},
              collectives={"all_reduce_sum": 0, "all_reduce_max": 0},
              tuning_delta={"hits": 1, "misses": 0, "sweeps": 0},
              op_log=OpLog(), inplace={0: ([1, 2], [1, 2], [1, 2])})
    kw.update(over)
    return R.StepArtifacts(_clean_spec(), **kw)


def _run(fn, *args, inplace=()):
    """A real run of ``fn`` on the CPU under the recorders."""
    return R.StepArtifacts.run(StepSpec(name="run", fn=fn, args=args,
                                        inplace=inplace))


def _upcast_log():
    w8 = torch.ones((8, 4), dtype=torch.int8)
    return _run(lambda x: x @ (w8.to(torch.float32) * 0.02),
                torch.ones(2, 8)).op_log


def _sync_log():
    return _run(lambda x: x.sum().item(), torch.ones(3)).op_log


def _cache_replaced():
    def step(cache):
        return (None, {k: v + 0 for k, v in cache.items()})
    return _run(step, {"k": torch.zeros(4), "v": torch.zeros(4)},
                inplace=(0,)).inplace


def _tuning_miss():
    def step(x):
        tuning.get_block_sizes(16, 32, 64, kind="ternary", a_bits=8,
                               w_bits=2, backend="cuda")
        return x
    return _run(step, torch.ones(1)).tuning_delta


def _per_tensor_scale(monkeypatch):
    """Events of a real CPU qmatmul whose activation scale is per tensor
    (batch-coupled), recorded as the card records them."""
    orig = engine._prep_activations

    def per_tensor(x2, pw, a_bits, backend):
        xq, a_scale = orig(x2, pw, a_bits, backend)
        return xq, (None if a_scale is None else a_scale.max().reshape(1, 1))
    monkeypatch.setattr(engine, "_prep_activations", per_tensor)
    pw = engine.pack_weight(torch.randn(64, 32), PCFG)
    events = _run(lambda x: engine.qmatmul(x, pw, PCFG),
                  torch.randn(8, 64)).events
    assert [e.a_scale_shape for e in events] == [(1, 1)]
    return [e._replace(impl_backend="cuda", requested_backend="cuda")
            for e in events] + _clean().events[2:]


SEEDS = {
    "no_collectives": lambda mp: _clean(
        collectives={"all_reduce_sum": 1, "all_reduce_max": 0}),
    # backend "torch" forced on CUDA tensors: the plain version ran
    "cuda_kernel_launched": lambda mp: _clean(
        events=[_event(op="act_quant_signed_grouped", kind="signed_grouped"),
                _event(impl="torch"),
                _event(op="fused_paged_decode", kind="fused_decode",
                       scale=None)],
        launches={"act_quant_signed_grouped": 1, "fused_decode": 1}),
    "no_f32_upcast_of_quantized_operands": lambda mp: _clean(
        op_log=_upcast_log()),
    "scale_shape_is_per_row": lambda mp: _clean(
        events=_per_tensor_scale(mp)),
    "cache_updated_in_place": lambda mp: _clean(inplace=_cache_replaced()),
    "tuning_cache_hit": lambda mp: _clean(tuning_delta=_tuning_miss()),
    "fused_decode_single_dispatch": lambda mp: _clean(op_log=_sync_log()),
}


def test_clean_record_fires_nothing():
    assert R.check(_clean(), R.RULES) == []


@pytest.mark.parametrize("rule", sorted(SEEDS))
def test_seeded_violation_fires_exactly_its_rule(rule, monkeypatch):
    findings = R.check(SEEDS[rule](monkeypatch), R.RULES)
    assert sorted({f.rule for f in findings}) == [rule], \
        [str(f) for f in findings]
    assert all(f.step == "seeded" and f.message for f in findings)


def test_fused_rule_on_an_unfused_step():
    """A paged decode that dispatched (and launched) B2 in place of B4:
    the fused rule alone fires, twice (no fused dispatch; an attention
    dispatch that is not fused)."""
    art = _clean(events=_clean().events[:2] + [
        _event(op="paged_attention", kind="paged", scale=None)],
        launches={"ternary_matmul": 1, "act_quant_signed_grouped": 1,
                  "paged_attention": 1})
    findings = R.check(art, R.RULES)
    assert {f.rule for f in findings} == {"fused_decode_single_dispatch"}
    msgs = " | ".join(f.message for f in findings)
    assert "not on the fused path" in msgs and "non-fused" in msgs


@pytest.mark.parametrize("launched,fires", [
    ({"fused_decode": 1}, False), ({"paged_attention": 1}, False),
    ({}, True)])
def test_fused_dispatch_launches_b4_or_its_composition(launched, fires):
    """A fused decode dispatch runs B4, or with a quantized ``wo`` the
    engine's composition of B2 and ``qmatmul``: either launch satisfies
    ``cuda_kernel_launched``, neither fires it."""
    art = _clean(events=_clean().events[:2] + [
        _event(op="fused_paged_decode", kind="fused_decode", scale=None)],
        launches={"ternary_matmul": 1, "act_quant_signed_grouped": 1,
                  **launched})
    got = R.check(art, ("cuda_kernel_launched",))
    assert bool(got) == fires, [str(f) for f in got]


def test_upcast_attribution_by_dispatch_events():
    """The plain ternary matmul's int codes -> float64 -> mm runs inside
    its qmatmul dispatch: attributed to that event, so ``no_f32_upcast``
    leaves it to ``cuda_kernel_launched``; the same chain written outside
    the engine is flagged; an array-valued scale ends the chain (the
    per-position KV dequant)."""
    pw = engine.pack_weight(torch.randn(64, 32), PCFG)
    art = _run(lambda x: engine.qmatmul(x, pw, PCFG), torch.randn(8, 64))
    assert art.op_log.upcasts and all(
        art.events[u.root.event].op == "qmatmul"
        for u in art.op_log.upcasts)
    assert R.check(R.StepArtifacts(
        _clean_spec(), events=art.events, op_log=art.op_log),
        ("no_f32_upcast_of_quantized_operands",)) == []
    w8 = torch.ones((8, 4), dtype=torch.int8)
    _, log = walk(lambda x: x @ (w8.to(torch.float32) * torch.rand(8, 1)),
                  torch.ones(2, 8))
    assert log.upcasts == []
    _, log = walk(lambda x: torch.einsum("ab,bc->ac", x,
                                         w8.to(torch.float32).T.T),
                  torch.ones(2, 8))
    assert [u.root.event for u in log.upcasts] == [None]


def test_upcast_attribution_follows_the_running_dispatch():
    """Attribution reads the dispatch the engine marks as running, not the
    call stack: an upcast inside a ``record_plain`` block (a dispatch site
    that records through a helper, as the Mamba scan and the training
    attention do) and inside the expert product belongs to that dispatch;
    the same upcast after the block belongs to none."""
    w8 = torch.ones((8, 4), dtype=torch.int8)
    x = torch.ones(2, 8)

    def step(x):
        with engine.record_plain("ssm_scan", "step", x):
            x @ w8.to(torch.float32)
        return x @ w8.to(torch.float32)
    _, log = walk(step, x)
    assert [e.op for e in log.events] == ["ssm_scan"]
    assert [u.root.event for u in log.upcasts] == [0, None]
    assert engine.active_dispatch() is None
    p = {"wt_packed": torch.ones((2, 4, 8), dtype=torch.int8),
         "scale": torch.ones((2, 4))}
    _, log = walk(lambda x: engine.qmatmul_experts(x, p, PCFG),
                  torch.ones(2, 3, 8))
    assert log.upcasts and all(
        log.events[u.root.event].op == "qmatmul_experts"
        for u in log.upcasts)


def test_step_spec_rules_and_binding():
    base = dict(name="s", fn=None, args=())
    assert "no_collectives" in StepSpec(**base).default_rules()
    assert "no_collectives" not in StepSpec(**base,
                                            pure_dp=False).default_rules()
    quant = StepSpec(**base, quantized_weights=True, quantized_acts=True,
                     backend="cuda", inplace=(2,))
    rules = quant.default_rules()
    for r in ("cuda_kernel_launched", "no_f32_upcast_of_quantized_operands",
              "tuning_cache_hit", "scale_shape_is_per_row",
              "cache_updated_in_place"):
        assert r in rules
    plain = StepSpec(**base, quantized_weights=True, quantized_acts=True,
                     backend="torch").default_rules()
    assert "cuda_kernel_launched" not in plain
    assert "scale_shape_is_per_row" in plain
    bound, not_bound = quant.split_rules(rules)
    assert not_bound == CARD_ONLY_RULES and not set(bound) & set(not_bound)
    assert not quant.on_card
    quant.run_backend = "cuda"          # what a batcher on the card sets
    assert quant.on_card and quant.split_rules(rules) == (rules, ())
    with pytest.raises(KeyError, match="bogus"):
        R.audit_step(StepSpec(**base), rules=("bogus",))


def test_report_json_roundtrip():
    rep = Report()
    rep.extend([Finding(rule="r", step="s", message="m", locus="l")],
               cell="c")
    rep.checked.append({"cell": "c", "step": "s", "rules": ["r"],
                        "not_bound": ["q"]})
    data = json.loads(rep.to_json())
    assert data["findings"][0]["cell"] == "c" and not data["ok"]
    back = Report.from_json(rep.to_json())
    assert back.findings == rep.findings and back.to_json() == rep.to_json()
    assert "1 finding" in rep.summary() and "1 not bound" in rep.summary()


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------
def test_cells_on_one_rank_zero_findings(tmp_path, capsys):
    """``python -m repro_torch.analysis audit --mesh 1,1`` on the CPU:
    exit 0, zero findings, every quantized step of a ``cuda`` cell listing
    the card-only rules as not bound (never as checked)."""
    out = tmp_path / "audit.json"
    assert cli.main(["audit", "--mesh", "1,1", "--device", "cpu", "--json",
                     str(out)]) == 0
    assert "0 finding(s) — clean" in capsys.readouterr().out
    rep = Report.from_json(out.read_text())
    assert rep.ok
    steps = [c for c in rep.checked if "step" in c]
    assert {c["cell"] for c in steps} == {c.name for c in S.CELLS}
    for c in steps:
        assert not set(c["rules"]) & set(CARD_ONLY_RULES)
        cell = S.cell_by_name(c["cell"])
        quant = c["step"] not in ("select", "paged:select") and \
            cell.precision == "2xT"
        want = CARD_ONLY_RULES if cell.force_backend == "cuda" and quant \
            else ()
        assert tuple(c["not_bound"]) == want, c


def test_audit_refuses_without_a_card(monkeypatch, capsys):
    """As the launcher: ``audit`` on the card (the default) with no card
    visible exits non-zero before any work, and says to pass
    ``--device cpu``; the lint pass alone needs no device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["audit", "--configs", "smollm-dp", "--no-lint"]) == 2
    err = capsys.readouterr().err
    assert "no CUDA device is visible" in err and "--device cpu" in err
    assert cli.main(["audit", "--no-steps"]) == 0


@pytest.fixture(scope="module")
def reference_steps():
    """Per cell: the reference's (step name, default rules) on its first
    mesh (1,1 or none), built once in this process."""
    out = {}
    for cell in jsteps.CELLS:
        shape = cell.meshes[0]
        with jsteps.cell_backend(cell):
            specs = jsteps.build_cell_steps(cell, shape, prime=False)
            out[cell.name] = [(s.name, s.default_rules()) for s in specs]
    return out


@pytest.mark.parametrize("name", [c.name for c in S.CELLS])
def test_cell_steps_and_rules_match_reference(reference_steps, name):
    cell = S.cell_by_name(name)
    mesh = tmesh.make_mesh(1, 1) if cell.meshes[0] else None
    got = [(s.name, tuple(R.REFERENCE_IDS[r] for r in s.default_rules()))
           for s in S.build_cell_steps(cell, mesh, prime=False)]
    want = [(n, tuple(r)) for n, r in reference_steps[name]]
    assert got == want


def test_two_ranks(tmp_path, monkeypatch):
    """tp-d1024 on 1,2 and smollm-dp on 2,1 (2 gloo ranks): the
    reference's steps, zero findings; tensor-parallel steps bind no
    ``no_collectives``, pure-DP ones do; an all-reduce in a pure-DP step
    fires ``no_collectives`` alone."""
    with ranks_one_thread():
        res = tmesh.spawn(ranks.run_checks,
                          tmesh.Mesh({"data": 2, "model": 1}), {},
                          device="cpu")
    for r in res:
        for name, pure in (("tp-d1024", False), ("smollm-dp", True)):
            got = r[name]
            assert [n for n, _, _ in got] == ["decode", "prefill", "chunk",
                                              "select"]
            for step, findings, rules in got:
                assert findings == [], (r["rank"], name, step, findings)
                assert ("no_collectives" in rules["rules"]) == pure
        assert [f for f, _ in r["seeded"]] == ["no_collectives"]
        assert "all_reduce_sum" in r["seeded"][0][1]
