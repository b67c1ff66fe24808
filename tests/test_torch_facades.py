"""The port's public surface against the reference's.

* Facades: ``repro_torch.core``, ``repro_torch.kernels``,
  ``repro_torch.kernels.ops`` and ``repro_torch.runtime`` export every
  name that the reference's counterpart binds (its relative imports and
  its own classes and functions), except the names listed in
  ``NOT_PORTED`` with the ROADMAP Queue A item that takes each.
* The runtime's host-side helpers behave as the reference's:
  ``StragglerMonitor`` on one seeded step-time series, ``retry_with_backoff``
  and ``PreemptionGuard``.
* ``examples/torch_quickstart.py --device cpu`` runs and prints finite
  tokens.
"""
import ast
import dataclasses
import importlib
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")
from torch_testing import one_thread  # noqa: E402,F401

import repro.runtime as jruntime  # noqa: E402
import repro_torch.runtime as truntime  # noqa: E402

REPO = Path(__file__).resolve().parent.parent

# reference name -> the ROADMAP Queue A item that ports it
NOT_PORTED: dict = {}
FACADES = ("core", "kernels", "kernels.ops", "runtime")


def _facade_names(module: str) -> set:
    """Names a facade module binds: its relative imports and its own
    top-level classes and functions."""
    path = importlib.util.find_spec(module).origin
    tree = ast.parse(Path(path).read_text(encoding="utf-8"))
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.level > 0:
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, (ast.ClassDef, ast.FunctionDef)):
            names.add(node.name)
    return names


@pytest.mark.parametrize("sub", FACADES)
def test_facade_exports_the_reference_names(sub):
    ref, port = f"repro.{sub}", f"repro_torch.{sub}"
    want = _facade_names(ref)
    skip = NOT_PORTED.get(ref, {})
    assert set(skip) <= want, "NOT_PORTED names a name the reference lacks"
    mod = importlib.import_module(port)
    missing = sorted(n for n in want - set(skip) if not hasattr(mod, n))
    assert missing == [], f"{port} lacks {missing}"
    # the list stays honest: what it says is missing is missing
    assert not [n for n in skip if hasattr(mod, n)]


def test_facade_names_are_the_modules_objects():
    import repro_torch.core as core
    import repro_torch.kernels as kernels
    from repro_torch.core import packing, precision, quantize
    from repro_torch.kernels import engine, ops, tuning
    assert kernels.qmatmul is engine.qmatmul is ops.qmatmul
    assert kernels.quantized_matmul is engine.quantized_matmul
    assert kernels.tuning is tuning
    assert kernels.decode_attention is importlib.import_module(
        "repro_torch.kernels.decode_attention").decode_attention
    assert kernels.act_quant is importlib.import_module(
        "repro_torch.kernels.act_quant").act_quant
    assert core.get_precision is precision.get_precision
    assert core.weight_quant is quantize.weight_quant
    assert core.pack is packing.pack
    assert kernels.resolve("ternary", 2, 2, "cuda") is \
        engine.resolve_entry("ternary", 2, 2, "cuda")[0]
    assert kernels.available_kernels()[("ternary", 2, 2, "cuda")] == \
        "_ternary_cuda"


def test_straggler_monitor_matches_reference():
    rng = np.random.default_rng(7)
    series = 0.1 + 0.005 * rng.standard_normal(200)
    series[[30, 31, 32, 33, 90, 150, 151]] *= (3.0, 4.0, 5.0, 3.5, 2.0, 6.0,
                                               1.2)
    mons = [truntime.StragglerMonitor(), jruntime.StragglerMonitor(),
            truntime.StragglerMonitor(alpha=0.3, k=2.0, warmup=3,
                                      replace_after=2),
            jruntime.StragglerMonitor(alpha=0.3, k=2.0, warmup=3,
                                      replace_after=2)]
    for step, wall in enumerate(series):
        got = [m.record(step, float(wall)) for m in mons]
        for a, b in (got[:2], got[2:]):
            assert (a is None) == (b is None)
            if a is not None:
                assert dataclasses.astuple(a) == dataclasses.astuple(b)
        assert mons[0].should_replace == mons[1].should_replace
        assert mons[2].should_replace == mons[3].should_replace
    for t, j in (mons[:2], mons[2:]):
        assert [dataclasses.astuple(e) for e in t.events] == \
            [dataclasses.astuple(e) for e in j.events]
        assert (t.mean, t.var, t.n, t.consecutive) == \
            (j.mean, j.var, j.n, j.consecutive)
    assert len(mons[0].events) >= 3


@pytest.mark.parametrize("fails,retries", [(0, 3), (2, 3), (3, 3), (4, 3)])
def test_retry_with_backoff_matches_reference(fails, retries):
    outcomes = []
    for mod in (truntime, jruntime):
        calls = []

        def fn():
            calls.append(1)
            if len(calls) <= fails:
                raise OSError("transient")
            return len(calls)
        try:
            outcomes.append(("ok", mod.retry_with_backoff(
                fn, retries=retries, base_s=0.0), len(calls)))
        except OSError:
            outcomes.append(("raised", None, len(calls)))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][0] == ("ok" if fails <= retries else "raised")

    def other():
        raise ValueError("not transient")
    for mod in (truntime, jruntime):
        with pytest.raises(ValueError):
            mod.retry_with_backoff(other, base_s=0.0)


def test_preemption_guard_matches_reference():
    sig = signal.SIGUSR1
    before = signal.getsignal(sig)
    for mod in (truntime, jruntime):
        with mod.PreemptionGuard(signals=(sig,)) as guard:
            assert not guard.requested
            os.kill(os.getpid(), sig)
            assert guard.requested
        assert signal.getsignal(sig) == before


def test_torch_quickstart_runs_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "examples/torch_quickstart.py", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO / "src"),
             "REPRO_TUNING_CACHE": os.devnull})
    assert proc.returncode == 0, proc.stderr
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("decoded tokens:"))
    assert "(finite: True)" in line
    assert "BNS fusion max err: 0.00e+00" in proc.stdout
