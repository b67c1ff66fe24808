"""The harness end to end on the CPU, in a temporary checkout: a new mix
and a new metric are picked up as files; the result line's keys; the
faults a cell can have come out as not correct; and the runs that must
print no result do not."""
from __future__ import annotations

import json
import subprocess
import sys
import types

import pytest
from bench_testing import ROOT, checkout, harness, resnet_tiny, tiny_mix

torch = pytest.importorskip("torch")

DUMMY_METRIC = '''"""dummy_batches (batches): the traced slice's batches."""
import devtrace


def read(run):
    return float(devtrace.window(run.trace)[2]) or None
'''
CELL = {"name": "tiny.b2", "config": "resnet34-tiny", "traffic": "tiny-b2",
        "chips": 1, "why": "a test's cell"}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A checkout with one small cell, a dummy mix and a dummy metric."""
    layer = json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]
    layer.append({"name": "dummy_batches", "unit": "batches",
                  "better": "higher", "source": "device_trace",
                  "layer": "harness", "moves": "images_per_s"})
    root = checkout(tmp_path_factory.mktemp("tiny"), [CELL],
                    {"tiny-b2": tiny_mix(2)},
                    configs={"resnet34-tiny": (resnet_tiny(32),
                                               "resnet34-2xT")},
                    per_layer=layer,
                    files={"bench/metrics/dummy_batches.py": DUMMY_METRIC})
    return harness(root)


def _run(h, trace=0, seed=2**33 + 5, wrap=None):
    args = h.parse(["--workload", "tiny.b2", "--seed", str(seed),
                    "--seconds", "0.5", "--trace", str(trace)])
    return h.run(args, need_card=False, wrap=wrap)


def test_untraced_run_reports_the_end_to_end_metrics(tiny):
    res = _run(tiny)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0 and res["attempted"] % 2 == 0
    assert set(res["metrics"]) == {"images_per_s", "batch_p95_ms",
                                   "peak_mem_gib", "setup_s"}
    assert list(res)[-1] == "checks"
    assert res["checks"]["logit_gap"]["limit"] > 0


def test_new_mix_and_metric_are_picked_up_by_name(tiny):
    res = _run(tiny, trace=1)
    assert res["correct"] is True
    assert res["metrics"]["dummy_batches"] == {"value": 2.0,
                                               "unit": "batches"}
    assert "breakdown" in res and res["device"]["window_s"] > 0
    assert list(res)[-1] == "checks"


def _alter_one_logit(forward):
    def wrapped(x):
        y = forward(x)
        y[0, 0] += 0.1
        return y
    return wrapped


def _half_the_batch(forward):
    def wrapped(x):
        y = forward(x[: x.shape[0] // 2])
        return torch.cat([y, y])
    return wrapped


@pytest.mark.parametrize("fault", [_alter_one_logit, _half_the_batch],
                         ids=["answer_altered", "half_the_batch_left_out"])
def test_faults_are_not_correct(tiny, fault):
    res = _run(tiny, wrap=fault)
    assert res["correct"] is False
    assert res["checks"]["logit_gap"]["value"] > \
        res["checks"]["logit_gap"]["limit"]
    json.dumps(res, allow_nan=False)


def test_malformed_logits_read_far_and_stay_json():
    import judge
    import numpy as np
    ok = np.ones((2, 3))
    assert judge.logit_gap([np.ones((1, 3))], [ok]) == judge.FAR
    assert judge.logit_gap([ok * np.nan], [ok]) == judge.FAR
    assert judge.logit_gap([ok], [ok * 0]) == judge.FAR
    correct, checks = judge.decide({"logit_gap": judge.FAR},
                                   {"logit_gap": 1e-5})
    assert not correct
    json.dumps(checks, allow_nan=False)


def test_jax_in_the_process_refuses_the_run(tiny):
    def loads_jax(forward):
        sys.modules["jax"] = types.ModuleType("jax")
        return forward
    try:
        with pytest.raises(tiny.Refused) as e:
            _run(tiny, wrap=loads_jax)
        assert e.value.code == 3 and "jax" in str(e.value)
    finally:
        del sys.modules["jax"]


def _cli(cwd, *extra):
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "alexnet-2xT.b256",
         "--seed", "1", "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300, check=False)


def test_no_result_without_the_program(tmp_path):
    """A directory that holds only BENCHMARK.json and bench/."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("tests", ".cache"))
    out = _cli(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
    assert "src/repro_torch" in out.stderr


def test_no_result_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _cli(ROOT)
    assert out.returncode == 2 and out.stdout == ""
    assert "no CUDA device" in out.stderr
