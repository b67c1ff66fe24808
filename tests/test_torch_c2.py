"""Why the fp32 decode step through the kernels can leave its plain versions'
``1e-4 max|logit|`` bound (``chip_smoke.py`` phase 4), stated as a contract
per layer.  Needs an NVIDIA GPU: every test is marked ``cuda`` and skips
without a card.

smollm-135m at full width, fp32 weights, float32, kv8, random weights from
each of seeds 0-9; one prefill chunk and one decode step over 4 slots,
through the kernels and through the plain versions
(``tools/probe_c2.py``'s ``layer_report``).  The decode step quantizes the
decoded token's K and V to int8 codes in every layer, and the two runs'
attention outputs differ by f32 summation order (~3e-7 of max|out|), so the
next layer's pre-quantization K/V differ by ~1e-4 code steps.  When such a
value lies that near a rounding boundary, its code rounds one way in one
run and the other way in the other: one code step, ~1% of the head's
range.  That step, not the kernel, is what grows to 1e-4 of max|logit|.
The contract, per seed:

  * at every layer, B5 on the kernel run's own inputs lies within its
    per-call bound ``1e-5 + 1e-4 max|out|`` of its plain version;
  * before the first layer whose codes differ, the runs stay in the
    summation-order regime: pre-quantization K/V within 1e-3 code steps,
    attention outputs within 2e-6 of max|out|;
  * every code that differs differs by one step, and its pre-quantization
    values lie within 0.1 code steps of the boundary between the two codes
    (within 1e-3 at the first such layer: a rounding tie broken by the
    summation order);
  * with each layer's decoded-token codes and scales taken from the kernel
    run, the plain run's logits lie within 0.05 of the phase-4 bound of the
    kernel run's: the code steps account for the rest.

Run on the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_c2.py
"""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
from torch_testing import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.cuda

REPO = Path(__file__).resolve().parent.parent


def _probe():
    spec = importlib.util.spec_from_file_location(
        "probe_c2", REPO / "tools" / "probe_c2.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def setup():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    probe = _probe()
    from repro_torch.models import build_model
    chip = probe.chip_smoke
    cfg = chip.model_config(precision="fp32", kv_bits=8, dtype="float32")
    model = build_model(cfg)
    prompt = chip._requests(cfg, 1, chip.GEN)[0].tokens
    return probe, model, prompt, torch.device("cuda", 0)


@pytest.mark.parametrize("seed", range(10))
def test_decode_step_parts_only_by_kv_code_steps(setup, seed):
    probe, model, prompt, device = setup
    params = model.init(torch.Generator().manual_seed(seed), device)
    rep = probe.layer_report(model, params, prompt, device)
    flipped = [r for r in rep["layers"]
               if r["k"]["flips"] or r["v"]["flips"]]
    first = flipped[0]["layer"] if flipped else len(rep["layers"])
    for r in rep["layers"]:
        assert r["per_call"] <= r["per_call_tol"], r
        for kv in (r["k"], r["v"]):
            assert kv["max_step"] <= 1, (r["layer"], kv)
            assert kv["flip_dist"] <= (1e-3 if r["layer"] == first
                                       else 0.1), (r["layer"], kv)
            if r["layer"] < first:
                assert kv["du"] <= 1e-3, (r["layer"], kv)
        if r["layer"] < first:
            assert r["attn_rel"] <= 2e-6, r
    assert rep["cuda_swap"] <= 0.05, rep["cuda_swap"]
    if not flipped:                      # no code step: well inside the bound
        assert rep["cuda_plain"] <= 0.05, rep["cuda_plain"]
