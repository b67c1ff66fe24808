"""The card's train step against the CPU's (``chip_smoke.py`` phase 4q,
step 3).  Needs an NVIDIA GPU: every test is marked ``cuda`` and skips
without a card.  Imports no JAX.

One adamw step (lr 1e-3) of reduced smollm in float32 (TF32 off, PyTorch's
default) from the same params, optimizer state and batch on the card and
on the CPU (``chip_smoke.train_step_vs_cpu``).  Bounds, stated in
``chip_smoke.py``: loss and grad norm within 1e-5 relative; every updated
leaf within 0.1 lr (an Adam step moves an entry by ~lr g / (|g| + eps),
near +-lr whatever the summation order, except where g is itself at the
f32 ulps' level).  At 2xT the card runs once more with the CPU run's
activation codes where its own differ (fault C1's mechanism: an input
within ulps of a rounding boundary); each differing code lies one step
from the CPU's and within 1e-3 steps of the boundary between them, and
that run is held to the bounds.

Run on the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_train_cuda.py
"""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
from torch_testing import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.cuda

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def smoke():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the card's train step)")
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("precision", ["fp32", "2xT"])
def test_card_train_step_matches_cpu(smoke, precision):
    rep = smoke.train_step_vs_cpu(precision, torch.device("cuda", 0))
    b = rep["bounded"]
    assert b["loss_rel"] <= smoke.STEP_METRIC_RTOL, rep
    assert b["gnorm_rel"] <= smoke.STEP_METRIC_RTOL, rep
    assert b["leaf_lr"] <= smoke.STEP_LEAF_LR, rep
    for kind, steps, dist in rep["flips"]:
        assert kind == "clip" or steps == 1, rep["flips"]
        assert dist <= smoke.CODE_DIST, rep["flips"]
    assert (rep["quant_calls"] > 0) == (precision != "fp32")
