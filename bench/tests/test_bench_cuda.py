"""On the card: the port's logits against the reference, and the control
(the reference in TF32, emulated and the card's own) failing the limit, at
a batch a test run holds.  Marked ``cuda``; skips without a card.

    python3 -m pytest -q -m cuda bench/tests/test_bench_cuda.py
"""
from __future__ import annotations

import json

import pytest
from bench_testing import BENCH

import judge
import weights

torch = pytest.importorskip("torch")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    import run
    run.prepare_environment()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name, batch", [("alexnet-2xT", 16),
                                         ("resnet34-2xT", 8)])
def test_port_and_control_on_the_card(card, name, batch):
    import run
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    adapter = run.load_module("configs", name)
    reference = run.load_module("reference", cfg["reference"])
    x = torch.randn((batch, *cfg["input_shape"]), device=card,
                    generator=weights.generator(9, 1, card))
    flat = adapter.draw(cfg, 2**32 + 9, card)
    limit = cfg["limits"]["logit_gap"]
    with torch.no_grad():
        port = adapter.forward(adapter.prepare(flat, cfg), x, cfg).cpu()
        ref = reference.forward(flat, x, cfg).cpu()
        emulated = reference.forward(flat, x, cfg, tf32=True).cpu()
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = reference.forward(flat, x, cfg).cpu()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    assert judge.logit_gap([port.numpy()], [ref.numpy()]) <= limit
    assert judge.logit_gap([emulated.numpy()], [ref.numpy()]) > limit
    assert judge.logit_gap([tf32.numpy()], [ref.numpy()]) > limit
