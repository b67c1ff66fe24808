"""The plain reference (``reference/<name>.py``) against the port's plain
CPU backend at a small size, and the control (the reference in TF32)
failing the configuration's limit there."""
from __future__ import annotations

import json

import pytest
from bench_testing import BENCH, resnet_tiny

import judge
import weights

torch = pytest.importorskip("torch")

CASES = {  # configuration: (test size, batch)
    "alexnet-2xT": (None, 1),
    "resnet34-2xT": (32, 2),
}


def _cell(name: str):
    import run
    size, batch = CASES[name]
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text()) \
        if size is None else resnet_tiny(size)
    adapter = run.load_module("configs", name)
    reference = run.load_module("reference", cfg["reference"])
    gen = weights.generator(5, 1, "cpu")
    x = torch.randn((batch, *cfg["input_shape"]), generator=gen)
    return cfg, adapter, reference, x


@pytest.fixture(scope="module", params=sorted(CASES))
def logits(request):
    """(port, reference, control) logits of one small batch."""
    cfg, adapter, reference, x = _cell(request.param)
    flat = adapter.draw(cfg, 2**31 + 17, "cpu")
    with torch.no_grad():
        port = adapter.forward(adapter.prepare(flat, cfg), x, cfg)
        ref = reference.forward(flat, x, cfg)
        control = reference.forward(flat, x, cfg, tf32=True)
    return cfg, port.numpy(), ref.numpy(), control.numpy()


def test_port_matches_the_reference(logits):
    cfg, port, ref, _ = logits
    gap = judge.logit_gap([port], [ref])
    assert gap <= cfg["limits"]["logit_gap"], gap
    assert abs(ref).max() > 0.1                   # activations did not die


def test_control_fails_the_limit(logits):
    cfg, _, ref, control = logits
    gap = judge.logit_gap([control], [ref])
    assert gap > cfg["limits"]["logit_gap"], gap


def test_tf32_rounds_to_ten_mantissa_bits():
    from reference import cnn_ops
    x = torch.tensor([1 + 2**-11, 1 + 3 * 2**-11, -(1 + 2**-10 + 2**-12),
                      1 / 3], dtype=torch.float32)
    got = cnn_ops.to_tf32(x)
    assert got[0] == 1.0                              # tie to even: down
    assert got[1] == 1 + 2 * 2**-10                   # tie to even: up
    assert got[2] == -(1 + 2**-10)
    assert abs(float(got[3]) - 1 / 3) <= 2**-12
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
