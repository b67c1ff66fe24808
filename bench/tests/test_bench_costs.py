"""``costs.py`` against hand counts: one AlexNet layer at the cell's
batch, and each configuration's operations an image."""
from __future__ import annotations

import json

import pytest
from bench_testing import BENCH

import costs


def _layers(name: str, batch: int):
    import run
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    return [x for _, x in run.load_module("configs", name).walk(cfg, batch)]


def test_alexnet_conv2_by_hand():
    """conv2 at batch 256: 27 x 27 outputs of 5 x 5 x 64 fields into 192
    channels; bytes: the 27 x 27 x 64 input map and the 27 x 27 x 192
    output map as int8, the 1600 x 192 weight at 2 bits."""
    conv2 = _layers("alexnet-2xT", 256)[1]
    m, n, k = 256 * 27 * 27, 192, 5 * 5 * 64
    assert (conv2.m, conv2.n, conv2.k) == (m, n, k)
    assert costs.ops(conv2) == 2 * 186624 * 192 * 1600 == 114_661_785_600
    assert costs.min_bytes(conv2) == 256 * 27 * 27 * 64 + 1600 * 192 / 4 \
        + 186624 * 192
    assert costs.bound_s(conv2) == pytest.approx(114_661_785_600 / 1979e12)


def test_alexnet_layers_by_hand():
    got = [(x.name, x.m, x.n, x.k, x.quantized)
           for x in _layers("alexnet-2xT", 1)]
    assert got == [("conv.0", 55 * 55, 64, 363, True),
                   ("conv.1", 27 * 27, 192, 1600, True),
                   ("conv.2", 13 * 13, 384, 1728, True),
                   ("conv.3", 13 * 13, 256, 3456, True),
                   ("conv.4", 13 * 13, 256, 2304, True),
                   ("fc1", 1, 4096, 9216, True),
                   ("fc2", 1, 4096, 4096, True),
                   ("head", 1, 1000, 4096, False)]


@pytest.mark.parametrize("name, quantized, gops", [("alexnet-2xT", 7, 1.428),
                                                   ("resnet34-2xT", 36, 7.278)])
def test_operations_an_image(name, quantized, gops):
    layers = _layers(name, 1)
    assert sum(x.quantized for x in layers) == quantized
    assert costs.model_ops(layers) / 1e9 == pytest.approx(gops, rel=2e-3)
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    assert costs.model_ops(layers) / 1e9 == pytest.approx(
        cfg["gops_per_image"], rel=2e-3)
