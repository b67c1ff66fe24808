"""AlexNet at 2xT through the port's CNN entry.

The layer list of ``alexnet-2xT.json`` gives the shapes: the float leaves
drawn from the seed, in the port's param tree (``models/cnn.py``), and the
products for the work counts.  Set-up packs the tree with
``cnn_to_serving``; the timed call is ``alexnet_apply`` on the packed tree.
"""
from __future__ import annotations

import costs
import weights


def walk(cfg: dict, batch: int):
    """(key, layer) a product, in the order a forward runs them: the convs
    ``conv.<i>``, the fully connected ``fc1``, ``fc2`` and the f32 ``head``."""
    h, w, c = cfg["input_shape"]
    n_conv = n_fc = 0
    for kind, c_out, kernel, stride, pad in cfg["layers"]:
        if kind == "conv":
            key = f"conv.{n_conv}"
            layer, h, w = costs.conv(key, batch, h, w, c, c_out, kernel,
                                     stride, pad, cfg["w_bits"])
            n_conv += 1
        elif kind == "pool":
            h = costs.out_size(h, kernel, stride, 0)
            w = costs.out_size(w, kernel, stride, 0)
            continue
        elif kind == "fc":
            n_fc += 1
            key = f"fc{n_fc}"
            layer = costs.dense(key, batch, h * w * c, c_out, cfg["w_bits"])
        else:
            key = "head"
            layer = costs.dense(key, batch, h * w * c, c_out, 32,
                                quantized=False)
        if kind != "conv":
            h = w = 1
        c = c_out
        yield key, layer


def draw(cfg: dict, seed: int, device):
    return weights.draw(weights.layer_leaves(walk(cfg, 1)), cfg, seed,
                        device)


def prepare(flat: dict, cfg: dict):
    """The port's set-up: the float tree packed into its serving form."""
    from repro_torch.models import cnn
    return cnn.cnn_to_serving(weights.unflatten(flat), cfg["precision"])


def forward(state, x, cfg: dict):
    """The timed call: (B, H, W, 3) float32 images to (B, classes) logits."""
    from repro_torch.models import cnn
    return cnn.alexnet_apply(state, x, precision=cfg["precision"])
