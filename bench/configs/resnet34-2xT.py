"""ResNet-34 at 2xT through the port's CNN entry.

``resnet34-2xT.json`` gives the stem, the stages of basic blocks and the
classes: the float leaves drawn from the seed, in the port's param tree
(``models/cnn.py``: ``stem``, ``stages[s][b]`` with ``conv1``, ``conv2``
and, where a block changes shape, ``proj``; ``head``), and the products for
the work counts.  Set-up packs the tree with ``cnn_to_serving``; the timed
call is ``resnet_apply`` on the packed tree.
"""
from __future__ import annotations

import costs
import weights


def walk(cfg: dict, batch: int):
    """(key, layer) a product, in the order a forward runs them."""
    h, w, c = cfg["input_shape"]
    c_out, kernel, stride, pad = cfg["stem"]
    stem, h, w = costs.conv("stem", batch, h, w, c, c_out, kernel, stride,
                            pad, cfg["w_bits"])
    yield "stem", stem
    pk, ps = cfg["stem_pool"]
    h, w, c = costs.out_size(h, pk, ps, 0), costs.out_size(w, pk, ps, 0), c_out
    for s, (width, n_blocks) in enumerate(cfg["stages"]):
        for b in range(n_blocks):
            st = 2 if (s > 0 and b == 0) else 1
            pre = f"stages.{s}.{b}"
            c1, p, q = costs.conv(f"{pre}.conv1", batch, h, w, c, width, 3, st,
                                  1, cfg["w_bits"])
            c2, _, _ = costs.conv(f"{pre}.conv2", batch, p, q, width, width,
                                  3, 1, 1, cfg["w_bits"])
            yield f"{pre}.conv1", c1
            yield f"{pre}.conv2", c2
            if c != width or st != 1:
                proj, _, _ = costs.conv(f"{pre}.proj", batch, h, w, c, width,
                                        1, st, 0, cfg["w_bits"])
                yield f"{pre}.proj", proj
            h, w, c = p, q, width
    yield "head", costs.dense("head", batch, c, cfg["n_classes"], 32,
                              quantized=False)


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
    return cnn.resnet_apply(state, x, depth=cfg["depth"],
                            precision=cfg["precision"])
