"""The reference forward of ``resnet34-2xT``: He et al.'s 34-layer network
with basic blocks, as the configuration gives it, through :mod:`cnn_ops`,
plain PyTorch.  Each block: conv1 (re-quantized), conv2 (BNS and ReLU, not
re-quantized), the shortcut (a 1x1 projection, BNS and ReLU, where the
block changes shape), ``relu(conv2 + shortcut)`` in f32, then the eq. (4)
levels.  Imports nothing of the program."""
from __future__ import annotations

import torch

from reference import cnn_ops


def forward(params: dict, x, cfg: dict, tf32: bool = False, chunk: int = 32):
    """Logits (B, classes) of (B, H, W, 3) images; ``params`` the float
    leaves by key (``stem``, ``stages.<s>.<b>.conv1|conv2|proj``,
    ``head``); the network in blocks of ``chunk`` images, the head on
    all."""
    bits = cfg["a_bits"]

    def features(xb):
        _, kernel, stride, pad = cfg["stem"]
        xb = cnn_ops.qconv(xb, *cnn_ops.layer(params, "stem"), kernel, stride,
                           pad, bits, tf32=tf32)
        xb = cnn_ops.max_pool(xb, *cfg["stem_pool"])
        for s, (width, n_blocks) in enumerate(cfg["stages"]):
            for b in range(n_blocks):
                st = 2 if (s > 0 and b == 0) else 1
                pre = f"stages.{s}.{b}"
                h = cnn_ops.qconv(xb, *cnn_ops.layer(params, f"{pre}.conv1"),
                                  3, st, 1, bits, tf32=tf32)
                h = cnn_ops.qconv(h, *cnn_ops.layer(params, f"{pre}.conv2"),
                                  3, 1, 1, bits, requant=False, tf32=tf32)
                if f"{pre}.proj.qw" in params:
                    sc = cnn_ops.qconv(xb, *cnn_ops.layer(params, f"{pre}.proj"),
                                       1, st, 0, bits, requant=False, tf32=tf32)
                else:
                    sc = xb
                xb = cnn_ops.levels(torch.relu(h + sc), bits)
        return xb.mean(dim=(1, 2))

    return cnn_ops.mm(cnn_ops.in_chunks(features, x, chunk),
                      params["head.qw"], tf32)
