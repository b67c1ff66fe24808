"""The reference forward of ``alexnet-2xT``: the configuration's layer list
through :mod:`cnn_ops`, plain PyTorch.  Imports nothing of the program."""
from __future__ import annotations

from reference import cnn_ops


def forward(params: dict, x, cfg: dict, tf32: bool = False, chunk: int = 32):
    """Logits (B, classes) of (B, H, W, 3) images; ``params`` the float
    leaves by key (``conv.<i>``, ``fc<j>``, ``head``); the convs and fully
    connected layers in blocks of ``chunk`` images, the head on all."""
    bits = cfg["a_bits"]

    def features(xb):
        n_conv = n_fc = 0
        for kind, _, kernel, stride, pad in cfg["layers"]:
            if kind == "conv":
                xb = cnn_ops.qconv(xb, *cnn_ops.layer(params, f"conv.{n_conv}"),
                                   kernel, stride, pad, bits, tf32=tf32)
                n_conv += 1
            elif kind == "pool":
                xb = cnn_ops.max_pool(xb, kernel, stride)
            elif kind == "fc":
                n_fc += 1
                xb = cnn_ops.qdense(xb.reshape(xb.shape[0], -1),
                                    *cnn_ops.layer(params, f"fc{n_fc}"), bits,
                                    True, tf32)
        return xb.reshape(xb.shape[0], -1)

    return cnn_ops.mm(cnn_ops.in_chunks(features, x, chunk),
                      params["head.qw"], tf32)
