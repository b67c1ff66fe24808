"""AlexNet / ResNet with quantized convolutions — the paper's own topologies,
as ``repro.models.cnn``.

Conv = im2col + the SAME precision-dispatch dot as the LM stack, then the
fused BNS block (paper eqs. 1/2: BN + scale + alpha folded into one
per-feature multiply-add) and the eq. (4) activation re-quantization: the
paper's §III datapath, end to end:

    PE array (quantized dot) -> BNS -> ReLU -> q(x) -> next layer

Activations are NHWC (B, H, W, C) at every public function, as in the JAX
package, and a conv weight is (R*S*C, N) with each patch flattened in
(R, S, C) order.  No convolution goes through cuDNN: im2col feeds
``engine.qmatmul`` (the ternary / XNOR kernels on the card) or, for the
``{"qw"}`` form, ``engine.fake_quant_dot``.  Every apply function takes an
optional ``backend`` ("cuda" | "torch"; None picks by device) that reaches
each engine dispatch.

Params are plain nested dicts and lists, leaf for leaf the reference's
tree.  Inits draw from an explicit ``torch.Generator`` onto an explicit
device (numbers differ from ``jax.random``'s: parity tests start from the
reference's params through ``interop``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.bns import BNSParams, apply_bns
from repro_torch.core.precision import (A_FLOAT, PrecisionConfig, W_FLOAT,
                                        get_precision)
from repro_torch.core.quantize import act_fake_quant
from repro_torch.core.widening import widen_cnn_channels
from repro_torch.kernels import engine

from .layers import _randn


def _im2col(x, r, s, stride, pad):
    """x: (B, H, W, C) -> patches (B, P, Q, R*S*C), each patch in (R, S, C)
    order; zero padding."""
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    cols = xp.unfold(1, r, stride).unfold(2, s, stride)   # (B, P, Q, C, R, S)
    b, p, q = cols.shape[:3]
    return cols.permute(0, 1, 2, 4, 5, 3).reshape(b, p, q, -1)


def qconv_init(generator, c_in, c_out, r, device):
    fan_in = c_in * r * r
    w = _randn(generator, (fan_in, c_out), device) * (2.0 / fan_in) ** 0.5
    return {"qw": w,
            "bns_gamma": torch.ones((c_out,), dtype=torch.float32, device=device),
            "bns_beta": torch.zeros((c_out,), dtype=torch.float32, device=device)}


def qconv_apply(p, x, r, stride, pad, pcfg: PrecisionConfig,
                quantize_out: bool = True, backend: str | None = None):
    """Quantized conv + fused BNS + ReLU + eq. (4) requant.

    The packed serving form ``{"wt_packed", "scale"}`` runs the registry
    kernel for the config; the ``{"qw"}`` form runs the fake-quant float
    dot."""
    patches = _im2col(x, r, r, stride, pad)
    b, pp, qq, kdim = patches.shape
    p2 = patches.reshape(-1, kdim)
    if "wt_packed" in p:
        pw = engine.as_packed_weight(p, pcfg)
        acc = engine.qmatmul(p2, pw, pcfg, backend=backend)
    else:
        acc = engine.fake_quant_dot(p2, p["qw"], pcfg, axis=0)
    acc = acc.reshape(b, pp, qq, -1)
    out = torch.relu(apply_bns(acc, BNSParams(p["bns_gamma"], p["bns_beta"])))
    if quantize_out:
        out = act_fake_quant(out, pcfg)
    return out


def _maxpool(x, k, stride):
    """VALID max pooling over H and W of (B, H, W, C)."""
    return x.unfold(1, k, stride).unfold(2, k, stride).amax(dim=(-2, -1))


# ---------------------------------------------------------------------------
# AlexNet (paper §IV.B topology, WRPN-widenable)
# ---------------------------------------------------------------------------
ALEXNET_KERNELS = [11, 5, 3, 3, 3]
ALEXNET_STRIDES = [4, 1, 1, 1, 1]
ALEXNET_PADS = [2, 2, 1, 1, 1]
ALEXNET_POOLS = [True, True, False, False, True]


def alexnet_init(generator, device, width_mult: float = 1.0,
                 n_classes: int = 1000, input_ch: int = 3):
    chans = widen_cnn_channels([input_ch, 64, 192, 384, 256, 256, n_classes],
                               width_mult)[1:-1]
    c_in = [input_ch] + chans[:-1]
    params = {"conv": [qconv_init(generator, c_in[i], chans[i],
                                  ALEXNET_KERNELS[i], device)
                       for i in range(5)]}
    params["fc1"] = qconv_init(generator, chans[-1] * 6 * 6, 4096, 1, device)
    params["fc2"] = qconv_init(generator, 4096, 4096, 1, device)
    params["head"] = {"qw": _randn(generator, (4096, n_classes), device)
                      * 4096 ** -0.5}
    return params


def alexnet_apply(params, x, precision: str = "fp32",
                  backend: str | None = None):
    """x: (B, 224, 224, 3) -> logits (B, n_classes)."""
    pcfg = get_precision(precision)
    for i in range(5):
        x = qconv_apply(params["conv"][i], x, ALEXNET_KERNELS[i],
                        ALEXNET_STRIDES[i], ALEXNET_PADS[i], pcfg,
                        backend=backend)
        if ALEXNET_POOLS[i]:
            x = _maxpool(x, 3, 2)
    b = x.shape[0]
    x = x.reshape(b, 1, 1, -1)
    x = qconv_apply(params["fc1"], x, 1, 1, 0, pcfg, backend=backend)
    x = qconv_apply(params["fc2"], x, 1, 1, 0, pcfg, backend=backend)
    # the classifier stays full precision (paper/WRPN convention)
    return x.reshape(b, -1) @ params["head"]["qw"]


# ---------------------------------------------------------------------------
# Tiny CNN of the same family for CPU-scale experiments
# ---------------------------------------------------------------------------
def tinynet_init(generator, device, width_mult: float = 1.0,
                 n_classes: int = 10, input_ch: int = 1):
    chans = widen_cnn_channels([input_ch, 16, 32, n_classes], width_mult)[1:-1]
    return {"conv": [qconv_init(generator, input_ch, chans[0], 3, device),
                     qconv_init(generator, chans[0], chans[1], 3, device)],
            "head": {"qw": _randn(generator, (chans[1] * 7 * 7, n_classes),
                                  device) * 0.02}}


def tinynet_apply(params, x, precision: str = "fp32",
                  backend: str | None = None):
    """x: (B, 28, 28, C) -> logits."""
    pcfg = get_precision(precision)
    x = qconv_apply(params["conv"][0], x, 3, 1, 1, pcfg, backend=backend)
    x = _maxpool(x, 2, 2)
    x = qconv_apply(params["conv"][1], x, 3, 1, 1, pcfg, backend=backend)
    x = _maxpool(x, 2, 2)
    return x.reshape(x.shape[0], -1) @ params["head"]["qw"]


# ---------------------------------------------------------------------------
# train form -> packed serving form (engine PackedWeight per conv)
# ---------------------------------------------------------------------------
def cnn_to_serving(params, precision: str):
    """Replace every conv/fc ``{"qw"}`` (BNS layers only: the classifier
    head stays full precision, WRPN convention) with the engine's packed
    serving form; ``qconv_apply`` then dispatches the integer kernels."""
    pcfg = get_precision(precision)
    if pcfg.w_mode == W_FLOAT:
        return params

    def walk(node):
        if isinstance(node, dict):
            if "qw" in node and "bns_gamma" in node:
                pw = engine.pack_weight(node["qw"].to(torch.float32), pcfg)
                out = {"wt_packed": pw.wt_packed, "scale": pw.scale}
                out.update({k: v for k, v in node.items() if k != "qw"})
                return out
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(params)


# ---------------------------------------------------------------------------
# ResNet-34 / ResNet-50 (paper §IV.C projection topologies)
# ---------------------------------------------------------------------------
BLOCKS_PER_STAGE = [3, 4, 6, 3]


def _resnet_stages(width_mult: float):
    return [int(round(c * width_mult)) for c in (64, 128, 256, 512)]


def resnet_init(generator, device, depth: int = 34, width_mult: float = 1.0,
                n_classes: int = 1000, input_ch: int = 3):
    """He et al. configurations; widening multiplies stage channels (WRPN).
    depth in {34 (basic blocks), 50 (bottleneck)}."""
    if depth not in (34, 50):
        raise ValueError(f"depth {depth}: ResNet-34 or ResNet-50")
    chans = _resnet_stages(width_mult)
    expansion = 1 if depth == 34 else 4
    params = {"stem": qconv_init(generator, input_ch, chans[0], 7, device),
              "stages": []}
    c_in = chans[0]
    for stage, (c, n_blocks) in enumerate(zip(chans, BLOCKS_PER_STAGE)):
        blocks = []
        for b in range(n_blocks):
            c_out = c * expansion
            if depth == 34:
                blk = {"conv1": qconv_init(generator, c_in, c, 3, device),
                       "conv2": qconv_init(generator, c, c, 3, device)}
            else:
                blk = {"conv1": qconv_init(generator, c_in, c, 1, device),
                       "conv2": qconv_init(generator, c, c, 3, device),
                       "conv3": qconv_init(generator, c, c_out, 1, device)}
            if c_in != c_out or (b == 0 and stage > 0):
                blk["proj"] = qconv_init(generator, c_in, c_out, 1, device)
            blocks.append(blk)
            c_in = c_out
        params["stages"].append(blocks)
    params["head"] = {"qw": _randn(generator, (c_in, n_classes), device)
                      * c_in ** -0.5}
    return params


def resnet_apply(params, x, depth: int = 34, precision: str = "fp32",
                 backend: str | None = None):
    """x: (B, H, W, 3) -> logits.  Per conv: quantized dot -> fused BNS ->
    ReLU -> eq. (4) requant; residual adds in higher precision (the
    accumulators stay wide, paper §III.A)."""
    pcfg = get_precision(precision)
    x = qconv_apply(params["stem"], x, 7, 2, 3, pcfg, backend=backend)
    x = _maxpool(x, 3, 2)
    for stage, blocks in enumerate(params["stages"]):
        for b, blk in enumerate(blocks):
            stride = 2 if (stage > 0 and b == 0) else 1
            h = x
            if depth == 34:
                h = qconv_apply(blk["conv1"], h, 3, stride, 1, pcfg,
                                backend=backend)
                h = qconv_apply(blk["conv2"], h, 3, 1, 1, pcfg,
                                quantize_out=False, backend=backend)
            else:
                h = qconv_apply(blk["conv1"], h, 1, stride, 0, pcfg,
                                backend=backend)
                h = qconv_apply(blk["conv2"], h, 3, 1, 1, pcfg,
                                backend=backend)
                h = qconv_apply(blk["conv3"], h, 1, 1, 0, pcfg,
                                quantize_out=False, backend=backend)
            sc = x
            if "proj" in blk:
                sc = qconv_apply(blk["proj"], sc, 1, stride, 0, pcfg,
                                 quantize_out=False, backend=backend)
            x = torch.relu(h + sc)
            if pcfg.a_mode != A_FLOAT:
                x = act_fake_quant(x, pcfg)
    return x.mean(dim=(1, 2)) @ params["head"]["qw"]
