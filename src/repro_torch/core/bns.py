"""BNS fusion — paper §III.A eqs. (1)/(2), as ``repro.core.bns``.

After a low-bit dot product the training datapath is

    y = dot(x, w_q)                    # integer/ternary/binary accumulate
    y = alpha * y                      # per-feature weight scale
    y = (y - mu) / sigma               # batch-norm statistics
    y = scale * y + shift              # learned scale and shift
    y = relu(y); y = q(y)              # eq. (4) re-quantize

At inference the paper folds alpha + BN + scale into ONE per-feature
multiply-add:   gamma = (y/x) * alpha ,   beta = z - (y/x) * w
(the paper's notation: w = BN mean, x = sqrt(var + eps), y = scale,
z = shift), so the accelerator applies one fused scale-shift ("BNS") after
the PE array.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class BNSParams(NamedTuple):
    """Fused per-feature scale-shift: y = gamma * acc + beta."""
    gamma: torch.Tensor
    beta: torch.Tensor


def fuse_bns(bn_mean, bn_var, bn_eps, scale, shift, alpha=None) -> BNSParams:
    """Paper eqs. (1)/(2): gamma = (y / x) * alpha, beta = z - (y / x) * w."""
    x = torch.sqrt(bn_var + bn_eps)
    y_over_x = scale / x
    if alpha is None:
        alpha = torch.ones_like(scale)
    return BNSParams(gamma=y_over_x * alpha, beta=shift - y_over_x * bn_mean)


def apply_bns(acc, p: BNSParams):
    """Apply the fused scale-shift to raw PE-array accumulators."""
    return acc * p.gamma + p.beta


def reference_bn_scale(acc, bn_mean, bn_var, bn_eps, scale, shift, alpha=None):
    """The unfused datapath (training graph), to check the fold against."""
    if alpha is not None:
        acc = acc * alpha
    y = (acc - bn_mean) / torch.sqrt(bn_var + bn_eps)
    return y * scale + shift


def fold_dequant_into_gamma(p: BNSParams, act_scale: float, w_scale) -> BNSParams:
    """The integer-GEMM dequant scales (activation scale x per-channel weight
    scale) fold into gamma the way alpha does: still one fused scale-shift
    per feature."""
    return BNSParams(gamma=p.gamma * act_scale * w_scale, beta=p.beta)


def fuse_act_quant_levels(p: BNSParams, bits: int) -> BNSParams:
    """Fold the /(2^k - 1) of the eq. (4) dequant into the NEXT layer's
    gamma: activations stay integer codes 0..2^k-1."""
    levels = (1 << bits) - 1
    return BNSParams(gamma=p.gamma / levels, beta=p.beta)
