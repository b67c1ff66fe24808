"""Float-form -> serving-form parameter conversion (``repro.models.convert``).

Walks the param tree and replaces every qlinear ``{"qw": (..., K, N)}`` with
the packed serving form ``{"wt_packed", "scale"}``.

Pack-vs-int8 fallback rule: the K axis of a matrix is packed only if every
tensor-parallel shard's slice is word-aligned — ``K_eff % (32/bits) == 0``
where K_eff = K/tp when this matrix is K-sharded (wo / w_down / w_out) and
divisible, else K.  Misaligned cases store int8 codes.  ``tp`` keeps the
reference's default of 16, so the same call packs the same layout in both
packages; single-card serving passes ``tp=1``.
"""
from __future__ import annotations

import torch

from repro_torch.core import packing
from repro_torch.core.precision import (PrecisionConfig, W_BINARY, W_FLOAT,
                                        W_TERNARY, get_precision)
from repro_torch.core.quantize import weight_quant

from .config import ModelConfig

# matrices whose K (contraction) axis is sharded over the model axis
_K_SHARDED = ("wo", "w_down", "w_out")


def _bits_of(pcfg: PrecisionConfig) -> int:
    if pcfg.w_mode == W_BINARY:
        return 1
    if pcfg.w_mode == W_TERNARY:
        return 2
    return pcfg.w_bits


def _packable(k: int, bits: int, k_sharded: bool, tp: int) -> bool:
    cpw = 32 // bits if 32 % bits == 0 else 0
    if not cpw:
        return False
    k_eff = k // tp if (k_sharded and k % tp == 0) else k
    return k_eff % cpw == 0


def _convert_qw(w, pcfg, bits, k_sharded, tp):
    """w: (..., K, N) — leading dims are the period stacking."""
    k = w.shape[-2]
    codes, scale = weight_quant(w.to(torch.float32), pcfg, axis=-2)
    scale = scale.squeeze(-2)                              # (..., N)
    ct = codes.transpose(-1, -2).contiguous()              # (..., N, K)
    want_pack = pcfg.pack_weights or pcfg.w_mode == W_BINARY
    if want_pack and _packable(k, bits, k_sharded, tp):
        if pcfg.w_mode == W_BINARY:
            return {"wt_packed": packing.pack((ct > 0).to(torch.int8), 1),
                    "scale": scale}
        return {"wt_packed": packing.pack(ct, bits), "scale": scale}
    return {"wt_packed": ct, "scale": scale}               # int8 codes fallback


def to_serving(params, cfg: ModelConfig, tp: int = 16):
    """Convert an initialized param tree to the packed serving form."""
    pcfg = get_precision(cfg.precision)
    if pcfg.w_mode == W_FLOAT:
        return params
    bits = _bits_of(pcfg)

    def walk(node, path):
        if not isinstance(node, dict):
            return node
        if "qw" in node and path and \
                (path[-1] != "lm_head" or cfg.quantize_lm_head):
            out = _convert_qw(node["qw"], pcfg, bits, path[-1] in _K_SHARDED, tp)
            out.update({k: v for k, v in node.items() if k != "qw"})
            return out
        return {key: walk(val, path + (key,)) for key, val in node.items()}

    return walk(params, ())


def serving_param_bytes(params) -> int:
    """Total parameter bytes in serving form."""
    if isinstance(params, dict):
        return sum(serving_param_bytes(v) for v in params.values())
    return params.numel() * params.element_size()
