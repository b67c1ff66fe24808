"""Precision configurations — the paper's PE menu as a first-class deployment knob.

The paper (Table II) enumerates processing-element configurations by
(activation bit-width x weight bit-width), including ternary (2-bit, {-1,0,+1})
and binary (1-bit, {-1,+1}) weights.  ``PrecisionConfig`` is the software
counterpart: every quantization-aware layer in this framework takes one and
dispatches to the matching compute path (bf16 baseline, int8 MXU, packed
Pallas kernels, XNOR-popcount).
"""
from __future__ import annotations

import dataclasses

# Weight encodings.  "int" covers 2..8-bit signed integers; ternary/binary are
# the paper's special cases with their own PE (and their own Pallas kernel here).
W_FLOAT = "float"      # bf16/fp32 — the paper's FP32 baseline
W_INT = "int"          # k-bit signed integer, per-channel alpha scale
W_TERNARY = "ternary"  # {-1, 0, +1} * alpha   (paper: "T")
W_BINARY = "binary"    # {-1, +1} * alpha      (paper: "B")

A_FLOAT = "float"
A_UNSIGNED = "unsigned"  # paper eq. 3/4: post-ReLU k-bit in [0, 1]
A_SIGNED = "signed"      # symmetric k-bit (transformer activations; DESIGN.md §8.3)


@dataclasses.dataclass(frozen=True)
class PrecisionConfig:
    """One point in the paper's (activation x weight) precision design space."""

    a_bits: int = 16               # activation bit-width (16 => bf16 float path)
    w_bits: int = 16               # weight bit-width
    w_mode: str = W_FLOAT
    a_mode: str = A_FLOAT
    accum_dtype: str = "int32"     # integer paths accumulate in int32 (paper: wide accum)
    # Pack k-bit weights into int32 words in HBM and unpack in-kernel (the TPU
    # analogue of the paper's bandwidth saving; DESIGN.md §2).
    pack_weights: bool = False
    # Quantize the KV cache (beyond-paper extension, same mechanism).
    kv_bits: int | None = None

    def __post_init__(self):
        if self.w_mode == W_TERNARY and self.w_bits != 2:
            raise ValueError("ternary weights are 2-bit")
        if self.w_mode == W_BINARY and self.w_bits != 1:
            raise ValueError("binary weights are 1-bit")
        if self.w_mode == W_INT and not (2 <= self.w_bits <= 8):
            raise ValueError(f"int weights support 2..8 bits, got {self.w_bits}")
        if self.a_mode != A_FLOAT and not (1 <= self.a_bits <= 8):
            raise ValueError(f"quantized activations support 1..8 bits, got {self.a_bits}")

    # ---- derived properties -------------------------------------------------
    @property
    def is_float(self) -> bool:
        return self.w_mode == W_FLOAT and self.a_mode == A_FLOAT

    @property
    def weight_levels(self) -> int:
        if self.w_mode == W_FLOAT:
            return 0
        if self.w_mode == W_TERNARY:
            return 3
        if self.w_mode == W_BINARY:
            return 2
        return 2 ** self.w_bits

    @property
    def act_levels(self) -> int:
        if self.a_mode == A_FLOAT:
            return 0
        return 2 ** self.a_bits

    @property
    def weight_storage_bits(self) -> int:
        """Bits per weight as stored (the paper's memory/bandwidth saving)."""
        if self.w_mode == W_FLOAT:
            return 16
        return self.w_bits

    @property
    def gop_bits(self) -> float:
        """The paper's "GOP bits" metric: ops x max(a_bits, w_bits) ... §IV.A
        uses a_bits*w_bits products counted as bit-ops; we follow its
        'GOP bits' = ops * max-bit convention (64x for FP32, 4x for 2xT)."""
        if self.is_float:
            return 64.0  # paper counts FP32 as 64 GOP-bits per 1.44-GOP AlexNet unit... (32b * 2-input)
        return float(max(self.a_bits, self.w_bits) * 2)

    @property
    def name(self) -> str:
        a = "f" if self.a_mode == A_FLOAT else str(self.a_bits)
        if self.w_mode == W_FLOAT:
            w = "f"
        elif self.w_mode == W_TERNARY:
            w = "T"
        elif self.w_mode == W_BINARY:
            w = "B"
        else:
            w = str(self.w_bits)
        return f"{a}x{w}"


# ---------------------------------------------------------------------------
# The paper's named configurations (Tables II/IV/V rows).
# ---------------------------------------------------------------------------
def _pc(a_bits, w_bits, w_mode, a_mode=A_UNSIGNED, **kw) -> PrecisionConfig:
    return PrecisionConfig(a_bits=a_bits, w_bits=w_bits, w_mode=w_mode, a_mode=a_mode, **kw)


PAPER_CONFIGS = {
    "fp32": PrecisionConfig(),                                   # float baseline
    "8x8": _pc(8, 8, W_INT),
    "8xT": _pc(8, 2, W_TERNARY, pack_weights=True),
    "8xB": _pc(8, 1, W_BINARY, pack_weights=True),
    "4x4": _pc(4, 4, W_INT, pack_weights=True),
    "3x3": _pc(3, 3, W_INT, pack_weights=False),                 # 3-bit doesn't pack evenly; stored int8
    "2x2": _pc(2, 2, W_INT, pack_weights=True),
    "2xT": _pc(2, 2, W_TERNARY, pack_weights=True),              # the Arria 10 proof-of-concept
    "1x1": _pc(1, 1, W_BINARY, pack_weights=True),               # XNOR-popcount
}

# Signed-activation variants for transformer blocks (DESIGN.md §8.3).
def signed(cfg: PrecisionConfig) -> PrecisionConfig:
    if cfg.a_mode == A_FLOAT:
        return cfg
    return dataclasses.replace(cfg, a_mode=A_SIGNED)


def get_precision(name: str) -> PrecisionConfig:
    """Look up a paper config by name ('2xT', '8x8', ...), or parse 'AxW'."""
    if name in PAPER_CONFIGS:
        return PAPER_CONFIGS[name]
    raise KeyError(f"unknown precision config {name!r}; known: {sorted(PAPER_CONFIGS)}")
