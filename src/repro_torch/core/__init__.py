"""Core — the paper's contribution: precision configs, quantizers, BNS
fusion, WRPN widening and the FPGA performance modeler (the counterpart of
``repro.core``)."""
from .precision import (  # noqa: F401
    PAPER_CONFIGS,
    PrecisionConfig,
    get_precision,
    signed,
    A_FLOAT,
    A_SIGNED,
    A_UNSIGNED,
    W_BINARY,
    W_FLOAT,
    W_INT,
    W_TERNARY,
)
from .quantize import (  # noqa: F401
    act_fake_quant,
    act_quant_codes_signed,
    act_quant_codes_unsigned,
    binary_quant,
    int_quant,
    ternary_quant,
    weight_fake_quant,
    weight_quant,
)
from .bns import BNSParams, apply_bns, fuse_bns, reference_bn_scale  # noqa: F401
from .packing import pack, unpack, pack_binary_pm1, unpack_binary_pm1  # noqa: F401
