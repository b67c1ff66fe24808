"""Hand-written CUDA kernels for the paper's low-precision processing
elements, behind the precision-dispatch engine — the counterpart of
``repro.kernels``.

The kernel zoo (packed / ternary / binary matmul, the attention kernels,
the activation quantizers; ``csrc/``) sits behind a registry keyed on
``(weight_kind, act_bits, weight_bits, backend)`` with a single entry point
``qmatmul(x, packed_w, cfg)`` whose kernel choice per shape class comes
from the tuning cache (:mod:`repro_torch.kernels.tuning`).  The per-kernel
modules are implementation detail; everything else dispatches through the
engine:

qmatmul          — THE dispatch point: config -> kernel (+ tuned choice)
pack_weight      — float (K, N) weight -> quantized+packed PackedWeight
act_quant        — fused eq.(4) clip-round quantizer
decode_attention — flash-decode over an int8-quantized KV cache

Each kernel has a plain PyTorch version, which a CPU tensor runs; the
kernels build with ``nvcc`` at first CUDA use (``_build``).
"""
from . import tuning  # noqa: F401
from .act_quant import (act_quant, act_quant_signed,  # noqa: F401
                        act_quant_signed_grouped)
from .decode_attention import decode_attention  # noqa: F401
from .engine import (  # noqa: F401
    PackedWeight,
    PrecisionVariant,
    as_packed_weight,
    available_kernels,
    clear_variants,
    default_backend,
    fake_quant_dot,
    hbm_bytes,
    pack_weight,
    qmatmul,
    quantized_matmul,
    register_kernel,
    register_variant,
    registered_variants,
    resolve,
    variant_tune_plans,
)
