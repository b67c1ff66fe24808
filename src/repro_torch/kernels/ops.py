"""Legacy entry points — thin re-exports of the precision-dispatch engine
(the counterpart of ``repro.kernels.ops``), so that
``from repro_torch.kernels.ops import quantized_matmul`` works as the
reference's import does; new code should use ``engine.qmatmul``.
"""
from __future__ import annotations

from .act_quant import act_quant, act_quant_signed  # noqa: F401 (re-export)
from .engine import (  # noqa: F401
    PackedWeight,
    hbm_bytes,
    pack_weight,
    qmatmul,
    quantized_matmul,
)
