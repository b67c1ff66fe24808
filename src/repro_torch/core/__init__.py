"""repro_torch.core."""
from .quantize import act_quant_codes_signed, act_quant_codes_unsigned  # noqa: F401
