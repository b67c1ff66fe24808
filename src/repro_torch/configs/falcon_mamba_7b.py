"""falcon-mamba-7b [ssm] — mamba1 architecture, attention-free.

64L d_model=4096 (attn-free) d_ff=0 vocab=65024 ssm_state=16  [arXiv:2410.05355]
Mamba block: d_inner=8192 (expand 2), conv=4, dt_rank=ceil(4096/16)=256.
The SSM recurrence stays in fp32.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    n_layers=64,
    d_model=4096,
    d_ff=0,
    vocab=65024,
    layer_pattern=("mamba",),
    ffn_pattern=("none",),
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    sub_quadratic=True,
)
