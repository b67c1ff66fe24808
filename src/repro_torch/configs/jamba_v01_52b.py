"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536  [arXiv:2403.19887; hf]
Period of 8: one attention layer (position 3, as in the paper's block) among
7 mamba layers; MoE replaces the dense FFN every other layer (e=16, top-2).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    layer_pattern=("mamba", "mamba", "mamba", "attn",
                   "mamba", "mamba", "mamba", "mamba"),
    ffn_pattern=("dense", "moe", "dense", "moe",
                 "dense", "moe", "dense", "moe"),
    n_experts=16,
    top_k=2,
    moe_d_ff=14336,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    sub_quadratic=True,
    notes="hybrid 1:7 attn:mamba interleave per arXiv:2403.19887",
)
