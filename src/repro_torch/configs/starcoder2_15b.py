"""starcoder2-15b [dense] — GQA, RoPE.

40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152  [arXiv:2402.19173]
Non-gated GELU FFN (c_fc/c_proj).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab=49152,
    layer_pattern=("attn",),
    ffn_pattern=("dense",),
    act_fn="gelu",
    ffn_gated=False,
    sub_quadratic=False,
)
