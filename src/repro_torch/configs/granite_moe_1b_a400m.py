"""granite-moe-1b-a400m [moe] — 32 experts top-8.

24L d_model=1024 16H (GQA kv=8) d_ff=512(expert) vocab=49155
[hf:ibm-granite/granite-3.0-1b-a400m-base]
Vocab padded to 49664.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    layer_pattern=("attn",),
    ffn_pattern=("moe",),
    n_experts=32,
    top_k=8,
    moe_d_ff=512,
    tie_embeddings=True,
    sub_quadratic=False,
)
