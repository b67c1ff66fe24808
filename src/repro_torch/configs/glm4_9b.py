"""glm4-9b [dense] — RoPE, GQA kv=2.

40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552  [hf:THUDM/glm-4-9b]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab=151552,
    layer_pattern=("attn",),
    ffn_pattern=("dense",),
    sub_quadratic=False,
)
