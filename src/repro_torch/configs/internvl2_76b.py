"""internvl2-76b [vlm] — InternViT + InternLM2 (backbone only).

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256  [arXiv:2404.16821]
The InternViT frontend is a stub (``models.frontends``): the model takes
patch embeddings (B, S, D) directly (frontend="embeds").
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    layer_pattern=("attn",),
    ffn_pattern=("dense",),
    frontend="embeds",
    sub_quadratic=False,
)
