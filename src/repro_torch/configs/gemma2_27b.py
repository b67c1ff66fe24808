"""gemma2-27b [dense] — local+global alternating, logit softcaps.

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000  [arXiv:2408.00118]
Period of 2: sliding-window (4096) then global attention; attn softcap 50,
final-logit softcap 30; pre+post norms per sub-block (``post_norms``);
embeddings scaled by sqrt(d_model) (``embed_scale``).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab=256000,
    layer_pattern=("attn_local", "attn"),
    ffn_pattern=("dense", "dense"),
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    post_norms=True,
    embed_scale=True,
    act_fn="gelu",
    tie_embeddings=True,
    sub_quadratic=True,   # half the layers are 4k-window
    notes="local:global 1:1 alternation; softcaps per arXiv:2408.00118",
)
