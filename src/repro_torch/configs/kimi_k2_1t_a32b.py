"""kimi-k2-1t-a32b [moe] — trillion-param MoE (paper-table).

61L d_model=7168 64H (GQA kv=8) Dh=112 d_ff=2048(expert) vocab=163840,
MoE 384e top-8  [arXiv:2501.kimi2]
Fine-grained DeepSeek-style experts (d_ff=2048 each).  The paper's biggest
storage case: 1T params bf16 = 2.06 TB -> 2-bit packed 0.26 TB.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=112,
    d_ff=2048,
    vocab=163840,
    layer_pattern=("attn",),
    ffn_pattern=("moe",),
    n_experts=384,
    top_k=8,
    moe_d_ff=2048,
    capacity_factor=1.25,
    sub_quadratic=False,
    notes="first-layer-dense and shared-expert details of the release are "
          "simplified to uniform MoE layers, as in the reference config",
)
