"""whisper-base [audio] — enc-dec, conv frontend (stub).

6L d_model=512 8H (kv=8) d_ff=2048 vocab=51865  [arXiv:2212.04356]
The mel/conv frontend is a stub (``models.frontends``): the encoder takes
precomputed frame embeddings (B, S, D).  Backbone positional scheme: RoPE,
a deviation from whisper's absolute positions that the reference makes too.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    kind="encdec",
    n_layers=6,
    n_enc_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51865,
    layer_pattern=("attn",),
    ffn_pattern=("dense",),
    act_fn="gelu",
    ffn_gated=False,
    frontend="audio_stub",
    sub_quadratic=False,
)
