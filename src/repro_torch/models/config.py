"""Model configuration — one dataclass covers the whole assigned pool.

The layer stack is described by a *period*: ``layer_pattern`` lists the
mixer type for each position in the period ("attn", "attn_local", "mamba")
and ``ffn_pattern`` the ffn type ("dense", "moe", "none").  The stack is
``n_layers / len(pattern)`` repetitions, implemented as a ``lax.scan`` over
stacked per-period parameters — this keeps HLO size O(period), which is what
makes 80-layer compiles tractable.

Precision is the paper's knob: ``precision`` names a PE config from
core.precision.PAPER_CONFIGS; all projection matmuls become quantization-
aware, with the fused dequant/BNS epilogue of eqs. (1)/(2).
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    kind: str = "lm"                       # lm | encdec | cnn
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0                      # 0 -> d_model // n_heads
    d_ff: int = 0
    vocab: int = 0
    rope_theta: float = 10000.0
    layer_pattern: tuple[str, ...] = ("attn",)
    ffn_pattern: tuple[str, ...] = ("dense",)
    window: int = 4096                     # sliding window for attn_local
    attn_softcap: float = 0.0              # gemma2: 50.0
    final_softcap: float = 0.0             # gemma2: 30.0
    post_norms: bool = False               # gemma2: RMSNorm after each
                                           # attention / FFN sub-block
    embed_scale: bool = False              # gemma2: embeddings x sqrt(d_model)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba-1)
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    dt_rank: int = 0                       # 0 -> ceil(d_model / 16)
    # enc-dec
    n_enc_layers: int = 0
    # modality frontend ("none": token ids; "embeds": precomputed embeddings
    # from the stub frontend — audio frames / ViT patches per spec)
    frontend: str = "none"
    # precision (the paper's contribution)
    precision: str = "fp32"                # key into PAPER_CONFIGS
    kv_bits: int = 0                       # 0 = bf16 KV cache; 8/4 = quantized
    quantize_lm_head: bool = False         # paper/WRPN keep last layer wide
    force_pure_dp: bool = False            # replicate params, DP-only serving
    moe_ep_constraints: str = ""           # ""|"ep"|"ep_fsdp": explicit EP
                                           # sharding constraints on MoE
                                           # dispatch buffers (§Perf)
    attn_probs_bf16: bool = False          # FA2-style: P·V matmul reads bf16
                                           # probabilities (softmax stats stay
                                           # fp32) — §Perf prefill lever
    moe_impl: str = "pjit"                 # "pjit" (slot-map) | "shard_map"
                                           # (explicit local dispatch + psum)
    # numerics / misc
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    act_fn: str = "silu"                   # silu (SwiGLU) | gelu
    ffn_gated: bool = True                 # 3-matrix GLU vs 2-matrix FFN
    width_mult: float = 1.0                # WRPN widening
    ssm_chunk: int = 128                   # chunked-scan length
    sub_quadratic: bool = False            # eligible for long_500k
    notes: str = ""

    # ---- derived ----
    @property
    def dh(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def period(self) -> int:
        return len(self.layer_pattern)

    @property
    def n_periods(self) -> int:
        assert self.n_layers % self.period == 0, (self.n_layers, self.period)
        return self.n_layers // self.period

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank_(self) -> int:
        return self.dt_rank or math.ceil(self.d_model / 16)

    @property
    def padded_vocab(self) -> int:
        return -(-self.vocab // 512) * 512

    @property
    def has_attention(self) -> bool:
        return any(p.startswith("attn") for p in self.layer_pattern)

    @property
    def n_params(self) -> int:
        """Total parameter count (for 6ND model-flops accounting)."""
        D, V = self.d_model, self.padded_vocab
        total = V * D  # embed
        if not self.tie_embeddings:
            total += D * V
        per_period = 0
        for mixer, ffn in zip(self.layer_pattern, self.ffn_pattern):
            if mixer.startswith("attn"):
                per_period += D * self.n_heads * self.dh * 2  # wq, wo
                per_period += D * self.n_kv_heads * self.dh * 2  # wk, wv
            elif mixer == "mamba":
                di, r, n = self.d_inner, self.dt_rank_, self.ssm_state
                per_period += D * 2 * di + di * self.ssm_conv
                per_period += di * (r + 2 * n) + r * di + di * n + 2 * di
                per_period += di * D
            if ffn == "dense":
                per_period += (3 if self.ffn_gated else 2) * D * self.d_ff
            elif ffn == "moe":
                per_period += D * self.n_experts
                per_period += self.n_experts * 3 * D * self.moe_d_ff
        total += per_period * self.n_periods
        total += D  # final norm
        return total

    @property
    def n_active_params(self) -> int:
        """Activated parameters per token (MoE: top_k experts only)."""
        if self.n_experts == 0:
            return self.n_params
        dense_moe = self.n_experts * 3 * self.d_model * self.moe_d_ff
        active_moe = self.top_k * 3 * self.d_model * self.moe_d_ff
        n_moe_layers = sum(1 for f in self.ffn_pattern if f == "moe") * self.n_periods
        return self.n_params - n_moe_layers * (dense_moe - active_moe)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    mode: str                              # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests: few layers, small width,
    few experts, small vocab — per the assignment spec."""
    updates = dict(
        n_layers=cfg.period * min(2, cfg.n_periods),
        d_model=128,
        n_heads=min(cfg.n_heads, 4) if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        head_dim=32 if cfg.n_heads else 0,
        d_ff=256 if cfg.d_ff else 0,
        vocab=min(cfg.vocab, 512),
        n_experts=min(cfg.n_experts, 4),
        top_k=min(cfg.top_k, 2),
        moe_d_ff=64 if cfg.moe_d_ff else 0,
        n_enc_layers=min(cfg.n_enc_layers, 2),
        dt_rank=8 if "mamba" in cfg.layer_pattern else 0,
        ssm_chunk=16,
        dtype="float32",
    )
    return dataclasses.replace(cfg, **updates)
