"""llama4-maverick-400b-a17b [moe] — 48L d=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 128 experts top-1, alternating MoE/dense layers (the
public Llama-4 Maverick interleave).  [hf:meta-llama/Llama-4-Scout-17B-16E;
unverified]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202_048,
    layout=(("attn", "moe"), ("attn", "dense")),
    moe=MoEConfig(num_experts=128, top_k=1),
)
