"""jamba-1.5-large-398b [hybrid] — 72L d=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2, Mamba:attention 7:1 interleave (one attention
layer per 8-layer period), MoE every other layer.  [arXiv:2403.19887; hf]

Adaptation note (DESIGN.md §8): Jamba's mamba blocks are Mamba-1; this
framework implements the SSD (Mamba-2) mixer for all SSM layers — same
state-space family, chunked-scan formulation.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

_PERIOD = tuple(
    (("attn" if i == 0 else "mamba"), ("moe" if i % 2 == 1 else "dense"))
    for i in range(8)
)

CONFIG = ModelConfig(
    arch_id="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    layout=_PERIOD,
    moe=MoEConfig(num_experts=16, top_k=2),
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64, n_groups=1),
    supports_long_context=True,
)
