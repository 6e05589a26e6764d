"""chatglm3-6b [dense] — 28L d=4096 32H (GQA kv=2) d_ff=13696 vocab=65024,
2-d RoPE (rotary on half the head dim), QKV bias.  [arXiv:2406.12793; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="chatglm3-6b",
    family="dense",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=65024,
    qkv_bias=True,
    rope_fraction=0.5,     # "RoPE 2d": rotary applied to half the dims
)
