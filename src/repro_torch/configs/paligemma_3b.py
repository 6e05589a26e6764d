"""paligemma-3b [vlm] — 18L d=2048 8H (MQA kv=1) d_ff=16384 vocab=257216,
SigLIP vision frontend STUBBED (input_specs provides precomputed patch
embeddings, width 1152, projected by a learned linear).
[arXiv:2407.07726; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257_216,
    vision_tokens=256,
    vision_embed_dim=1152,
    ffn_activation="gelu",
)
