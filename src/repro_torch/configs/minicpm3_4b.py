"""minicpm3-4b [dense] — 62L d=2560 40H d_ff=6400 vocab=73448, MLA
(multi-head latent attention, DeepSeek-V2 style).
[hf:openbmb/MiniCPM3-4B; hf]
"""
from repro_torch.configs.base import ModelConfig, MLAConfig

CONFIG = ModelConfig(
    arch_id="minicpm3-4b",
    family="dense",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    head_dim=96,           # rope(32) + nope(64)
    d_ff=6400,
    vocab_size=73448,
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                  rope_head_dim=32, nope_head_dim=64, v_head_dim=64),
)
