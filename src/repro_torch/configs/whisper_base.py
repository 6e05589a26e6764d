"""whisper-base [audio] — 6L enc + 6L dec, d=512 8H d_ff=2048 vocab=51865,
encoder-decoder; conv frontend is a STUB (input_specs provides precomputed
frame embeddings, per the assignment).  [arXiv:2212.04356; unverified]

Adaptation note: positions use RoPE (substrate default) instead of
learned/sinusoidal embeddings — recorded in DESIGN.md §8.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-base",
    family="audio",
    num_layers=6,                      # decoder layers
    encoder_layers=6,
    encoder_seq=1500,                  # stub frame embeddings
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    layout=(("attn_cross", "dense"),),
    ffn_activation="gelu",
)
