"""mamba2-1.3b [ssm] — 48L d=2048, attention-free SSD (state-space duality),
ssm_state=128, vocab=50280.  [arXiv:2405.21060; unverified]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    layout=(("mamba", "none"),),
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64, n_groups=1),
    tie_embeddings=True,
    supports_long_context=True,
)
