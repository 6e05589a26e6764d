"""Model configuration schema driving the whole model zoo.

Every assigned architecture is expressed as a ``ModelConfig``.  A model is a
stack of *periods*; each period is a static ``layout`` — a tuple of
(mixer, ffn) sub-layer descriptors — and the stack scans over
``num_periods`` copies (keeping the HLO small for 48-72 layer models).

mixer ∈ {"attn", "attn_cross", "mamba", "none"}
ffn   ∈ {"dense", "moe", "none"}
"""
from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3 style)."""
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    rope_head_dim: int = 32     # per-head rotary sub-dim
    nope_head_dim: int = 64     # per-head non-rotary sub-dim
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) mixer configuration."""
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    conv_width: int = 4
    chunk_size: int = 256


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 16
    top_k: int = 1
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    # layout: one period of sub-layers; the model is num_layers/len(layout)
    # scanned periods.  Entries are (mixer, ffn) strings.
    layout: Sequence[tuple[str, str]] = (("attn", "dense"),)
    # attention options
    qkv_bias: bool = False
    rope_fraction: float = 1.0       # chatglm3 uses 0.5 ("RoPE 2d")
    rope_theta: float = 10_000.0
    causal: bool = True
    mla: MLAConfig | None = None
    # ffn / moe
    ffn_activation: str = "silu"     # silu (SwiGLU) | gelu
    moe: MoEConfig | None = None
    # ssm
    ssm: SSMConfig | None = None
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0             # stub frame count (1500 for whisper)
    # vlm
    vision_tokens: int = 0           # stub patch count (256 for paligemma)
    vision_embed_dim: int = 0        # SigLIP output width fed to projector
    # norms / misc
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    # dtypes
    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"
    # training memory policy
    remat: bool = True
    attn_chunk: int = 512            # q-chunked attention block
    attn_kv_block: int = 4096        # KV streaming block (flash carry)
    loss_chunk: int = 512            # seq chunk for the vocab-sharded xent
    # sequence parallelism (Korthikanti et al.): between blocks the
    # residual stream is sharded over (data, model) on (batch, seq), so
    # norms/residual ops are fully sharded and the Megatron activation
    # all-reduce becomes reduce-scatter + all-gather (§Perf iteration A2).
    sequence_parallel: bool = True
    # int8 KV cache (§Perf B3): per-token-per-head symmetric quantization,
    # dequantized inside attention.  Halves decode cache footprint/read
    # traffic → 2× batch capacity per chip.  Serve-time feature.
    kv_cache_quant: bool = False
    # which serve shapes are valid (long_500k only for sub-quadratic archs)
    supports_long_context: bool = False

    @property
    def vocab_padded(self) -> int:
        """Vocab padded to a multiple of 256 so the embedding/lm_head shard
        evenly over any mesh axis ≤ 256 (Megatron-style vocab padding).
        Logits above ``vocab_size`` are masked to -inf in the loss."""
        return -(-self.vocab_size // 256) * 256

    @property
    def num_periods(self) -> int:
        if self.num_layers % len(self.layout):
            raise ValueError(
                f"{self.arch_id}: num_layers={self.num_layers} not "
                f"divisible by period length {len(self.layout)}")
        return self.num_layers // len(self.layout)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        return (self.ssm.expand * self.d_model) if self.ssm else 0

    def approx_params(self) -> int:
        """Rough parameter count (for the roofline MODEL_FLOPS term)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        total = v * d * (1 if self.tie_embeddings else 2)
        if self.vision_tokens:
            total += self.vision_embed_dim * d
        for (mixer, ffn) in self.layout * self.num_periods:
            if mixer == "attn":
                if self.mla:
                    c = self.mla
                    qh = self.num_heads * (c.rope_head_dim + c.nope_head_dim)
                    total += d * c.q_lora_rank + c.q_lora_rank * qh
                    total += d * (c.kv_lora_rank + c.rope_head_dim)
                    total += c.kv_lora_rank * self.num_heads * (
                        c.nope_head_dim + c.v_head_dim)
                    total += self.num_heads * c.v_head_dim * d
                else:
                    total += d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
            elif mixer == "attn_cross":
                total += 2 * (d * (self.q_dim + 2 * self.kv_dim)
                              + self.q_dim * d)
            elif mixer == "mamba":
                s = self.ssm
                di = s.expand * d
                nh = di // s.head_dim
                conv_dim = di + 2 * s.n_groups * s.d_state
                total += d * (2 * di + 2 * s.n_groups * s.d_state + nh)
                total += conv_dim * s.conv_width + di * d
            if ffn == "dense":
                total += 3 * d * f
            elif ffn == "moe":
                total += d * self.moe.num_experts
                total += self.moe.num_experts * 3 * d * f
        # encoder tower (whisper)
        if self.encoder_layers:
            total += self.encoder_layers * (
                d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
                + 3 * d * f)
        return int(total)

    def active_params(self) -> int:
        """Active parameters per token (MoE: only routed experts count)."""
        if self.moe is None:
            return self.approx_params()
        d, f = self.d_model, self.d_ff
        e, k = self.moe.num_experts, self.moe.top_k
        dead_experts_per_moe_layer = (e - k) * 3 * d * f
        n_moe_layers = sum(1 for (_, ffn) in self.layout if ffn == "moe")
        n_moe_layers *= self.num_periods
        return self.approx_params() - n_moe_layers * dead_experts_per_moe_layer
