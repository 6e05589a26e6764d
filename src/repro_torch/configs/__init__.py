"""Architecture registry + reduced (smoke-test) configs + input shapes.

The port's own copy of the reference package's ``configs`` (imports
rewritten): dataclasses only, so importing it loads no torch.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig, MLAConfig
from repro_torch.configs import (
    llama4_scout_17b_a16e, llama4_maverick_400b_a17b, chatglm3_6b,
    minicpm3_4b, qwen15_0_5b, codeqwen15_7b, mamba2_1_3b,
    jamba_1_5_large_398b, whisper_base, paligemma_3b)

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.arch_id: m.CONFIG for m in (
        llama4_scout_17b_a16e, llama4_maverick_400b_a17b, chatglm3_6b,
        minicpm3_4b, qwen15_0_5b, codeqwen15_7b, mamba2_1_3b,
        jamba_1_5_large_398b, whisper_base, paligemma_3b)
}

# Assigned input shapes: name -> (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def reduced_config(arch_id: str) -> ModelConfig:
    """Tiny same-family sibling for CPU smoke tests."""
    cfg = get_config(arch_id)
    period = len(cfg.layout)
    # One full layout period covers every mixer type; 2 floors the depth so
    # inter-layer plumbing is still exercised.  (2×period made the jamba
    # smoke tests — period 8 — dominate tier-1 runtime at 16 layers.)
    kw = dict(
        num_layers=max(2, period),
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)) if cfg.num_kv_heads
        else 0,
        head_dim=16 if cfg.head_dim else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=512,
        attn_chunk=32,
        loss_chunk=32,
        param_dtype="float32",
        activation_dtype="float32",
        remat=False,
    )
    if cfg.mla:
        # v_head_dim ≠ rope+nope on purpose: catches q/v head-dim mixups
        kw["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                              rope_head_dim=8, nope_head_dim=8,
                              v_head_dim=24)
        kw["head_dim"] = 16
    if cfg.moe:
        kw["moe"] = MoEConfig(num_experts=4, top_k=cfg.moe.top_k)
    if cfg.ssm:
        kw["ssm"] = SSMConfig(d_state=16, expand=2, head_dim=16, n_groups=1,
                              chunk_size=16)
    if cfg.encoder_layers:
        kw["encoder_layers"] = 2
        kw["encoder_seq"] = 24
    if cfg.vision_tokens:
        kw["vision_tokens"] = 8
        kw["vision_embed_dim"] = 48
    return dataclasses.replace(cfg, **kw)


def valid_cells():
    """All (arch_id, shape_name) dry-run cells, honoring the documented skips.

    long_500k needs sub-quadratic attention → SSM/hybrid only (DESIGN.md §5).
    """
    cells = []
    for arch_id, cfg in ARCHS.items():
        for shape in SHAPES:
            if shape == "long_500k" and not cfg.supports_long_context:
                continue
            cells.append((arch_id, shape))
    return cells
