"""Shared neural-net building blocks (functions over dicts of tensors).

The port of the reference package's ``models/layers.py``.  A "module" is
an ``*_init`` function returning a dict of tensors plus an ``apply``-style
function; weights keep the reference's ``(d_in, d_out)`` layout and are
used as ``x @ w``.  Random weights come from an explicit
``torch.Generator`` and are made on its device.

The reference's mesh helpers (``shard``, ``mesh_context``,
``serve_linear_col/row`` and the weight-stationary decode FFN) belong to
the multi-GPU slice and are not ported: on one device they are the
identity and the plain FFN.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def _truncated_normal(generator: torch.Generator, shape) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], fp32, by inverse CDF (the
    reference's ``jax.random.truncated_normal(key, -2, 2, ...)``)."""
    lo, hi = math.erf(-2 / math.sqrt(2)), math.erf(2 / math.sqrt(2))
    u = torch.empty(shape, dtype=torch.float32, device=generator.device)
    u.uniform_(lo, hi, generator=generator)
    # In place: one fp32 buffer at a time (2.7 GB for one of llama4-scout's
    # expert tensors).
    return u.erfinv_().mul_(math.sqrt(2)).clamp_(-2.0, 2.0)


def dense_init(generator, d_in, d_out, dtype):
    return _truncated_normal(generator, (d_in, d_out)).mul_(
        d_in ** -0.5).to(dtype)


def embed_init(generator, vocab, d, dtype):
    # stddev 1/sqrt(d): the input path rescales by sqrt(d), and the tied
    # output head then produces O(1) logits.
    return _truncated_normal(generator, (vocab, d)).mul_(d ** -0.5).to(dtype)


def rms_norm(x, scale, eps=1e-5):
    """RMSNorm: fp32 for the variance reduction only; the elementwise
    rescale stays in the activation dtype (the reference's rounding
    points)."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * scale.to(x.dtype)


def _gelu_tanh(x):
    # jax.nn.gelu defaults to the tanh approximation.
    return F.gelu(x, approximate="tanh")


def activation(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh}[name]


# ---------------------------------------------------------------------------
# RoPE (supports fractional application — chatglm3's "2d RoPE" = 0.5)
# ---------------------------------------------------------------------------
def rope_freqs(head_dim, rope_fraction, theta, device=None):
    rot_dim = int(head_dim * rope_fraction)
    rot_dim -= rot_dim % 2
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                        device=device) / rot_dim
    inv = 1.0 / (theta ** exps)
    return inv, rot_dim


def apply_rope(x, positions, rope_fraction=1.0, theta=10_000.0):
    """x: (..., S, H, dh); positions broadcastable to (..., S).

    The rotation runs in fp32 (bf16 · fp32 promotes) and is cast back to
    x's dtype, as in the reference.
    """
    dh = x.shape[-1]
    inv, rot_dim = rope_freqs(dh, rope_fraction, theta, x.device)
    if rot_dim == 0:
        return x
    ang = positions[..., None].float() * inv              # (..., S, rot/2)
    cos = torch.cos(ang)[..., None, :]                    # (..., S, 1, rot/2)
    sin = torch.sin(ang)[..., None, :]
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    x1, x2 = x_rot[..., ::2], x_rot[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    y = torch.stack([y1, y2], dim=-1).reshape(x_rot.shape)
    return torch.cat([y.to(x.dtype), x_pass], dim=-1)


# ---------------------------------------------------------------------------
# FFN (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------
def ffn_init(generator, d_model, d_ff, dtype):
    return {
        "w_gate": dense_init(generator, d_model, d_ff, dtype),
        "w_up": dense_init(generator, d_model, d_ff, dtype),
        "w_down": dense_init(generator, d_ff, d_model, dtype),
    }


def ffn_apply(params, x, act_name="silu"):
    """The gated FFN.  The reference's ``serve_sharded`` decode variant
    differs only under a mesh (multi-GPU slice)."""
    act = activation(act_name)
    g = x @ params["w_gate"]
    u = x @ params["w_up"]
    return (act(g) * u) @ params["w_down"]
