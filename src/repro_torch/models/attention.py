"""Attention mixers: GQA/MQA/MHA, MLA and cross-attention, for prefill
and decode.

The port of the reference package's ``models/attention.py``.  The
layouts are the reference's: q grouped as ``(B, S, KV, G, dh)``, K and V
as ``(B, S, KV, dh)``.

Prefill and training (:func:`attn_forward`, :func:`mla_forward`,
:func:`cross_attn_forward`) run the hand-written flash-attention kernel
off the CPU, through the autograd Function ``FlashAttention`` whose
gradient is the hand-written backward kernel, and
:func:`chunked_attention`, the twin of the reference's XLA path, on CPU
tensors, where autograd differentiates it as jax differentiates the
reference's.  Decode (:func:`attn_decode`,
:func:`mla_decode`, and the model's cross-attention decode) is torch ops
on both, as it is XLA outside any kernel in the reference.

Cross-attention (Whisper's decoder over the encoder output) is
non-causal with Sq (the prompt) ≠ Sk (the frames) and takes no RoPE.

MLA (multi-head latent attention, MiniCPM3) keeps the reference's layout:
each query head is ``[rope, nope]``, K is ``[k_rope on every head,
k_nope]``, one KV head per query head, and the decode cache holds only
the latent ``c_kv`` (before ``kv_norm``) and ``k_rope`` (after RoPE),
expanded through ``wkv_b`` at every step.

A VLM's prefix-LM mask (``prefix_len``: the image tokens, seen by every
row) runs in the flash kernel on the card, and in
:func:`chunked_attention` on the CPU.

Not ported yet, each raising ``NotImplementedError``: the int8 KV cache
and the sequence-sharded decode (multi-GPU slice).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.flash_attention import NEG_INF
from repro_torch.models.layers import apply_rope, dense_init, rms_norm


def _not_ported(what: str, where: str):
    return NotImplementedError(f"{what} is not ported yet: it comes with "
                               f"{where} (ROADMAP Queue 1)")


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------
def attn_init(generator, cfg, dtype, cross=False):
    """Self-attention weights; ``cross`` adds the cross-attention's
    ``xwq``/``xwk``/``xwv``/``xwo`` after them, as the reference does."""
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    dev = generator.device
    p = {
        "wq": dense_init(generator, d, qd, dtype),
        "wk": dense_init(generator, d, kvd, dtype),
        "wv": dense_init(generator, d, kvd, dtype),
        "wo": dense_init(generator, qd, d, dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(qd, dtype=dtype, device=dev)
        p["bk"] = torch.zeros(kvd, dtype=dtype, device=dev)
        p["bv"] = torch.zeros(kvd, dtype=dtype, device=dev)
    if cross:
        p["xwq"] = dense_init(generator, d, qd, dtype)
        p["xwk"] = dense_init(generator, d, kvd, dtype)
        p["xwv"] = dense_init(generator, d, kvd, dtype)
        p["xwo"] = dense_init(generator, qd, d, dtype)
    return p


def mla_init(generator, cfg, dtype):
    d, c = cfg.d_model, cfg.mla
    h = cfg.num_heads
    qh = c.rope_head_dim + c.nope_head_dim
    dev = generator.device
    return {
        "wq_a": dense_init(generator, d, c.q_lora_rank, dtype),
        "q_norm": torch.ones(c.q_lora_rank, dtype=dtype, device=dev),
        "wq_b": dense_init(generator, c.q_lora_rank, h * qh, dtype),
        "wkv_a": dense_init(generator, d, c.kv_lora_rank + c.rope_head_dim,
                            dtype),
        "kv_norm": torch.ones(c.kv_lora_rank, dtype=dtype, device=dev),
        "wkv_b": dense_init(generator, c.kv_lora_rank,
                            h * (c.nope_head_dim + c.v_head_dim), dtype),
        "wo": dense_init(generator, h * c.v_head_dim, d, dtype),
    }


# ---------------------------------------------------------------------------
# Core chunked attention (the reference's XLA path)
# ---------------------------------------------------------------------------
def _grouped(q, kv_heads):
    """(B, S, H, dh) -> (B, S, KV, G, dh)."""
    b, s, h, dh = q.shape
    return q.reshape(b, s, kv_heads, h // kv_heads, dh)


def _scores(qi, kj, scale):
    """fp32 scores, as the reference's ``preferred_element_type=f32``:
    bf16 products are exact in fp32."""
    return torch.einsum("bckgd,bskd->bkgcs", qi.float(), kj.float()) * scale


def chunked_attention(q, k, v, *, causal=True, prefix_len=0, chunk=512,
                      q_offset=0, kv_block=1024):
    """Attention with q in chunks and K/V streamed in blocks under an
    online softmax, as the reference computes it (its rounding points
    included).

    q: (B, Sq, KV, G, dh); k, v: (B, Sk, KV, dh) → (B, Sq, KV, G, dv).

    ``q_offset``: absolute position of q[0].  ``prefix_len``: positions
    < prefix_len are attendable by everyone (prefix-LM); ignored unless
    causal.
    """
    b, sq, kvh, g, dh = q.shape
    sk = k.shape[1]
    dv = v.shape[-1]
    dev = q.device
    chunk = min(chunk, sq)
    scale = dh ** -0.5
    kv_block = min(kv_block, sk)
    nkv = -(-sk // kv_block)

    def mask_for(qpos, kpos):
        ok = (kpos < sk)[None, :].expand(qpos.shape[0], -1)
        if causal:
            cm = kpos[None, :] <= qpos[:, None]
            if prefix_len:
                cm = cm | (kpos[None, :] < prefix_len)
            ok = ok & cm
        return ok

    out = torch.empty((b, sq, kvh, g, dv), dtype=v.dtype, device=dev)
    for c0 in range(0, sq, chunk):
        qi = q[:, c0:c0 + chunk]
        qpos = q_offset + c0 + torch.arange(chunk, device=dev)
        if nkv == 1:            # single block: plain softmax
            ok = mask_for(qpos, torch.arange(sk, device=dev))
            s = _scores(qi, k, scale)
            s = s.masked_fill(~ok[:qi.shape[1]], NEG_INF)
            p = torch.softmax(s, dim=-1)
            o = torch.einsum("bkgcs,bskd->bckgd", p.to(v.dtype), v)
            out[:, c0:c0 + chunk] = o
            continue
        n = qi.shape[1]
        m = torch.full((b, kvh, g, n), -torch.inf, device=dev)
        den = torch.zeros((b, kvh, g, n), device=dev)
        acc = torch.zeros((b, kvh, g, n, dv), device=dev)
        for j in range(nkv):
            kj = k[:, j * kv_block:(j + 1) * kv_block]
            vj = v[:, j * kv_block:(j + 1) * kv_block]
            kpos = j * kv_block + torch.arange(kv_block, device=dev)
            ok = mask_for(qpos, kpos)[:n, :kj.shape[1]]
            s = _scores(qi, kj, scale).masked_fill(~ok, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None]).masked_fill(~ok, 0.0)
            corr = torch.exp(m - m_new)
            den = den * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgcs,bskd->bkgcd", p.to(v.dtype), vj)
            acc = acc * corr[..., None] + pv.float()
            m = m_new
        o = acc / den.clamp_min(1e-30)[..., None]
        out[:, c0:c0 + chunk] = o.permute(0, 3, 1, 2, 4).to(v.dtype)
    return out


# ---------------------------------------------------------------------------
# GQA mixer: full-sequence (prefill) and single-token (decode)
# ---------------------------------------------------------------------------
def _project_qkv(p, x, cfg, positions=None):
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    b, s = x.shape[:2]
    q = q.reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    if positions is not None:
        q = apply_rope(q, positions, cfg.rope_fraction, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_fraction, cfg.rope_theta)
    return q, k, v


def attn_forward(p, x, cfg, *, causal=True, prefix_len=0, positions=None,
                 return_kv=False):
    """Full-sequence attention.  x: (B, S, D).  ``prefix_len``: under
    ``causal``, the positions every row sees (prefix-LM).

    Off the CPU the scores run in the flash-attention kernel (its
    gradient in the backward kernel); on the CPU they run in
    :func:`chunked_attention`.
    """
    b, s, _ = x.shape
    on_card = x.device.type != "cpu"
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg, positions=positions)
    qg = _grouped(q, cfg.num_kv_heads)
    if on_card:
        o = fa.FlashAttention.apply(qg, k, v, causal, prefix_len)
    else:
        o = chunked_attention(qg, k, v, causal=causal,
                              prefix_len=prefix_len, chunk=cfg.attn_chunk,
                              kv_block=cfg.attn_kv_block)
    out = o.reshape(b, s, cfg.q_dim) @ p["wo"]
    if return_kv:
        return out, (k, v)
    return out


def attn_decode(p, x, cfg, cache_k, cache_v, pos):
    """Single-token decode.  x: (B, 1, D); cache_*: (B, Smax, KV, dh);
    pos: int — the index at which the new token's K/V is written.

    Unlike the reference, which returns new caches, the token's K/V are
    written into ``cache_k``/``cache_v`` in place (no copy of the cache per
    step); they are returned as well.
    """
    b = x.shape[0]
    positions = torch.full((1, 1), pos, dtype=torch.int64, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions=positions)
    cache_k[:, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[:, pos] = v[:, 0].to(cache_v.dtype)
    qg = _grouped(q, cfg.num_kv_heads)                   # (B,1,KV,G,dh)
    scores = _scores(qg, cache_k, cfg.head_dim ** -0.5)
    live = torch.arange(cache_k.shape[1], device=x.device) <= pos
    scores = scores.masked_fill(~live, NEG_INF)
    pr = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkgcs,bskd->bckgd", pr.to(cache_v.dtype), cache_v)
    return o.reshape(b, 1, cfg.q_dim) @ p["wo"], cache_k, cache_v


def cross_attn_forward(p, x, kv, cfg):
    """Decoder → encoder attention (Whisper) over a whole prompt.  x:
    (B, S, D); kv: the model's cross cache entry for this sub-layer,
    ``{"xk", "xv"}`` of (B, Se, KV, dh) each, the encoder output through
    ``xwk``/``xwv`` (``models.model._cross_kv``).  Non-causal, no RoPE on
    q or K.  The reference projects the encoder output here and again for
    its cache; the port projects it once and hands it to both.

    Off the CPU the scores run in the flash-attention kernel; on the CPU
    they run in :func:`chunked_attention`.
    """
    b, s, _ = x.shape
    k, v = kv["xk"], kv["xv"]
    q = (x @ p["xwq"]).reshape(b, s, cfg.num_heads, cfg.head_dim)
    qg = _grouped(q, cfg.num_kv_heads)
    if x.device.type != "cpu":
        o = fa.FlashAttention.apply(qg, k, v, False, 0)
    else:
        o = chunked_attention(qg, k, v, causal=False, chunk=cfg.attn_chunk,
                              kv_block=cfg.attn_kv_block)
    return o.reshape(b, s, cfg.q_dim) @ p["xwo"]


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention): full-sequence and decode.  The decode
# cache stores only (c_kv, k_rope); K/V are re-expanded through wkv_b.
# ---------------------------------------------------------------------------
def _mla_qkv(p, x, cfg, positions):
    """q (B, S, H, rope + nope) with the rope half rotated and first;
    ``c_kv`` (B, S, kv_lora_rank), not normalised; ``k_rope``
    (B, S, 1, rope), rotated.  MLA's RoPE covers its whole slice whatever
    ``cfg.rope_fraction`` says."""
    c = cfg.mla
    b, s = x.shape[:2]
    cq = rms_norm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps)
    q = (cq @ p["wq_b"]).reshape(b, s, cfg.num_heads,
                                 c.rope_head_dim + c.nope_head_dim)
    q_rope = apply_rope(q[..., :c.rope_head_dim], positions, 1.0,
                        cfg.rope_theta)
    q = torch.cat([q_rope, q[..., c.rope_head_dim:]], -1)
    kv_a = x @ p["wkv_a"]
    c_kv = kv_a[..., :c.kv_lora_rank]
    k_rope = apply_rope(kv_a[..., None, c.kv_lora_rank:], positions, 1.0,
                        cfg.rope_theta)
    return q, c_kv, k_rope


def _mla_expand(p, c_kv, k_rope, cfg):
    """K (B, S, H, rope + nope) and V (B, S, H, v_head_dim) from the
    latent: ``kv_norm`` on ``c_kv``, then ``wkv_b``.  V is a strided view
    of the expansion."""
    c = cfg.mla
    h = cfg.num_heads
    b, s = c_kv.shape[:2]
    kv = (rms_norm(c_kv, p["kv_norm"], cfg.norm_eps) @ p["wkv_b"]).reshape(
        b, s, h, c.nope_head_dim + c.v_head_dim)
    k_nope, v = kv[..., :c.nope_head_dim], kv[..., c.nope_head_dim:]
    k = torch.cat([k_rope.expand(b, s, h, c.rope_head_dim), k_nope], -1)
    return k, v


def mla_forward(p, x, cfg, *, positions=None, return_kv=False):
    """Full-sequence MLA.  x: (B, S, D).  q is grouped with KV = H and
    G = 1 whatever ``cfg.num_kv_heads`` says; off the CPU the scores run
    in the flash-attention kernel (dh = rope + nope, dv = v_head_dim), on
    the CPU in :func:`chunked_attention`.  ``return_kv`` adds the cache
    entries ``(c_kv, k_rope)``, (B, S, kv_lora_rank) and (B, S, rope)."""
    b, s, _ = x.shape
    c = cfg.mla
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, c_kv, k_rope = _mla_qkv(p, x, cfg, positions)
    k, v = _mla_expand(p, c_kv, k_rope, cfg)
    qg = q[:, :, :, None, :]
    if x.device.type != "cpu":
        o = fa.FlashAttention.apply(qg, k, v.contiguous(), cfg.causal, 0)
    else:
        o = chunked_attention(qg, k, v, causal=cfg.causal,
                              chunk=cfg.attn_chunk,
                              kv_block=cfg.attn_kv_block)
    out = o.reshape(b, s, cfg.num_heads * c.v_head_dim) @ p["wo"]
    if return_kv:
        return out, (c_kv, k_rope[:, :, 0, :])
    return out


def mla_decode(p, x, cfg, cache_ckv, cache_krope, pos):
    """Single-token MLA decode.  x: (B, 1, D); cache_ckv (B, Smax,
    kv_lora_rank); cache_krope (B, Smax, rope); pos: int.

    The token's ``c_kv`` and ``k_rope`` are written into the caches in
    place (and the caches returned), then K and V are expanded over the
    whole cache and the positions after ``pos`` masked, with fp32 scores,
    as the reference computes it."""
    c = cfg.mla
    b = x.shape[0]
    positions = torch.full((1, 1), pos, dtype=torch.int64, device=x.device)
    q, c_kv, k_rope = _mla_qkv(p, x, cfg, positions)
    cache_ckv[:, pos] = c_kv[:, 0].to(cache_ckv.dtype)
    cache_krope[:, pos] = k_rope[:, 0, 0].to(cache_krope.dtype)
    k, v = _mla_expand(p, cache_ckv, cache_krope[:, :, None, :], cfg)
    scale = (c.rope_head_dim + c.nope_head_dim) ** -0.5
    scores = torch.einsum("bchd,bshd->bhcs", q.float(), k.float()) * scale
    live = torch.arange(k.shape[1], device=x.device) <= pos
    pr = torch.softmax(scores.masked_fill(~live, NEG_INF), dim=-1)
    o = torch.einsum("bhcs,bshd->bchd", pr.to(v.dtype), v)
    o = o.reshape(b, 1, cfg.num_heads * c.v_head_dim)
    return o @ p["wo"], cache_ckv, cache_krope
