"""The LM: prefill and decode for serving, and the training loss.

The port of the reference package's ``models/model.py`` for layouts of
``("attn" | "attn_cross" | "mamba", "dense" | "moe" | "none")``
sub-layers (qwen1.5, codeqwen1.5, chatglm3; minicpm3's MLA; llama4 scout
and maverick; mamba2 and the jamba hybrid; the Whisper encoder-decoder;
the PaliGemma VLM).
The parameters keep the reference's tree, with its stacks as Python
lists: ``params["blocks"][period]["sub0"]`` holds one layer, and
``params["encoder"][layer]`` one encoder layer; the reference's ``scan``
over each stack is a loop over the list.  The decode cache keeps the
reference's stacked layout, one entry per sub-layer:
``cache["sub0"]["k"]`` of shape ``(periods, B, max_len, KV, dh)`` for
attention (a cross-attention sub-layer adds the encoder's ``"xk"``/
``"xv"``, ``(periods, B, encoder_seq, KV, dh)``, written once by the
prefill), ``"ckv"`` ``(periods, B, max_len, kv_lora_rank)`` and
``"krope"`` ``(periods, B, max_len, rope_head_dim)`` for MLA, ``"h"``
``(periods, B, nh, hd, N)`` fp32 and the conv tails ``"conv_x"``/
``"conv_b"``/``"conv_c"`` ``(periods, B, W-1, C)`` for a mamba mixer.
Under ``kv_cache_quant`` a self-attention sub-layer (``"attn"``) caches
int8 codes ``"k"``/``"v"`` and fp32 scales ``"k_s"``/``"v_s"``
``(periods, B, max_len, KV)``, quantised from the prefill's post-RoPE K and
V and, in decode, from each new token's; MLA's latents, a mamba state and
an ``"attn_cross"`` sub-layer's caches stay as they are, as in the
reference.  The prefill writes each period's entries into one cache of
``max_len`` made by :meth:`LM.init_cache`, so the whole cache is made
once.  Decode writes each token's K/V (or MLA latents), and each mamba
layer's new state, into it in place.  A MoE sub-layer serves through
``moe_apply(exact=True)``, the dropless dispatch, in prefill and decode;
serving drops its aux losses.

``loss`` is the reference's: the stack in train mode (no cache; a MoE
sub-layer takes the capacity dispatch, ``exact=False``, and its
``load_balance`` and ``router_z`` losses are summed), each period under
``torch.utils.checkpoint`` when ``cfg.remat`` (the reference's
``jax.checkpoint`` around its scan body), then the cross-entropy over the
vocabulary in sequence chunks of ``loss_chunk``, each chunk checkpointed
too.  On the card its attention runs the flash kernel and its gradient the
backward kernel; on the CPU autograd differentiates the chunked attention.

The encoder runs over the batch's ``frames`` (B, encoder_seq, D), the
stub frame embeddings, in prefill only: non-causal self-attention with
RoPE at positions 0..Se-1 (the config's stated adaptation).

A VLM's batch carries ``patches`` (B, vision_tokens, vision_embed_dim),
the stub image embeddings: the prefill projects them through
``params["vis_proj"]`` (unscaled; the tokens' embeddings are scaled by
√d) and prepends them to the tokens, and every self-attention of the
prefill runs under the prefix-LM mask with ``prefix_len`` =
``vision_tokens``.  Decode needs no mask: one new text token sees every
cached position.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models import ssm
from repro_torch.models.layers import (
    _dtype, dense_init, embed_init, ffn_apply, ffn_init, rms_norm)


# The cache entries with a sequence axis (axis 1 of a period's entry):
# K/V, their int8 scales and MLA's latents.  The others (a mamba state,
# the encoder's ``xk``/``xv``) keep their own length.
_SEQ_ENTRIES = ("k", "v", "k_s", "v_s", "ckv", "krope")


def _check_ported(cfg: ModelConfig) -> None:
    for mixer, ffn in cfg.layout:
        if mixer not in ("attn", "attn_cross", "mamba") or \
                ffn not in ("dense", "moe", "none"):
            raise attn._not_ported(f"{cfg.arch_id}: sub-layer "
                                   f"({mixer!r}, {ffn!r})", "later slices")


class LM:
    def __init__(self, cfg: ModelConfig):
        _check_ported(cfg)
        self.cfg = cfg
        self.pdtype = _dtype(cfg.param_dtype)
        self.adtype = _dtype(cfg.activation_dtype)

    # ------------------------------------------------------------------
    # Init
    # ------------------------------------------------------------------
    def _init_sublayer(self, generator, mixer, ffn):
        cfg, dt = self.cfg, self.pdtype
        dev = generator.device
        if mixer == "mamba":
            init = ssm.ssm_init
        elif mixer == "attn_cross":
            init = functools.partial(attn.attn_init, cross=True)
        else:
            init = attn.mla_init if cfg.mla else attn.attn_init
        p = {"norm_in": torch.ones(cfg.d_model, dtype=dt, device=dev),
             "mixer": init(generator, cfg, dt)}
        if mixer == "attn_cross":
            p["norm_cross"] = torch.ones(cfg.d_model, dtype=dt, device=dev)
        if ffn != "none":
            p["norm_ffn"] = torch.ones(cfg.d_model, dtype=dt, device=dev)
            p["ffn"] = (moe.moe_init(generator, cfg, dt) if ffn == "moe" else
                        ffn_init(generator, cfg.d_model, cfg.d_ff, dt))
        return p

    def init(self, generator: torch.Generator) -> dict:
        """Random weights, made on ``generator``'s device."""
        cfg, dt = self.cfg, self.pdtype
        params = {
            "embed": embed_init(generator, cfg.vocab_padded, cfg.d_model, dt),
            "final_norm": torch.ones(cfg.d_model, dtype=dt,
                                     device=generator.device),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(generator, cfg.d_model,
                                           cfg.vocab_padded, dt)
        params["blocks"] = [
            {f"sub{i}": self._init_sublayer(generator, mixer, ffn)
             for i, (mixer, ffn) in enumerate(cfg.layout)}
            for _ in range(cfg.num_periods)]
        if cfg.encoder_layers:
            dev = generator.device
            params["encoder"] = [{
                "norm_in": torch.ones(cfg.d_model, dtype=dt, device=dev),
                "mixer": attn.attn_init(generator, cfg, dt),
                "norm_ffn": torch.ones(cfg.d_model, dtype=dt, device=dev),
                "ffn": ffn_init(generator, cfg.d_model, cfg.d_ff, dt),
            } for _ in range(cfg.encoder_layers)]
            params["enc_final_norm"] = torch.ones(cfg.d_model, dtype=dt,
                                                  device=dev)
        if cfg.vision_tokens:
            params["vis_proj"] = dense_init(generator, cfg.vision_embed_dim,
                                            cfg.d_model, dt)
        return params

    # ------------------------------------------------------------------
    # Shared block machinery
    # ------------------------------------------------------------------
    def _period_fwd(self, pp, x, *, enc_out=None, prefix_len=0, cache=None,
                    pos=None, train=False):
        """One period.  Prefill (``cache is None``) returns the period's new
        cache entries; decode writes into ``cache`` (this period's slices)
        in place.  ``enc_out``: the encoder's output, which a
        cross-attention sub-layer reads in prefill and training (decode
        reads its cached ``xk``/``xv``).  ``prefix_len``: the prefix-LM
        positions (the vision tokens), handed to every self-attention.
        ``train``: the reference's ``mode="train"``, a full sequence that
        builds no cache and runs a MoE sub-layer through the capacity
        dispatch; the second value returned is then the period's summed
        aux losses, ``{"load_balance", "router_z"}`` (fp32 scalars)."""
        cfg = self.cfg
        new_cache = {}
        aux = []                # the MoE sub-layers' aux losses
        for i, (mixer, ffn) in enumerate(cfg.layout):
            sp = pp[f"sub{i}"]
            key = f"sub{i}"
            h = rms_norm(x, sp["norm_in"], cfg.norm_eps)
            if mixer == "mamba" and train:
                out = ssm.ssm_forward(sp["mixer"], h, cfg)
            elif mixer == "mamba" and cache is None:
                out, (hf, tails) = ssm.ssm_forward(sp["mixer"], h, cfg,
                                                   return_state=True)
                new_cache[key] = {"h": hf, "conv_x": tails[0],
                                  "conv_b": tails[1], "conv_c": tails[2]}
            elif mixer == "mamba":
                out, _ = ssm.ssm_decode(sp["mixer"], h, cfg, cache[key])
            elif cfg.mla and train:
                out = attn.mla_forward(sp["mixer"], h, cfg)
            elif cfg.mla and cache is None:
                out, (ckv, krope) = attn.mla_forward(sp["mixer"], h, cfg,
                                                     return_kv=True)
                new_cache[key] = {"ckv": ckv, "krope": krope}
            elif cfg.mla:
                out, _, _ = attn.mla_decode(
                    sp["mixer"], h, cfg, cache[key]["ckv"],
                    cache[key]["krope"], pos)
            elif train:
                out = attn.attn_forward(sp["mixer"], h, cfg,
                                        causal=cfg.causal,
                                        prefix_len=prefix_len)
            elif cache is None:
                out, (k, v) = attn.attn_forward(
                    sp["mixer"], h, cfg, causal=cfg.causal,
                    prefix_len=prefix_len, return_kv=True)
                if cfg.kv_cache_quant and mixer == "attn":
                    kq, ks = attn.quantize_kv(k)
                    vq, vs = attn.quantize_kv(v)
                    new_cache[key] = {"k": kq, "k_s": ks, "v": vq,
                                      "v_s": vs}
                else:
                    new_cache[key] = {"k": k, "v": v}
            elif "k_s" in cache[key]:
                out, _ = attn.attn_decode_quant(sp["mixer"], h, cfg,
                                                cache[key], pos)
            else:
                out, _, _ = attn.attn_decode(
                    sp["mixer"], h, cfg, cache[key]["k"], cache[key]["v"],
                    pos)
            x = x + out
            if mixer == "attn_cross":
                h = rms_norm(x, sp["norm_cross"], cfg.norm_eps)
                if cache is None:
                    ent = _cross_kv(sp["mixer"], enc_out, cfg)
                    out = attn.cross_attn_forward(sp["mixer"], h, ent, cfg)
                    if not train:
                        new_cache[key].update(ent)
                else:
                    out = _cross_decode(sp["mixer"], h, cache[key], cfg)
                x = x + out
            if ffn == "none":
                continue
            h = rms_norm(x, sp["norm_ffn"], cfg.norm_eps)
            if ffn == "moe":
                out, a = moe.moe_apply(sp["ffn"], h, cfg, exact=not train)
                aux.append(a)
            else:
                out = ffn_apply(sp["ffn"], h, cfg.ffn_activation)
            x = x + out
        if not train:
            return x, new_cache
        zero = x.new_zeros((), dtype=torch.float32)
        return x, {name: sum((a[name] for a in aux), zero)
                   for name in ("load_balance", "router_z")}

    def _remat(self, fn, *args):
        """``fn(*args)``, recomputed in the backward pass instead of saved
        (``torch.utils.checkpoint``, non-reentrant) when ``cfg.remat``: the
        reference's ``jax.checkpoint``."""
        if self.cfg.remat:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def _encoder_layer(self, lp, x):
        cfg = self.cfg
        h = rms_norm(x, lp["norm_in"], cfg.norm_eps)
        x = x + attn.attn_forward(lp["mixer"], h, cfg, causal=False)
        h = rms_norm(x, lp["norm_ffn"], cfg.norm_eps)
        return x + ffn_apply(lp["ffn"], h, cfg.ffn_activation)

    def _encode(self, params, frames, train=False):
        """Whisper's encoder over the stub frame embeddings (B, Se, D),
        which arrive in fp32 and are cast to the activation dtype first.
        ``train``: each layer under :meth:`_remat`, as the reference's
        encoder scan body."""
        x = frames.to(self.adtype)
        for lp in params["encoder"]:
            x = (self._remat(self._encoder_layer, lp, x) if train
                 else self._encoder_layer(lp, x))
        return rms_norm(x, params["enc_final_norm"], self.cfg.norm_eps)

    def _embed_tokens(self, params, tokens):
        x = params["embed"][tokens].to(self.adtype)
        return x * (self.cfg.d_model ** 0.5)

    def _embed_inputs(self, params, batch, train=False):
        """Token embedding, after a VLM's projected ``patches`` (its
        vision prefix), and, for an encoder-decoder, the encoder's output
        (else None; ``train`` goes to :meth:`_encode`).  Returns (x,
        prefix_len, enc_out)."""
        cfg = self.cfg
        x = self._embed_tokens(params, batch["inputs"])
        prefix_len = 0
        enc_out = None
        if cfg.vision_tokens:
            vis = batch["patches"].to(self.adtype) @ params["vis_proj"]
            x = torch.cat([vis, x], dim=1)
            prefix_len = cfg.vision_tokens
        if cfg.encoder_layers:
            enc_out = self._encode(params, batch["frames"], train=train)
        return x, prefix_len, enc_out

    def _lm_logits_chunk(self, params, h):
        """fp32 logits: the reference contracts bf16 operands with
        ``preferred_element_type=f32``; the pad vocab is masked."""
        cfg = self.cfg
        w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        logits = h.float() @ w.float()
        if cfg.logit_softcap:
            c = cfg.logit_softcap
            logits = torch.tanh(logits / c) * c
        if cfg.vocab_padded != cfg.vocab_size:
            logits[..., cfg.vocab_size:] = -1e30
        return logits

    def _xent_chunk(self, params, h, labels):
        """One sequence chunk's summed cross-entropy over its valid labels
        (``labels >= 0``) and their count: fp32 logits, ``logsumexp``
        minus the gold logit."""
        logits = self._lm_logits_chunk(params, h)            # (B, C, V)
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels.clamp_min(0)[..., None].long())
        valid = (labels >= 0).float()
        return ((lse - gold[..., 0]) * valid).sum(), valid.sum()

    def loss(self, params, batch):
        """``(loss, metrics)`` of the reference's ``LM.loss``: the mean
        next-token cross-entropy over the labels (a VLM's vision prefix
        dropped from the hidden states first; labels padded with -1 to a
        multiple of ``loss_chunk``), plus the MoE aux losses.  ``metrics``:
        ``xent``, ``load_balance``, ``router_z`` and ``tokens`` (the valid
        labels), all fp32 scalars."""
        cfg = self.cfg
        x, prefix_len, enc_out = self._embed_inputs(params, batch,
                                                    train=True)
        period = functools.partial(self._period_fwd, enc_out=enc_out,
                                   prefix_len=prefix_len, train=True)
        aux = None
        for pp in params["blocks"]:
            x, a = self._remat(period, pp, x)
            aux = a if aux is None else {n: aux[n] + a[n] for n in aux}
        h = rms_norm(x, params["final_norm"], cfg.norm_eps)
        if cfg.vision_tokens:
            h = h[:, cfg.vision_tokens:]
        labels = batch["labels"]
        s = labels.shape[1]
        chunk = min(cfg.loss_chunk, s)
        pad = (-s) % chunk
        if pad:
            h = F.pad(h, (0, 0, 0, pad))
            labels = F.pad(labels, (0, pad), value=-1)
        total = count = 0.0
        for c0 in range(0, s + pad, chunk):
            t, n = self._remat(self._xent_chunk, params,
                               h[:, c0:c0 + chunk], labels[:, c0:c0 + chunk])
            total, count = total + t, count + n
        count = count.clamp_min(1.0)
        xent = total / count
        loss = xent + aux["load_balance"] + aux["router_z"]
        return loss, {"xent": xent, **aux, "tokens": count}

    # ------------------------------------------------------------------
    # Serving: prefill + decode
    # ------------------------------------------------------------------
    def prefill(self, params, batch, max_len):
        """Run the prompt; returns (last-position logits, cache).

        The cache is :meth:`init_cache`'s zero cache of ``max_len``, made
        once; each period's entries are copied into it as soon as the
        period has run (at ``[p, :, :S]`` for the entries with a sequence
        axis, ``[p]`` for the others) and then dropped.  So the prefill
        holds the weights, one cache and one period's transients, and its
        cache is the reference's: the prompt's entries, zeros after them.
        """
        cfg = self.cfg
        x, prefix_len, enc_out = self._embed_inputs(params, batch)
        if x.shape[1] > max_len:
            raise ValueError(f"a prompt of {x.shape[1]} positions does not "
                             f"fit a cache of max_len {max_len}")
        cache = self.init_cache(x.shape[0], max_len, device=x.device)
        for p, pp in enumerate(params["blocks"]):
            x, ent = self._period_fwd(pp, x, enc_out=enc_out,
                                      prefix_len=prefix_len)
            _write_period(cache, p, ent)
            del ent         # before the next period runs
        h = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
        logits = self._lm_logits_chunk(params, h)
        return logits[:, 0], cache

    def init_cache(self, batch_size, max_len, dtype=None, device=None):
        """Zero decode cache (one entry per sub-layer, stacked over
        periods): K/V for attention (and the encoder's ``xk``/``xv`` for
        cross-attention), the latents ``ckv``/``krope`` for MLA,
        ``init_ssm_cache``'s state for a mamba mixer (``h`` fp32, the conv
        tails in ``dtype``).  Under ``kv_cache_quant`` a self-attention
        sub-layer's K/V are int8 codes with fp32 scales ``k_s``/``v_s``
        ``(periods, B, max_len, KV)``."""
        cfg = self.cfg
        p = cfg.num_periods
        shape = (p, batch_size, max_len, cfg.num_kv_heads, cfg.head_dim)
        dt = dtype or self.adtype
        cache = {}
        xshape = (p, batch_size, cfg.encoder_seq, cfg.num_kv_heads,
                  cfg.head_dim)
        for i, (mixer, _) in enumerate(cfg.layout):
            if mixer == "mamba":
                ent = {name: torch.zeros((p,) + sh, dtype=d, device=device)
                       for name, (sh, d) in ssm.ssm_cache_layout(
                           cfg, batch_size, dt).items()}
            elif cfg.mla:
                ent = {name: torch.zeros((p, batch_size, max_len, width),
                                         dtype=dt, device=device)
                       for name, width in (
                           ("ckv", cfg.mla.kv_lora_rank),
                           ("krope", cfg.mla.rope_head_dim))}
            elif cfg.kv_cache_quant and mixer == "attn":
                ent = {name: torch.zeros(shape[:4] if name.endswith("_s")
                                         else shape, dtype=d, device=device)
                       for name, d in (("k", torch.int8), ("v", torch.int8),
                                       ("k_s", torch.float32),
                                       ("v_s", torch.float32))}
            else:
                ent = {"k": torch.zeros(shape, dtype=dt, device=device),
                       "v": torch.zeros(shape, dtype=dt, device=device)}
            if mixer == "attn_cross":
                ent["xk"] = torch.zeros(xshape, dtype=dt, device=device)
                ent["xv"] = torch.zeros(xshape, dtype=dt, device=device)
            cache[f"sub{i}"] = ent
        return cache

    def decode_step(self, params, cache, tokens, pos):
        """tokens: (B, 1) int; pos: int (current write index).  Writes the
        token's K/V (or MLA latents), and each mamba layer's new state,
        into ``cache`` in place and returns (logits, cache).  The encoder
        does not run: cross-attention reads the cached ``xk``/``xv``."""
        cfg = self.cfg
        x = self._embed_tokens(params, tokens)
        for p, pp in enumerate(params["blocks"]):
            layer_cache = {key: {name: t[p] for name, t in sub.items()}
                           for key, sub in cache.items()}
            x, _ = self._period_fwd(pp, x, cache=layer_cache, pos=pos)
        h = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = self._lm_logits_chunk(params, h)
        return logits[:, 0], cache


def _write_period(cache, p, ent) -> None:
    """Copy period ``p``'s prefill entries into the stacked cache: at
    ``[p, :, :S]`` for the entries with a sequence axis, ``[p]`` for the
    others."""
    for key, sub in ent.items():
        for name, t in sub.items():
            dst = cache[key][name][p]
            if name in _SEQ_ENTRIES:
                dst = dst[:, :t.shape[1]]
            # A batch's frames off encoder_seq, or weights off the
            # config's dtype, would otherwise broadcast or cast silently.
            if dst.shape != t.shape or dst.dtype != t.dtype:
                raise ValueError(
                    f"{key}/{name}: the prefill made {t.dtype} "
                    f"{tuple(t.shape)} for a cache slot of {dst.dtype} "
                    f"{tuple(dst.shape)}")
            dst.copy_(t)


# ---------------------------------------------------------------------------
# Cross-attention helpers (whisper)
# ---------------------------------------------------------------------------
def _cross_kv(p, enc_out, cfg):
    """The cache entries of a cross-attention sub-layer: the encoder
    output's K and V, (B, Se, KV, dh) each, no RoPE."""
    b, se, _ = enc_out.shape
    shape = (b, se, cfg.num_kv_heads, cfg.head_dim)
    return {"xk": (enc_out @ p["xwk"]).reshape(shape),
            "xv": (enc_out @ p["xwv"]).reshape(shape)}


def _cross_decode(p, x, cache_ent, cfg):
    """One token's cross-attention over the cached ``xk``/``xv`` (every
    frame live).  fp32 scores from the cache's operands and softmax in
    fp32; P is cast to ``xv``'s dtype before P·V, as the reference
    rounds."""
    b = x.shape[0]
    q = (x @ p["xwq"]).reshape(b, 1, cfg.num_heads, cfg.head_dim)
    qg = attn._grouped(q, cfg.num_kv_heads)
    scores = attn._scores(qg, cache_ent["xk"], cfg.head_dim ** -0.5)
    pr = torch.softmax(scores, dim=-1)
    xv = cache_ent["xv"]
    o = torch.einsum("bkgcs,bskd->bckgd", pr.to(xv.dtype), xv)
    return o.reshape(b, 1, cfg.q_dim) @ p["xwo"]


def build(cfg: ModelConfig) -> LM:
    return LM(cfg)
