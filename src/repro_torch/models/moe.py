"""Mixture-of-Experts FFN: top-k routing and two dispatch engines.

The port of the reference package's ``models/moe.py`` for one device.

* **serve** (``exact=True``): dropless grouped dispatch.  Tokens are
  sorted by expert (a stable sort, as ``jnp.argsort``), and each expert
  that received rows runs them as one ``torch.matmul`` triple; experts
  with no rows launch nothing.  The reference's ``lax.ragged_dot`` is an
  XLA product, not a Pallas kernel, so it has no kernel here.  The group
  sizes come to the host once per call: one host sync per MoE layer and
  step.
* **train** (``exact=False``): capacity-factor scatter dispatch
  (Switch/GShard semantics: tokens over an expert's capacity are
  dropped).

Losses: the switch-style load-balance loss and the router z-loss,
returned as aux.  The router stays fp32 whatever the parameter dtype.

The reference's expert-parallel dispatchers (``shard_map`` under a mesh,
for prefill and for weight-stationary decode) belong to the multi-GPU
slice: ``moe_apply(mesh=...)`` raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _truncated_normal, activation, dense_init


def moe_init(generator, cfg, dtype):
    """Router ``(D, E)`` in fp32; experts ``w_gate``/``w_up`` ``(E, D, F)``
    and ``w_down`` ``(E, F, D)`` in ``dtype``, truncated normals drawn in
    fp32 on ``generator``'s device."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts

    def tn(shape, s):
        return _truncated_normal(generator, shape).mul_(s).to(dtype)

    return {
        "router": dense_init(generator, d, e, torch.float32),
        "w_gate": tn((e, d, f), d ** -0.5),
        "w_up": tn((e, d, f), d ** -0.5),
        "w_down": tn((e, f, d), f ** -0.5),
    }


def _top_k(probs, k):
    """``jax.lax.top_k`` along the last axis: the largest first, ties to
    the lower index (``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _route(params, xt, cfg):
    """fp32 router logits → softmax → top-k, weights renormalised over the
    k; returns ``(topi, topw, aux)``."""
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    logits = xt.float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    topw, topi = _top_k(probs, k)
    topw = topw / topw.sum(-1, keepdim=True).clamp_min(1e-9)
    me = F.one_hot(topi[:, 0], e).float().mean(dim=0)
    ce = probs.mean(dim=0)
    aux = {
        "load_balance": e * (me * ce).sum() * cfg.moe.load_balance_loss,
        "router_z": torch.logsumexp(logits, dim=-1).square().mean()
                    * cfg.moe.router_z_loss,
    }
    return topi, topw, aux


def _expert_ffn_ragged(params, xs, gs, act_name):
    """xs: (M, D) sorted by group; gs: the group sizes as ints, one per
    expert.  Rows past ``sum(gs)`` give zeros, as in ``lax.ragged_dot``."""
    act = activation(act_name)
    out = xs.new_zeros((xs.shape[0], params["w_down"].shape[-1]))
    start = 0
    for ex, n in enumerate(gs):
        if n:
            rows = xs[start:start + n]
            g = rows @ params["w_gate"][ex]
            u = rows @ params["w_up"][ex]
            out[start:start + n] = (act(g) * u) @ params["w_down"][ex]
        start += n
    return out


# ---------------------------------------------------------------------------
# Capacity dispatch (training)
# ---------------------------------------------------------------------------
def _capacity(tokens: int, cfg) -> int:
    e, k, cf = (cfg.moe.num_experts, cfg.moe.top_k,
                cfg.moe.capacity_factor)
    c = int(tokens * k * cf / e) + 1
    return max(8, -(-c // 8) * 8)


def _dispatch_capacity(params, xt, topi, topw, cfg):
    t, d = xt.shape
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    sel = topi.reshape(-1)
    wgt = topw.reshape(-1)
    cap = _capacity(t, cfg)
    oh = F.one_hot(sel, e)
    pos = (oh.cumsum(dim=0) * oh).sum(-1) - 1
    keep = pos < cap
    # Dropped slots all land on the one spare row e·cap, read back as 0.
    dest = torch.where(keep, sel * cap + pos, e * cap)
    token_of = torch.arange(t * k, device=xt.device) // k

    buf = xt.new_zeros((e * cap + 1, d))
    buf[dest] = xt[token_of]
    xe = buf[: e * cap].reshape(e, cap, d)

    act = activation(cfg.ffn_activation)
    g = torch.bmm(xe, params["w_gate"])
    u = torch.bmm(xe, params["w_up"])
    o = torch.bmm(act(g) * u, params["w_down"])

    o_flat = torch.cat([o.reshape(e * cap, d), o.new_zeros((1, d))])
    per_slot = o_flat[dest] * (wgt * keep).to(o.dtype)[:, None]
    return per_slot.reshape(t, k, d).sum(dim=1)


# ---------------------------------------------------------------------------
# Dropless grouped dispatch (serving)
# ---------------------------------------------------------------------------
def _group_sizes(sel, e) -> list[int]:
    """Rows per expert on the host: the dispatch's one sync.  A scatter
    count, since ``torch.bincount`` on a CUDA tensor reads its min and max
    back first."""
    counts = torch.zeros(e, dtype=torch.int64, device=sel.device)
    return counts.index_add_(0, sel, torch.ones_like(sel)).tolist()


def _dispatch_ragged(params, xt, topi, topw, cfg):
    t, d = xt.shape
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    sel = topi.reshape(-1)
    wgt = topw.reshape(-1)
    order = torch.argsort(sel, stable=True)
    xs = xt[order // k]
    o = _expert_ffn_ragged(params, xs, _group_sizes(sel, e),
                           cfg.ffn_activation)
    contrib = o * wgt[order].to(o.dtype)[:, None]
    ys = torch.empty_like(contrib).index_copy_(0, order, contrib)
    return ys.reshape(t, k, d).sum(dim=1)


def moe_apply(params, x, cfg, exact=False, decode=False, *, mesh=None):
    """x: (B, S, D) → (y, aux).

    ``exact`` takes the dropless grouped dispatch (serving), else the
    capacity dispatch (training).  ``decode`` picks the reference's
    weight-stationary dispatcher under a mesh and changes nothing on one
    device; ``mesh`` raises until the multi-GPU slice.
    """
    if mesh is not None:
        raise NotImplementedError(
            "moe_apply(mesh=...) is not ported yet: the expert-parallel "
            "dispatchers come with the multi-GPU slice (ROADMAP Queue 1 #8)")
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    topi, topw, aux = _route(params, xt, cfg)
    if exact:
        y = _dispatch_ragged(params, xt, topi, topw, cfg)
    else:
        y = _dispatch_capacity(params, xt, topi, topw, cfg)
    return y.reshape(b, s, d), aux
