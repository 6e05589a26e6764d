"""Mamba-2 SSD (state-space duality) mixer: chunked-scan prefill and
O(1)-state decode.  [arXiv:2405.21060]

The port of the reference package's ``models/ssm.py`` for one device.
The projections stay separate (``wz``/``wx``/``wb``/``wc``/``wdt``), as
the reference keeps them for tensor parallelism; its ``shard`` hints and
weight-stationary decode projections belong to the multi-GPU slice and
are plain products here.

All SSD arithmetic runs in float32 (long cumulative products) and is cast
back to the activation dtype at the block boundary; ``a_log``,
``dt_bias`` and ``d_skip`` stay fp32 whatever the parameter dtype.  The
reference computes the scan, the causal conv and the gated norm in plain
JAX, outside any Pallas kernel, so they are torch ops here too.
Softplus is ``F.softplus``, linear above 20 where the reference's is
exact (a relative difference under 3e-9).

Decode (:func:`ssm_decode`) writes the new state and conv tails into the
caller's cache tensors in place, as the attention decode writes its K/V;
the reference returns new dicts.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, rms_norm


def ssm_init(generator, cfg, dtype):
    s = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    nh = di // s.head_dim
    gn = s.n_groups * s.d_state
    dev = generator.device

    def conv(c):
        w = torch.randn((s.conv_width, c), generator=generator, device=dev)
        return (w * 0.1).to(dtype)

    return {
        "wz": dense_init(generator, d, di, dtype),
        "wx": dense_init(generator, d, di, dtype),
        "wb": dense_init(generator, d, gn, dtype),
        "wc": dense_init(generator, d, gn, dtype),
        "wdt": dense_init(generator, d, nh, dtype),
        "conv_x": conv(di),
        "conv_b": conv(gn),
        "conv_c": conv(gn),
        "a_log": torch.log(torch.linspace(1.0, 16.0, nh, device=dev)),
        "dt_bias": torch.zeros(nh, device=dev),
        "d_skip": torch.ones(nh, device=dev),
        "gate_norm": torch.ones(di, dtype=dtype, device=dev),
        "wo": dense_init(generator, di, d, dtype),
    }


def _causal_conv(x, w):
    """Depthwise causal conv in x's dtype.  x: (B, S, C); w: (W, C);
    ``out[t] = sum_i x[t - (W-1-i)] * w[i]``, summed tap by tap from
    i = 0 as the reference does."""
    width, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for i in range(width):
        out = out + xp[:, i:i + s] * w[i]
    return out


def _heads_of(cfg):
    s = cfg.ssm
    di = s.expand * cfg.d_model
    return di // s.head_dim


def _repeat_groups(t, rep, dim):
    """``jnp.repeat(t, rep, axis=dim)``: each group repeated in place
    (``g0 g0 g1 g1``, not ``g0 g1 g0 g1``), without a host sync."""
    if rep == 1:
        return t
    shape = t.shape
    t = t.unsqueeze(dim + 1).expand(*shape[:dim + 1], rep, *shape[dim + 1:])
    return t.reshape(*shape[:dim], shape[dim] * rep, *shape[dim + 1:])


def _ssd_chunk(h, inp, nh_groups):
    """One SSD chunk step.  h: (B, nh, hd, N) f32; returns (h_new, y)."""
    # (B,L,nh,hd), (B,L,nh) [=dt·A], (B,L,G,N), (B,L,G,N), (B,L,nh) [=dt]
    xc, a_dt, bc, cc, dt_j = inp
    bc = _repeat_groups(bc, nh_groups, 2)       # (B,L,nh,N)
    cc = _repeat_groups(cc, nh_groups, 2)
    cum = torch.cumsum(a_dt, dim=1)             # (B,L,nh) inclusive
    l = xc.shape[1]
    # decay[i, j] = exp(cum_i - cum_j) for j <= i.  Mask BEFORE exp: the
    # masked (i < j) entries have diff > 0 and would overflow to inf.
    diff = cum[:, :, None, :] - cum[:, None, :, :]     # (B, L_i, L_j, nh)
    pos = torch.arange(l, device=xc.device)
    mask = (pos[:, None] >= pos[None, :])[None, :, :, None]
    decay = torch.exp(torch.where(mask, diff, -1e30))
    scores = torch.einsum("blhn,bmhn->blmh", cc, bc) * decay * dt_j[:, None]
    y_intra = torch.einsum("blmh,bmhp->blhp", scores, xc)
    y_inter = torch.einsum("blhn,bhpn->blhp", cc, h) * torch.exp(cum)[..., None]
    # chunk-final state
    decay_to_end = torch.exp(cum[:, -1:, :] - cum)     # (B,L,nh)
    # Weigh x first: a three-operand einsum taken left to right would
    # build a (B, L, nh, N, hd) product (2 GB at mamba2-1.3b's prefill).
    xw = xc * (dt_j * decay_to_end)[..., None]
    dbx = torch.einsum("bmhn,bmhp->bhpn", bc, xw)
    h_new = h * torch.exp(cum[:, -1])[:, :, None, None] + dbx
    return h_new, y_intra + y_inter


def ssd_scan(x, dt, b, c, a, chunk, h0=None):
    """Full-sequence SSD.

    x: (B,S,nh,hd) f32; dt: (B,S,nh) f32 (post-softplus); b,c: (B,S,G,N) f32;
    a: (nh,) f32 negative.  Returns (y, h_final).  The reference's
    ``lax.scan`` over chunks is a loop that carries h.
    """
    bsz, s, nh, hd = x.shape
    g, n = b.shape[2], b.shape[3]
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        # zero-dt padding: exp(0)=1 decay and zero input, so the padded
        # steps neither move the state nor contribute output.
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    a_dt = dt * a
    h = h0 if h0 is not None else x.new_zeros((bsz, nh, hd, n))
    ys = []
    for c0 in range(0, s + pad, chunk):
        win = slice(c0, c0 + chunk)
        h, y = _ssd_chunk(h, (x[:, win], a_dt[:, win], b[:, win], c[:, win],
                              dt[:, win]), nh // g)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :s], h


def ssm_forward(p, x, cfg, *, return_state=False):
    """Full-sequence Mamba-2 block.  x: (B, S, D).

    ``return_state`` also returns ``(h_final, (conv_x, conv_b, conv_c))``,
    the conv tails being the last W-1 *pre-conv* projections (sliced from
    the projections already made; the reference makes them again)."""
    s = cfg.ssm
    bsz, seq, _ = x.shape
    nh = _heads_of(cfg)
    z = x @ p["wz"]
    xi = x @ p["wx"]
    bi = x @ p["wb"]
    ci = x @ p["wc"]
    dti = x @ p["wdt"]
    xc = F.silu(_causal_conv(xi, p["conv_x"]))
    bc = F.silu(_causal_conv(bi, p["conv_b"]))
    cc = F.silu(_causal_conv(ci, p["conv_c"]))

    xh = xc.reshape(bsz, seq, nh, s.head_dim).float()
    bg = bc.reshape(bsz, seq, s.n_groups, s.d_state).float()
    cg = cc.reshape(bsz, seq, s.n_groups, s.d_state).float()
    dt = F.softplus(dti.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])

    y, h_fin = ssd_scan(xh, dt, bg, cg, a, s.chunk_size)
    y = y + xh * p["d_skip"][:, None]
    y = y.reshape(bsz, seq, nh * s.head_dim).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    out = y @ p["wo"]
    if return_state:
        return out, (h_fin, _conv_tail((xi, bi, ci), cfg))
    return out


def _conv_tail(projections, cfg):
    """The last W-1 steps of each pre-conv projection (B, S, C), copied:
    a view would keep the whole (B, S, C) projection alive in the cache."""
    w = cfg.ssm.conv_width
    return tuple(t[:, -(w - 1):, :].clone() for t in projections)


def ssm_cache_layout(cfg, batch, dtype=torch.float32):
    """``{name: (shape, dtype)}`` of one layer's decode state: ``h`` fp32,
    the conv tails in ``dtype``."""
    s = cfg.ssm
    di = s.expand * cfg.d_model
    gn = s.n_groups * s.d_state
    tail = s.conv_width - 1
    return {"h": ((batch, _heads_of(cfg), s.head_dim, s.d_state),
                  torch.float32),
            "conv_x": ((batch, tail, di), dtype),
            "conv_b": ((batch, tail, gn), dtype),
            "conv_c": ((batch, tail, gn), dtype)}


def init_ssm_cache(cfg, batch, dtype=torch.float32, device=None):
    return {name: torch.zeros(shape, dtype=dt, device=device)
            for name, (shape, dt) in ssm_cache_layout(cfg, batch,
                                                      dtype).items()}


def ssm_decode(p, x, cfg, cache):
    """Single-token decode.  x: (B, 1, D); cache: this layer's
    ``init_ssm_cache`` layout, whose ``h`` and conv tails are overwritten
    in place with the new state.  Returns (out, cache)."""
    s = cfg.ssm
    bsz = x.shape[0]
    nh = _heads_of(cfg)
    z = (x @ p["wz"])[:, 0]
    xi = (x @ p["wx"])[:, 0]
    bi = (x @ p["wb"])[:, 0]
    ci = (x @ p["wc"])[:, 0]
    dti = (x @ p["wdt"])[:, 0]

    def conv_step(state, cur, w):
        # state: (B, W-1, C) previous raw inputs; cur: (B, C).  The conv
        # runs in fp32, unlike prefill's.
        hist = torch.cat([state, cur[:, None]], dim=1)
        out = (hist.float() * w.float()).sum(dim=1)
        state.copy_(hist[:, 1:])
        return F.silu(out)

    xc = conv_step(cache["conv_x"], xi, p["conv_x"])
    bc = conv_step(cache["conv_b"], bi, p["conv_b"])
    cc = conv_step(cache["conv_c"], ci, p["conv_c"])

    xh = xc.reshape(bsz, nh, s.head_dim)
    rep = nh // s.n_groups
    bg = _repeat_groups(bc.reshape(bsz, s.n_groups, s.d_state), rep, 1)
    cg = _repeat_groups(cc.reshape(bsz, s.n_groups, s.d_state), rep, 1)
    dt = F.softplus(dti.float() + p["dt_bias"])           # (B, nh)
    a = -torch.exp(p["a_log"])
    da = torch.exp(dt * a)                                # (B, nh)
    h = cache["h"] * da[:, :, None, None] + torch.einsum(
        "bhn,bhp,bh->bhpn", bg, xh, dt)
    cache["h"].copy_(h)
    y = torch.einsum("bhn,bhpn->bhp", cg, h) + xh * p["d_skip"][:, None]
    y = y.reshape(bsz, nh * s.head_dim).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    return y[:, None] @ p["wo"], cache
