"""The port's Mamba-2 SSD mixer (``repro_torch.models.ssm``) against the
reference's, on the CPU.

The same numpy inputs (made from a seed) go through the reference's
functions in JAX and through the port's on CPU tensors.

Tolerance: rtol = atol = 1e-5 in fp32 (the same products and cumulative
sums, taken in another order).  In bf16 the projections, the causal conv
and the gated norm round to bf16 at each framework's own points while
the scan stays fp32, and each package lands about 6e-3 (in norm) from
the fp32 computation on the same bf16 weights, in other directions.  So
a bf16 output, and the fp32 state it leaves, must agree with the
reference's within ``BF16_REL`` = 2e-2 of its norm and elementwise
within 2e-2 of its largest magnitude (the largest |Δ| reads 0.8% of it:
two bf16 ulps of an element near the top).
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import ssm as jssm
from repro_torch import configs as tconfigs
from repro_torch.models import ssm as tssm

ARCH = "mamba2-1.3b"
TOL = dict(rtol=1e-5, atol=1e-5)
BF16_REL = 2e-2
B, CHUNK = 2, 16


def cfgs(n_groups=1):
    """Reduced mamba2 in both packages (d 64, 8 heads of 16, d_state 16,
    chunk 16) with ``n_groups`` B/C groups."""
    out = []
    for mod in (jconfigs, tconfigs):
        cfg = mod.reduced_config(ARCH)
        out.append(dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, n_groups=n_groups)))
    return out


def weights(cfg, seed=0):
    """Seeded numpy weights of ``ssm_init``'s shapes, fp32."""
    rng = np.random.default_rng(seed)
    s, d = cfg.ssm, cfg.d_model
    di = s.expand * d
    nh, gn = di // s.head_dim, s.n_groups * s.d_state
    shapes = {"wz": (d, di), "wx": (d, di), "wb": (d, gn), "wc": (d, gn),
              "wdt": (d, nh), "wo": (di, d)}
    w = {k: rng.standard_normal(v) * v[0] ** -0.5 for k, v in shapes.items()}
    for name, c in (("conv_x", di), ("conv_b", gn), ("conv_c", gn)):
        w[name] = rng.standard_normal((s.conv_width, c)) * 0.3
    w["a_log"] = np.log(rng.uniform(1.0, 16.0, nh))
    w["dt_bias"] = rng.uniform(-3.0, 0.5, nh)
    w["d_skip"] = rng.uniform(0.5, 1.5, nh)
    w["gate_norm"] = rng.uniform(0.5, 1.5, di)
    return {k: v.astype(np.float32) for k, v in w.items()}


FP32_NAMES = ("a_log", "dt_bias", "d_skip")


def both(w, bf16=False):
    """(reference dict, port dict) of ``w``; in bf16 every leaf but the
    fp32 ones is rounded to bf16 in both."""
    j, t = {}, {}
    for k, v in w.items():
        if bf16 and k not in FP32_NAMES:
            j[k] = jnp.asarray(v, jnp.bfloat16)
            t[k] = torch.from_numpy(v).to(torch.bfloat16)
        else:
            j[k], t[k] = jnp.asarray(v), torch.from_numpy(v)
    return j, t


def f32(a):
    if torch.is_tensor(a):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def close(got, want, tol=TOL):
    np.testing.assert_allclose(f32(got), f32(want), **tol)


def close_bf16(got, want):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape
    err = np.abs(got - want)
    assert np.linalg.norm(err) <= BF16_REL * np.linalg.norm(want)
    assert err.max() <= BF16_REL * np.abs(want).max(), err.max()


def hidden(cfg, s, seed=1, batch=B):
    return np.random.default_rng(seed).standard_normal(
        (batch, s, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("s", [2, 3, 10])
@pytest.mark.parametrize("width", [2, 4])
def test_causal_conv(s, width):
    rng = np.random.default_rng(s + width)
    x = rng.standard_normal((B, s, 12)).astype(np.float32)
    w = rng.standard_normal((width, 12)).astype(np.float32)
    got = tssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w))
    close(got, jssm._causal_conv(jnp.asarray(x), jnp.asarray(w)))


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_repeat_groups_keeps_each_group_in_place(groups):
    x = np.arange(B * 3 * groups * 5, dtype=np.float32).reshape(
        B, 3, groups, 5)
    got = tssm._repeat_groups(torch.from_numpy(x), 8 // groups, 2)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jnp.repeat(jnp.asarray(x), 8 // groups,
                                           axis=2)))


def scan_inputs(s, groups, seed):
    """x (B,S,nh,hd), dt (B,S,nh) > 0, b, c (B,S,G,N), a (nh,) < 0."""
    rng = np.random.default_rng(seed)
    nh, hd, n = 4, 8, 6
    x = rng.standard_normal((B, s, nh, hd))
    dt = np.log1p(np.exp(rng.standard_normal((B, s, nh)) - 1.0))
    b = rng.standard_normal((B, s, groups, n))
    c = rng.standard_normal((B, s, groups, n))
    a = -rng.uniform(0.5, 4.0, nh)
    h0 = rng.standard_normal((B, nh, hd, n))
    return [v.astype(np.float32) for v in (x, dt, b, c, a, h0)]


@pytest.mark.parametrize("with_h0", [False, True], ids=["h0-zero", "h0"])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("s", [9, 32, 37], ids=["below-chunk",
                                                "two-chunks", "padded"])
def test_ssd_scan(s, groups, with_h0):
    x, dt, b, c, a, h0 = scan_inputs(s, groups, seed=s + groups)
    h0 = h0 if with_h0 else None
    jy, jh = jssm.ssd_scan(*map(jnp.asarray, (x, dt, b, c, a)), CHUNK,
                           h0=None if h0 is None else jnp.asarray(h0))
    ty, th = tssm.ssd_scan(*map(torch.from_numpy, (x, dt, b, c, a)), CHUNK,
                           h0=None if h0 is None else torch.from_numpy(h0))
    assert ty.shape == (B, s, 4, 8) and th.shape == (B, 4, 8, 6)
    close(ty, jy)
    close(th, jh)


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("s", [12, 37])
def test_ssm_forward_with_state(s, groups):
    jcfg, tcfg = cfgs(groups)
    jw, tw = both(weights(tcfg, seed=groups))
    x = hidden(tcfg, s)
    jout, (jh, jtails) = jssm.ssm_forward(jw, jnp.asarray(x), jcfg,
                                          return_state=True)
    tout, (th, ttails) = tssm.ssm_forward(tw, torch.from_numpy(x), tcfg,
                                          return_state=True)
    close(tout, jout)
    close(th, jh)
    assert len(ttails) == 3
    for got, want in zip(ttails, jtails):
        assert got.shape == want.shape
        close(got, want)
    close(tssm.ssm_forward(tw, torch.from_numpy(x), tcfg), jout)


@pytest.mark.parametrize("batch", [1, 2])
def test_prefill_state_holds_no_sequence_tensor(batch):
    """The returned h and conv tails own storage of their own size: a
    view of a (B, S, C) projection would keep the whole prompt's
    projections alive in every layer's cache entry."""
    _, tcfg = cfgs()
    _, tw = both(weights(tcfg, seed=3))
    x = torch.from_numpy(hidden(tcfg, 37, batch=batch))
    _, (h, tails) = tssm.ssm_forward(tw, x, tcfg, return_state=True)
    for t in (h, *tails):
        assert t.untyped_storage().nbytes() == t.numel() * t.element_size()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_ssm_cache_layout(dtype):
    jcfg, tcfg = cfgs()
    want = jssm.init_ssm_cache(jcfg, 3, jnp.dtype(dtype))
    got = tssm.init_ssm_cache(tcfg, 3, getattr(torch, dtype))
    assert got.keys() == want.keys()
    for name, ref in want.items():
        assert tuple(got[name].shape) == ref.shape
        assert str(got[name].dtype).removeprefix("torch.") == str(ref.dtype)
        assert not bool(got[name].any())
    assert got["h"].dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_init_has_the_reference_tree(dtype):
    """Keys, shapes and dtypes of ``ssm_init`` equal the reference's; the
    decay, step bias and skip stay fp32 in a bf16 model."""
    jcfg, tcfg = cfgs(2)
    want = jssm.ssm_init(jax.random.key(0), jcfg, jnp.dtype(dtype))
    got = tssm.ssm_init(torch.Generator().manual_seed(0), tcfg,
                        getattr(torch, dtype))
    assert list(got) == list(want)
    for name, ref in want.items():
        assert tuple(got[name].shape) == ref.shape, name
        assert str(got[name].dtype).removeprefix("torch.") == \
            str(ref.dtype), name
    for name in FP32_NAMES + ("gate_norm",):
        close(got[name], want[name])


@pytest.mark.parametrize("groups", [1, 2])
def test_chained_decode_writes_the_callers_cache(groups):
    """Three ``ssm_decode`` steps after a prefill: outputs and the new
    state match the reference's, and the state lands in the caller's
    cache tensors in place."""
    jcfg, tcfg = cfgs(groups)
    jw, tw = both(weights(tcfg, seed=3 + groups))
    x = hidden(tcfg, 19 + 3, seed=groups)
    _, (jh, jt) = jssm.ssm_forward(jw, jnp.asarray(x[:, :19]), jcfg,
                                   return_state=True)
    jcache = {"h": jh, "conv_x": jt[0], "conv_b": jt[1], "conv_c": jt[2]}
    tcache = {k: torch.from_numpy(np.array(f32(v)))
              for k, v in jcache.items()}
    held = dict(tcache)
    for i in range(3):
        xi = x[:, 19 + i:20 + i]
        jout, jcache = jssm.ssm_decode(jw, jnp.asarray(xi), jcfg, jcache)
        tout, got = tssm.ssm_decode(tw, torch.from_numpy(xi), tcfg, tcache)
        assert got is tcache
        assert all(got[k] is held[k] for k in held)
        assert tout.shape == (B, 1, tcfg.d_model)
        close(tout, jout)
        for name, want in jcache.items():
            close(tcache[name], want)
    # The chain ends where a prefill of all 22 steps ends.
    jout, _ = jssm.ssm_forward(jw, jnp.asarray(x), jcfg, return_state=True)
    close(tout[:, 0], jout[:, -1], dict(rtol=1e-4, atol=1e-4))


def test_bf16_forward_and_decode_near_reference():
    jcfg, tcfg = cfgs()
    jcfg, tcfg = (dataclasses.replace(c, param_dtype="bfloat16",
                                      activation_dtype="bfloat16")
                  for c in (jcfg, tcfg))
    jw, tw = both(weights(tcfg, seed=7), bf16=True)
    x = hidden(tcfg, 37).astype(ml_dtypes.bfloat16)
    jout, (jh, jt) = jssm.ssm_forward(jw, jnp.asarray(x[:, :36]), jcfg,
                                      return_state=True)
    xt = torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    tout, (th, tt) = tssm.ssm_forward(tw, xt[:, :36], tcfg,
                                      return_state=True)
    assert tout.dtype == torch.bfloat16 and th.dtype == torch.float32
    close_bf16(tout, jout)
    close_bf16(th, jh)
    jcache = {"h": jh, "conv_x": jt[0], "conv_b": jt[1], "conv_c": jt[2]}
    tcache = {"h": th, "conv_x": tt[0].clone(), "conv_b": tt[1].clone(),
              "conv_c": tt[2].clone()}
    jd, _ = jssm.ssm_decode(jw, jnp.asarray(x[:, 36:]), jcfg, jcache)
    td, _ = tssm.ssm_decode(tw, xt[:, 36:], tcfg, tcache)
    assert td.dtype == torch.bfloat16
    close_bf16(td, jd)
