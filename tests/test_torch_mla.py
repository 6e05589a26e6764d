"""The port's multi-head latent attention (``repro_torch.models.attention``
``mla_*``) against the reference's, on the CPU.

The same numpy inputs (made from a seed) go through the reference's
functions in JAX and through the port's on CPU tensors, at two widths:
reduced minicpm3-4b (d 64, 4 heads, rope 8 + nope 8 with v 24, so
dv > dh) and its published width (d 2560, 40 heads, rope 32 + nope 64
with v 64, so dv < dh) on a few tokens.

Tolerance: rtol = atol = 1e-5 in fp32 (the same products and softmax,
summed in another order).  In bf16 each framework rounds the projections,
the norms and the attention output at its own points, so a bf16 output
must agree with the reference's within ``BF16_REL`` = 2e-2 of its norm
and elementwise within 2e-2 of its largest magnitude.  At the published
width the prefill output reads 9.0e-4 in norm and 4.1e-3 of the largest
magnitude (about one bf16 ulp, 2^-8, of an element near the top); the
reduced model's round at the same points and read 0.

Two controls must fail the fp32 check: the query heads split as
``[nope, rope]`` instead of the reference's ``[rope, nope]``, and the
expansion without ``kv_norm``.  They are ``chip_smoke.py``'s own
(phase 10(b)).
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models.model import LM as JLM
from repro_torch import configs as tconfigs
from repro_torch.models import attention as tattn
from repro_torch.models.model import LM

sys.path.append(os.path.join(os.path.dirname(__file__), ".."))
from chip_smoke import nope_first, patched, without_kv_norm  # noqa: E402

ARCH = "minicpm3-4b"
TOL = dict(rtol=1e-5, atol=1e-5)
BF16_REL = 2e-2
B = 2
WIDTHS = ["reduced", "full"]


def cfgs(width="reduced", dtype="float32"):
    """minicpm3-4b in both packages, reduced or at its published width."""
    get = "reduced_config" if width == "reduced" else "get_config"
    return [dataclasses.replace(getattr(mod, get)(ARCH), param_dtype=dtype,
                                activation_dtype=dtype)
            for mod in (jconfigs, tconfigs)]


def weights(cfg, seed=0):
    """Seeded numpy weights of ``mla_init``'s shapes, fp32; the norm
    scales are not ones, so a swapped or missing norm shows."""
    rng = np.random.default_rng(seed)
    c, d, h = cfg.mla, cfg.d_model, cfg.num_heads
    shapes = {"wq_a": (d, c.q_lora_rank),
              "wq_b": (c.q_lora_rank, h * (c.rope_head_dim
                                           + c.nope_head_dim)),
              "wkv_a": (d, c.kv_lora_rank + c.rope_head_dim),
              "wkv_b": (c.kv_lora_rank, h * (c.nope_head_dim
                                             + c.v_head_dim)),
              "wo": (h * c.v_head_dim, d)}
    w = {k: rng.standard_normal(v) * v[0] ** -0.5 for k, v in shapes.items()}
    w["q_norm"] = rng.uniform(0.5, 1.5, c.q_lora_rank)
    w["kv_norm"] = rng.uniform(0.5, 1.5, c.kv_lora_rank)
    return {k: v.astype(np.float32) for k, v in w.items()}


def to_bf16(a):
    return a.astype(ml_dtypes.bfloat16)


def torch_of(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def both(w, bf16=False):
    """(reference dict, port dict) of ``w``, every leaf rounded to bf16 in
    both when ``bf16``."""
    if bf16:
        w = {k: to_bf16(v) for k, v in w.items()}
    return ({k: jnp.asarray(v) for k, v in w.items()},
            {k: torch_of(v) for k, v in w.items()})


def f32(a):
    if torch.is_tensor(a):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def close(got, want, tol=TOL):
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(f32(got), f32(want), **tol)


def close_bf16(got, want):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape
    err = np.abs(got - want)
    assert np.linalg.norm(err) <= BF16_REL * np.linalg.norm(want)
    assert err.max() <= BF16_REL * np.abs(want).max(), err.max()


def hidden(cfg, s, seed=1):
    """RMS-normalised hidden states (B, S, D), as a layer's input."""
    x = np.random.default_rng(seed).standard_normal((B, s, cfg.d_model))
    x /= np.sqrt((x * x).mean(-1, keepdims=True))
    return x.astype(np.float32)


def both_x(x):
    return jnp.asarray(x), torch_of(x)


# The reference's decode, compiled once per shape (eager JAX compiles
# each op anew for every ``pos``).
jdecode = jax.jit(jattn.mla_decode, static_argnums=2)


def positions(s, offset=0):
    pos = np.arange(offset, offset + s)[None, :]
    return jnp.asarray(pos, jnp.int32), torch.from_numpy(pos)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", WIDTHS)
def test_mla_init_has_the_reference_tree(width, dtype):
    """Keys, shapes and dtypes of ``mla_init`` equal the reference's; the
    norm scales are ones."""
    jcfg, tcfg = cfgs(width)
    want = jattn.mla_init(jax.random.key(0), jcfg, jnp.dtype(dtype))
    got = tattn.mla_init(torch.Generator().manual_seed(0), tcfg,
                         getattr(torch, dtype))
    assert sorted(got) == sorted(want)
    for name, ref in want.items():
        assert tuple(got[name].shape) == ref.shape, name
        assert str(got[name].dtype).removeprefix("torch.") == \
            str(ref.dtype), name
    for name in ("q_norm", "kv_norm"):
        close(got[name], want[name])


@pytest.mark.parametrize("offset", [0, 7])
@pytest.mark.parametrize("width", WIDTHS)
def test_mla_qkv(width, offset):
    jcfg, tcfg = cfgs(width)
    jw, tw = both(weights(tcfg))
    jx, tx = both_x(hidden(tcfg, 9))
    jpos, tpos = positions(9, offset)
    want = jattn._mla_qkv(jw, jx, jcfg, jpos)
    got = tattn._mla_qkv(tw, tx, tcfg, tpos)
    c = tcfg.mla
    assert got[0].shape == (B, 9, tcfg.num_heads,
                            c.rope_head_dim + c.nope_head_dim)
    assert got[2].shape == (B, 9, 1, c.rope_head_dim)
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("width", WIDTHS)
def test_mla_expand(width):
    jcfg, tcfg = cfgs(width)
    jw, tw = both(weights(tcfg, seed=2))
    c = tcfg.mla
    rng = np.random.default_rng(3)
    ckv = rng.standard_normal((B, 11, c.kv_lora_rank)).astype(np.float32)
    krope = rng.standard_normal((B, 11, 1, c.rope_head_dim)).astype(
        np.float32)
    jk, jv = jattn._mla_expand(jw, jnp.asarray(ckv), jnp.asarray(krope), jcfg)
    tk, tv = tattn._mla_expand(tw, torch.from_numpy(ckv),
                               torch.from_numpy(krope), tcfg)
    assert tv.shape == (B, 11, tcfg.num_heads, c.v_head_dim)
    close(tk, jk)
    close(tv, jv)


# Reduced minicpm3's attn_chunk is 32: 20 tokens are one q chunk, 45 two.
@pytest.mark.parametrize("width,s", [("reduced", 20), ("reduced", 45),
                                     ("full", 12)])
def test_mla_forward_with_kv(width, s):
    jcfg, tcfg = cfgs(width)
    jw, tw = both(weights(tcfg, seed=4))
    jx, tx = both_x(hidden(tcfg, s, seed=s))
    jout, (jckv, jkrope) = jattn.mla_forward(jw, jx, jcfg, return_kv=True)
    tout, (tckv, tkrope) = tattn.mla_forward(tw, tx, tcfg, return_kv=True)
    assert tout.shape == (B, s, tcfg.d_model)
    assert tckv.shape == (B, s, tcfg.mla.kv_lora_rank)
    assert tkrope.shape == (B, s, tcfg.mla.rope_head_dim)
    close(tout, jout)
    close(tckv, jckv)
    close(tkrope, jkrope)
    close(tattn.mla_forward(tw, tx, tcfg), jout)


def prefilled(jw, tw, jcfg, tcfg, x, s, max_len, dtype=np.float32):
    """The reference's prefill latents of ``x[:, :s]`` padded to
    ``max_len``, as JAX arrays and as port tensors."""
    _, (ckv, krope) = jattn.mla_forward(jw, jnp.asarray(x[:, :s]), jcfg,
                                        return_kv=True)
    pad = ((0, 0), (0, max_len - s), (0, 0))
    jc = (jnp.pad(ckv, pad), jnp.pad(krope, pad))
    tc = tuple(torch_of(np.asarray(a).astype(dtype)) for a in jc)
    return jc, tc


@pytest.mark.parametrize("width", WIDTHS)
def test_chained_decode_writes_the_callers_cache(width):
    """Three ``mla_decode`` steps after a prefill: outputs and both latent
    caches match the reference's, the token's latents land in the
    caller's tensors in place, and the chain ends where a prefill of all
    the tokens ends."""
    jcfg, tcfg = cfgs(width)
    jw, tw = both(weights(tcfg, seed=5))
    s, max_len = 13, 20
    x = hidden(tcfg, s + 3, seed=6)
    (jckv, jkrope), (tckv, tkrope) = prefilled(jw, tw, jcfg, tcfg, x, s,
                                               max_len)
    for i in range(3):
        xi = x[:, s + i:s + i + 1]
        jout, jckv, jkrope = jdecode(jw, jnp.asarray(xi), jcfg, jckv,
                                      jkrope, s + i)
        tout, gckv, gkrope = tattn.mla_decode(tw, torch.from_numpy(xi), tcfg,
                                              tckv, tkrope, s + i)
        assert gckv is tckv and gkrope is tkrope
        assert tout.shape == (B, 1, tcfg.d_model)
        close(tout, jout)
        close(tckv, jckv)
        close(tkrope, jkrope)
    assert not bool(tckv[:, s + 3:].any())
    full = jattn.mla_forward(jw, jnp.asarray(x), jcfg)
    close(tout[:, 0], full[:, -1], dict(rtol=1e-4, atol=1e-4))


@pytest.mark.parametrize("width", WIDTHS)
def test_bf16_forward_and_decode_near_reference(width):
    jcfg, tcfg = cfgs(width, "bfloat16")
    jw, tw = both(weights(tcfg, seed=7), bf16=True)
    x = to_bf16(hidden(tcfg, 37, seed=8))
    jx, tx = both_x(x)
    jout, (jckv, jkrope) = jattn.mla_forward(jw, jx[:, :36], jcfg,
                                             return_kv=True)
    tout, (tckv, tkrope) = tattn.mla_forward(tw, tx[:, :36], tcfg,
                                             return_kv=True)
    assert tout.dtype == tckv.dtype == torch.bfloat16
    close_bf16(tout, jout)
    close_bf16(tckv, jckv)
    close_bf16(tkrope, jkrope)
    (jc, jr), (tc, tr) = prefilled(jw, tw, jcfg, tcfg, x, 36, 40,
                                   ml_dtypes.bfloat16)
    jd, _, _ = jdecode(jw, jx[:, 36:], jcfg, jc, jr, 36)
    td, _, _ = tattn.mla_decode(tw, tx[:, 36:], tcfg, tc, tr, 36)
    assert td.dtype == torch.bfloat16
    close_bf16(td, jd)


def test_pad_cache_seq_pads_the_latents_along_s():
    """``_pad_cache_seq`` grows ``ckv`` (P, B, S, r) and ``krope``
    (P, B, S, rope) along S (axis 2), leaves B alone, and equals the
    reference's padding; a 5-D K/V entry pads along S too."""
    jcfg, tcfg = cfgs()
    rng = np.random.default_rng(9)
    p, b, s, max_len = 2, 3, 5, 9
    tree = {"sub0": {"ckv": rng.standard_normal((p, b, s, 16)),
                     "krope": rng.standard_normal((p, b, s, 8))},
            "sub1": {"k": rng.standard_normal((p, b, s, 2, 4)),
                     "v": rng.standard_normal((p, b, s, 2, 4))}}
    tree = {k: {n: a.astype(np.float32) for n, a in e.items()}
            for k, e in tree.items()}
    want = JLM(jcfg)._pad_cache_seq(
        {k: {n: jnp.asarray(a) for n, a in e.items()}
         for k, e in tree.items()}, max_len)
    got = LM(tcfg)._pad_cache_seq(
        {k: {n: torch.from_numpy(a) for n, a in e.items()}
         for k, e in tree.items()}, max_len)
    for key, ent in want.items():
        for name, ref in ent.items():
            t = got[key][name]
            assert t.shape[:3] == (p, b, max_len), (name, t.shape)
            close(t, ref)
            assert not bool(t[:, :, s:].any())


@pytest.mark.parametrize("control", ["nope-first", "no-kv-norm"])
@pytest.mark.parametrize("width", WIDTHS)
def test_controls_fail_the_parity_check(width, control):
    """The port with the query heads split as ``[nope, rope]``, or with
    the expansion skipping ``kv_norm``, leaves the reference's prefill
    output and decode step far outside the fp32 tolerance."""
    jcfg, tcfg = cfgs(width)
    jw, tw = both(weights(tcfg, seed=10))
    s = 12
    x = hidden(tcfg, s + 1, seed=11)
    jx, tx = both_x(x)
    want = jattn.mla_forward(jw, jx[:, :s], jcfg)
    (jc, jr), (tc, tr) = prefilled(jw, tw, jcfg, tcfg, x, s, s + 1)
    jd, _, _ = jdecode(jw, jx[:, s:], jcfg, jc, jr, s)
    cw = nope_first(tw, tcfg) if control == "nope-first" else tw
    with patched(tattn, "rms_norm", without_kv_norm(cw)
                 if control == "no-kv-norm" else tattn.rms_norm):
        got = tattn.mla_forward(cw, tx[:, :s], tcfg)
        gd, _, _ = tattn.mla_decode(cw, tx[:, s:], tcfg, tc, tr, s)
    for g, w in ((got, want), (gd, jd)):
        err = np.abs(f32(g) - f32(w))
        assert err.max() > 100 * (TOL["atol"] + TOL["rtol"]
                                  * np.abs(f32(w)).max())
