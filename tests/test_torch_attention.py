"""The port's attention, layers and flash-attention plain version against
the JAX reference's, on the CPU.

Inputs are made by numpy from a seed and handed to both packages.  The
reference's Pallas flash kernel runs in interpret mode on the CPU, as its
own tests run it; its other functions run as XLA on the CPU.

Tolerance: rtol = atol = 2e-5 for flash attention (the reference kernel
tests' own) and 1e-5 elsewhere, in fp32: the sums run in another order
than XLA's, and softmax over a whole row (the plain version) against an
online softmax over blocks (the reference kernel) differs by rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.kernels import flash_attention as jfa
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch.configs import reduced_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers

TOL = dict(rtol=1e-5, atol=1e-5)
FLASH_TOL = dict(rtol=2e-5, atol=2e-5)


def both(a):
    """One numpy array as (jax, torch) arrays."""
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


def qkv(rng, b, sq, sk, kv, g, dh, dv):
    q = rng.normal(size=(b, sq, kv, g, dh)).astype(np.float32)
    k = rng.normal(size=(b, sk, kv, dh)).astype(np.float32)
    v = rng.normal(size=(b, sk, kv, dv)).astype(np.float32)
    return q, k, v


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.float() if torch.is_tensor(
        got) else got), np.asarray(want, np.float32), **tol)


# -- flash attention: plain version against the reference's TPU kernel ------
@pytest.mark.parametrize(
    "b,s,kv,g,dh,dv,causal,qb,kb",
    [(2, 64, 2, 3, 16, 16, True, 16, 32),
     (1, 100, 1, 4, 32, 24, True, 32, 16),   # MLA-style dv != dh
     (2, 80, 2, 1, 16, 16, False, 16, 32),
     (1, 33, 2, 2, 8, 8, True, 8, 8),        # ragged blocks
     (1, 700, 1, 2, 8, 8, True, 128, 256)])  # several plain-version chunks
def test_flash_plain_matches_reference_kernel(b, s, kv, g, dh, dv, causal,
                                              qb, kb):
    q, k, v = qkv(np.random.default_rng(b * s + dh), b, s, s, kv, g, dh, dv)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal, q_block=qb,
                               kv_block=kb, interpret=True)
    got = fa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                   causal=causal)
    assert got.shape == want.shape and got.dtype == torch.float32
    close(got, want, FLASH_TOL)


@pytest.mark.parametrize(
    "b,sq,sk,kv,g,dh,dv,qb,kb",
    [(1, 70, 33, 2, 2, 16, 16, 16, 16),
     (2, 100, 64, 1, 3, 32, 24, 32, 32)])    # ragged, dv != dh
def test_flash_plain_matches_reference_kernel_when_sq_exceeds_sk(
        b, sq, sk, kv, g, dh, dv, qb, kb):
    """Causal with more queries than keys: q and k both count from 0, so
    every row at or past Sk sees all the keys."""
    q, k, v = qkv(np.random.default_rng(sq + sk), b, sq, sk, kv, g, dh, dv)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True, q_block=qb,
                               kv_block=kb, interpret=True)
    got = fa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                   causal=True)
    assert got.shape == want.shape == (b, sq, kv, g, dv)
    close(got, want, FLASH_TOL)
    full = fa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                    causal=False)
    assert torch.equal(got[:, sk - 1:], full[:, sk - 1:])


def test_flash_wrapper_on_cpu_runs_the_plain_version():
    q, k, v = qkv(np.random.default_rng(3), 2, 40, 40, 2, 2, 16, 8)
    before = fa.flash_launches
    got = fa.flash_attention(*map(torch.from_numpy, (q, k, v)))
    want = fa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)))
    assert fa.flash_launches == before
    assert torch.equal(got, want)


def test_flash_plain_bf16_rounds_like_the_reference_kernel():
    """bf16 in, bf16 out; P is rounded to bf16 before P·V in both."""
    q, k, v = qkv(np.random.default_rng(4), 1, 48, 48, 2, 2, 16, 16)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = jfa.flash_attention(jq, jk, jv, causal=True, q_block=16,
                               kv_block=16, interpret=True)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got = fa.flash_attention_plain(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    # Output rounding is 2^-8 relative; block order moves a few ulps.
    close(got, np.asarray(want.astype(jnp.float32)),
          dict(rtol=2e-2, atol=2e-2))


@pytest.mark.parametrize("shape", [(1, 4096, 4096, 8, 5, 128, 128),
                                   (4, 2000, 2000, 16, 1, 64, 64),
                                   (2, 33, 70, 2, 3, 96, 64)])
def test_traffic_bytes_matches_reference(shape):
    assert fa.traffic_bytes(*shape) == jfa.traffic_bytes(*shape)
    assert fa.traffic_bytes(*shape, dtype_bytes=4) == \
        jfa.traffic_bytes(*shape, dtype_bytes=4)


@pytest.mark.parametrize("bad", ["rank", "kv_shape", "dtype", "mixed",
                                 "empty"])
def test_flash_wrapper_refuses_bad_inputs(bad):
    q, k, v = (torch.from_numpy(a) for a in qkv(
        np.random.default_rng(5), 1, 8, 8, 2, 2, 8, 8))
    if bad == "rank":
        q = q[:, :, :, 0]
    elif bad == "kv_shape":
        k = k[:, :, :1]
    elif bad == "dtype":
        q, k, v = q.double(), k.double(), v.double()
    elif bad == "mixed":
        v = v.bfloat16()
    else:
        q = q[:, :0]
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v)


# -- chunked attention (the model's XLA path) --------------------------------
@pytest.mark.parametrize(
    "sq,sk,kv,g,dv,causal,prefix,chunk,kvb,q_off",
    [(48, 48, 2, 2, 16, True, 0, 16, 16, 0),      # streamed kv blocks
     (37, 37, 1, 4, 24, True, 0, 16, 1024, 0),    # one kv block, dv != dh
     (30, 45, 2, 1, 16, False, 0, 8, 16, 0),      # non-causal, ragged kv
     (40, 40, 2, 2, 16, True, 12, 16, 16, 0),     # prefix-LM
     (8, 40, 2, 2, 16, True, 0, 8, 16, 32)])      # q offset (decode-like)
def test_chunked_attention_matches_reference(sq, sk, kv, g, dv, causal,
                                             prefix, chunk, kvb, q_off):
    q, k, v = qkv(np.random.default_rng(sq + sk), 2, sq, sk, kv, g, 16, dv)
    kw = dict(causal=causal, prefix_len=prefix, chunk=chunk, q_offset=q_off,
              kv_block=kvb)
    want = jattn.chunked_attention(*map(jnp.asarray, (q, k, v)), **kw)
    got = tattn.chunked_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    assert got.shape == want.shape
    close(got, want)


def test_flash_plain_matches_model_attention():
    """The kernel's function is the model's chunked attention."""
    q, k, v = (torch.from_numpy(a) for a in qkv(
        np.random.default_rng(7), 2, 48, 48, 2, 2, 16, 16))
    a = fa.flash_attention_plain(q, k, v, causal=True)
    b = tattn.chunked_attention(q, k, v, causal=True, chunk=16, kv_block=16)
    close(a, b.numpy(), FLASH_TOL)


# -- layers ------------------------------------------------------------------
def test_rms_norm_matches_reference():
    rng = np.random.default_rng(0)
    x, s = rng.normal(size=(2, 5, 32)), rng.normal(size=32)
    jx, tx = both(x.astype(np.float32))
    js, ts = both(s.astype(np.float32))
    close(tlayers.rms_norm(tx, ts, 1e-5), jlayers.rms_norm(jx, js, 1e-5))
    # bf16: the variance in fp32, the rescale in bf16, at the same points.
    got = tlayers.rms_norm(tx.bfloat16(), ts.bfloat16())
    want = jlayers.rms_norm(jx.astype(jnp.bfloat16), js.astype(jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    close(got, np.asarray(want.astype(jnp.float32)),
          dict(rtol=1e-2, atol=1e-2))


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_apply_rope_matches_reference(fraction):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = np.arange(7)[None, :]
    jx, tx = both(x)
    want = jlayers.apply_rope(jx, jnp.asarray(pos), fraction, 10_000.0)
    got = tlayers.apply_rope(tx, torch.from_numpy(pos), fraction, 10_000.0)
    close(got, want)
    if fraction == 0.5:       # the second half of each head passes through
        assert torch.equal(got[..., 8:], tx[..., 8:])


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_ffn_apply_matches_reference(act):
    rng = np.random.default_rng(2)
    p = {n: rng.normal(size=shape).astype(np.float32) * 0.2
         for n, shape in (("w_gate", (32, 64)), ("w_up", (32, 64)),
                          ("w_down", (64, 32)))}
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    want = jlayers.ffn_apply({n: jnp.asarray(a) for n, a in p.items()},
                             jnp.asarray(x), act)
    got = tlayers.ffn_apply({n: torch.from_numpy(a) for n, a in p.items()},
                            torch.from_numpy(x), act)
    close(got, want)


def test_truncated_normal_init():
    g = torch.Generator().manual_seed(0)
    w = tlayers.dense_init(g, 256, 512, torch.float32)
    assert w.shape == (256, 512) and float(w.abs().max()) <= 2 * 256 ** -0.5
    # std of N(0,1) truncated to ±2 is 0.8796.
    assert abs(float(w.std()) * 16 - 0.8796) < 0.01
    e = tlayers.embed_init(g, 100, 64, torch.bfloat16)
    assert e.dtype == torch.bfloat16 and e.shape == (100, 64)


# -- the GQA mixer -----------------------------------------------------------
def mixer_params(cfg, seed):
    rng = np.random.default_rng(seed)
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    p = {"wq": (d, qd), "wk": (d, kvd), "wv": (d, kvd), "wo": (qd, d)}
    if cfg.qkv_bias:
        p.update(bq=(qd,), bk=(kvd,), bv=(kvd,))
    arrays = {n: (rng.normal(size=s) * d ** -0.5).astype(np.float32)
              for n, s in p.items()}
    return ({n: jnp.asarray(a) for n, a in arrays.items()},
            {n: torch.from_numpy(a) for n, a in arrays.items()})


ARCHS = ["qwen1.5-0.5b", "chatglm3-6b", "codeqwen1.5-7b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_attn_forward_matches_reference(arch):
    jcfg, tcfg = j_reduced_config(arch), reduced_config(arch)
    jp, tp = mixer_params(tcfg, 11)
    x = np.random.default_rng(12).normal(size=(2, 40, 64)).astype(np.float32)
    want, (jk, jv) = jattn.attn_forward(jp, jnp.asarray(x), jcfg,
                                        return_kv=True)
    got, (tk, tv) = tattn.attn_forward(tp, torch.from_numpy(x), tcfg,
                                       return_kv=True)
    close(got, want)
    close(tk, jk)
    close(tv, jv)


@pytest.mark.parametrize("arch", ARCHS)
def test_attn_decode_matches_reference(arch):
    jcfg, tcfg = j_reduced_config(arch), reduced_config(arch)
    jp, tp = mixer_params(tcfg, 13)
    rng = np.random.default_rng(14)
    shape = (2, 24, tcfg.num_kv_heads, tcfg.head_dim)
    ck = rng.normal(size=shape).astype(np.float32)
    cv = rng.normal(size=shape).astype(np.float32)
    x = rng.normal(size=(2, 1, 64)).astype(np.float32)
    want, jck, jcv = jattn.attn_decode(jp, jnp.asarray(x), jcfg,
                                       jnp.asarray(ck), jnp.asarray(cv),
                                       jnp.int32(17))
    tck, tcv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got, ock, ocv = tattn.attn_decode(tp, torch.from_numpy(x), tcfg, tck,
                                      tcv, 17)
    close(got, want)
    assert ock is tck and ocv is tcv          # written in place
    close(tck, jck)
    close(tcv, jcv)


def test_prefix_len_reaches_the_kernel_wrapper_off_the_cpu():
    """Off the CPU a prefix goes to the flash kernel's wrapper, which has
    no kernel for the ``meta`` device and raises there: the prefix itself
    is no longer refused."""
    cfg = reduced_config("qwen1.5-0.5b")
    _, tp = mixer_params(cfg, 15)
    meta = {n: t.to("meta") for n, t in tp.items()}
    x = torch.empty((1, 8, 64), device="meta")
    with pytest.raises(ValueError, match="no flash-attention kernel for "
                                         "device meta"):
        tattn.attn_forward(meta, x, cfg, prefix_len=4)
    # On the CPU the model's own path takes the prefix.
    out = tattn.attn_forward(tp, torch.zeros(1, 8, 64), cfg, prefix_len=4)
    assert out.shape == (1, 8, 64)


def test_cross_attn_init_matches_reference():
    """``cross=True`` adds ``xwq``/``xwk``/``xwv``/``xwo`` of the
    reference's shapes after the self-attention weights, in its order."""
    g = torch.Generator().manual_seed(0)
    cfg = reduced_config("whisper-base")
    p = tattn.attn_init(g, cfg, torch.float32, cross=True)
    want = jattn.attn_init(jax.random.key(0), j_reduced_config(
        "whisper-base"), jnp.float32, cross=True)
    assert list(p) == list(want)
    assert list(p)[-4:] == ["xwq", "xwk", "xwv", "xwo"]
    for name, ref in want.items():
        assert tuple(p[name].shape) == ref.shape
        assert p[name].dtype == torch.float32
    assert "xwq" not in tattn.attn_init(g, cfg, torch.float32)
