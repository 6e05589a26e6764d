"""The port's int8 KV cache and its ``max_len`` prefill cache against the
JAX reference's, on the CPU.

The reference makes the weights and both packages run the same reduced
models in fp32 (its ``jax.jit`` of prefill and decode; the port on CPU
tensors).  Under ``kv_cache_quant`` each token's K and V are kept per head
as int8 codes and an fp32 scale.

Tolerances:
- ``quantize_kv`` and ``dequantize_kv``: codes and scales bit-equal to the
  compiled reference's (XLA turns the reference's division by the constant
  127 into a product with its fp32 reciprocal, which the port takes; the
  eager reference's division lies within one ulp of it).
- ``attn_decode_quant``: 1e-5 in fp32.
- The models: logits within 1e-4 (as ``test_torch_lm``), scales within
  1e-4, greedy tokens equal.  A code may differ by one only where the
  reference's ``t / s`` lay within 1e-5 of a half-integer: there the two
  packages' K (sums in another order) can round to either side.  The
  reference's ``t`` and ``s`` are read back from its compiled run by a host
  callback, and the count of such codes is printed.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models.model import build as jbuild
from repro.serve.engine import ServeEngine as JEngine
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.models.model import LM, build
from repro_torch.serve.engine import ServeEngine
from test_torch_lm import f32, leaves, to_numpy
from torch_port_util import reference_compiled_here  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_TOL = dict(rtol=1e-5, atol=1e-5)
TIE = 1e-5
B, S, EXTRA = 2, 12, 4
QUANT_ARCHS = ["chatglm3-6b", "codeqwen1.5-7b", "llama4-scout-17b-a16e",
               "jamba-1.5-large-398b", "paligemma-3b"]


def layout(cache):
    """The cache's ``(sub-layer, name, shape, dtype)``, sorted (the
    reference's compiled programs return dicts in key order)."""
    return sorted((k, n, tuple(t.shape), str(t.dtype).removeprefix("torch."))
                  for k, n, t in leaves(cache))


def max_len(cfg):
    return cfg.vision_tokens + S + EXTRA + 4


def models(arch, **over):
    """(reference LM, its params, port LM, carried params, port cfg) of the
    reduced ``arch`` with ``over`` applied in both packages."""
    jcfg = dataclasses.replace(jconfigs.reduced_config(arch), **over)
    tcfg = dataclasses.replace(tconfigs.reduced_config(arch), **over)
    jlm = jbuild(jcfg)
    jparams = jlm.init(jax.random.key(0))
    tparams = convert.lm_params_from_arrays(tcfg, to_numpy(jparams),
                                            device="cpu")
    return jlm, jparams, build(tcfg), tparams, tcfg


def inputs(cfg, seed=0):
    """The tokens (B, S + EXTRA) and, for a VLM or an encoder-decoder, its
    stub ``patches`` or ``frames``, as numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + EXTRA)).astype(np.int32)
    stubs = {}
    if cfg.vision_tokens:
        stubs["patches"] = rng.normal(size=(
            B, cfg.vision_tokens, cfg.vision_embed_dim)).astype(np.float32)
    if cfg.encoder_layers:
        stubs["frames"] = rng.normal(size=(
            B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return toks, stubs


def batches(toks, stubs, n=S):
    """The prompt's first ``n`` tokens as a reference and a port batch."""
    return ({"inputs": jnp.asarray(toks[:, :n]),
             **{k: jnp.asarray(v) for k, v in stubs.items()}},
            {"inputs": torch.from_numpy(toks[:, :n]),
             **{k: torch.from_numpy(v) for k, v in stubs.items()}})


@contextlib.contextmanager
def recorded_quantize():
    """The reference's ``quantize_kv`` sends each call's input ``t`` and
    scales to the host (an ordered callback, so the calls arrive in
    program order, each period's K then V), into the yielded list."""
    seen = []
    orig = jattn.quantize_kv

    def rec(t):
        q, s = orig(t)
        jax.debug.callback(lambda tt, ss: seen.append(
            (np.asarray(tt, np.float32), np.asarray(ss))), t, s,
            ordered=True)
        return q, s

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jattn, "quantize_kv", rec)
        yield seen


def ratio_caches(seen, cfg, prompt, steps, maxlen):
    """The reference's ``t / max(s, 1e-8)`` of every cached code, placed as
    the codes are: ``{(sub-layer, "k" | "v"): (P, B, max_len, KV, dh)}``
    (NaN where nothing was written).  ``seen`` holds the prefill's calls
    and then each decode step's, each period's quantised sub-layers in
    order, K then V."""
    keys = [f"sub{i}" for i, (m, _) in enumerate(cfg.layout) if m == "attn"]
    shape = (cfg.num_periods, B, maxlen, cfg.num_kv_heads, cfg.head_dim)
    out = {(key, n): np.full(shape, np.nan, np.float32)
           for key in keys for n in ("k", "v")}
    calls = iter(seen)
    for step in range(steps + 1):
        where = slice(0, prompt) if step == 0 else \
            slice(prompt + step - 1, prompt + step)
        for p in range(cfg.num_periods):
            for key in keys:
                for name in ("k", "v"):
                    t, s = next(calls)
                    out[key, name][p, :, where] = \
                        t / np.maximum(s, np.float32(1e-8))[..., None]
    assert next(calls, None) is None
    return out


def assert_codes_match(got, want, ratio) -> int:
    """Codes equal but for ones one apart where the reference's ratio lay
    within ``TIE`` of a half-integer; returns how many."""
    diff = got.astype(np.int32) - want.astype(np.int32)
    off = diff != 0
    assert np.abs(diff).max(initial=0) <= 1
    r = ratio[off]
    assert np.all(np.abs(np.abs(r - np.floor(r)) - 0.5) < TIE), r
    return int(off.sum())


def tie_rows(dtype):
    """(4, 16) rows whose scale is exactly 1 (max|t| = 127 · fp32(1/127)
    rounds to 1.0) holding half-integers, and an all-zero row."""
    ties = np.array([[127, 0.5, 1.5, 2.5, -2.5, -3.5, 3.5, 126.5,
                      -126.5, 4.5, -0.5, 5.5, 6.5, -7.5, 63.5, 64.5],
                     [-127, -1.5, 8.5, 9.5, -10.5, 11.5, 12.5, 13.5,
                      14.5, 15.5, 16.5, -17.5, 18.5, 19.5, 20.5, 21.5],
                     [254, 5.0, 3.0, -5.0, 7.0, 1.0, 9.0, 11.0,
                      13.0, -3.0, 15.0, 17.0, 19.0, 21.0, 23.0, 25.0],
                     np.zeros(16)], np.float32)
    return ties.astype(dtype)


def kv_inputs(dtype, seed=0):
    """(B, S, KV, dh) of random rows at mixed magnitudes, with the
    :func:`tie_rows` in the first sequence position."""
    rng = np.random.default_rng(seed)
    t = (rng.normal(size=(3, 40, 4, 16))
         * rng.uniform(1e-3, 30, (3, 40, 4, 1))).astype(np.float32)
    t[0, 0] = tie_rows(np.float32)
    t[1, 5, 2] = 0.0
    return t.astype(dtype)


# -- quantize_kv / dequantize_kv -------------------------------------------
DTYPES = {"float32": (np.float32, torch.float32, jnp.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, jnp.bfloat16)}


def both_kv(name, seed=0):
    _, t_dt, j_dt = DTYPES[name]
    x = kv_inputs(np.float32, seed)
    return jnp.asarray(x, j_dt), torch.from_numpy(x).to(t_dt)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quantize_kv_is_the_compiled_reference_bit_for_bit(dtype):
    jx, tx = both_kv(dtype)
    jq, js = jax.jit(jattn.quantize_kv)(jx)
    tq, ts = tattn.quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tq.shape == tx.shape and ts.shape == tx.shape[:3]
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))
    # The ties round half to even; the zero row is codes 0 at scale 0.
    ties = tq[0, 0].numpy()
    assert ties[0].tolist() == [127, 0, 2, 2, -2, -4, 4, 126, -126, 4, 0,
                                6, 6, -8, 64, 64]
    assert ties[2].tolist() == [127, 2, 2, -2, 4, 0, 4, 6, 6, -2, 8, 8,
                                10, 10, 12, 12]
    assert ts[0, 0].tolist() == [1.0, 1.0, 2.0, 0.0]
    assert not tq[0, 0, 3].any() and not tq[1, 5, 2].any()
    assert float(ts[1, 5, 2]) == 0.0


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quantize_kv_scale_is_the_eager_reference_within_an_ulp(dtype):
    """Op by op the reference divides by 127: its scales lie within one
    ulp of the port's, so its codes differ by one at most, and only where
    its ``t / s`` lay within 1e-5 of a half-integer."""
    jx, tx = both_kv(dtype, seed=1)
    jq, js = jattn.quantize_kv(jx)
    tq, ts = tattn.quantize_kv(tx)
    js = np.asarray(js)
    ulps = np.abs(ts.numpy().view(np.int32).astype(np.int64)
                  - js.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    ratio = f32(jx) / np.maximum(js, np.float32(1e-8))[..., None]
    flips = assert_codes_match(tq.numpy(), np.asarray(jq), ratio)
    print(f"{dtype}: {int((ulps > 0).sum())} scales one ulp apart, "
          f"{flips} codes one apart")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_dequantize_kv_matches_reference(dtype):
    _, t_dt, j_dt = DTYPES[dtype]
    jx, tx = both_kv("float32", seed=2)
    jq, js = jax.jit(jattn.quantize_kv)(jx)
    tq, ts = tattn.quantize_kv(tx)
    want = jax.jit(jattn.dequantize_kv, static_argnums=2)(jq, js, j_dt)
    got = tattn.dequantize_kv(tq, ts, t_dt)
    assert got.dtype == t_dt
    np.testing.assert_array_equal(f32(got), f32(want))


# -- attn_decode_quant ---------------------------------------------------------
@pytest.mark.parametrize("pos", [0, 11, 19])
def test_attn_decode_quant_matches_reference(pos):
    """One token over a random int8 cache (chatglm3 reduced: RoPE on half
    the head, QKV bias, 4 heads over 2): output within 1e-5, the token's
    codes and scales written at ``pos`` in place, the rest untouched."""
    _, jparams, _, tparams, cfg = models("chatglm3-6b", kv_cache_quant=True)
    jcfg = dataclasses.replace(jconfigs.reduced_config(cfg.arch_id),
                               kv_cache_quant=True)
    jmix = jax.tree.map(lambda a: a[0], jparams["blocks"]["sub0"]["mixer"])
    tmix = tparams["blocks"][0]["sub0"]["mixer"]
    rng = np.random.default_rng(pos)
    smax, kvh, dh = 20, cfg.num_kv_heads, cfg.head_dim
    ent = {"k": rng.integers(-127, 128, (B, smax, kvh, dh)).astype(np.int8),
           "v": rng.integers(-127, 128, (B, smax, kvh, dh)).astype(np.int8),
           "k_s": rng.uniform(0, 0.05, (B, smax, kvh)).astype(np.float32),
           "v_s": rng.uniform(0, 0.05, (B, smax, kvh)).astype(np.float32)}
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    with recorded_quantize() as seen:
        want, went = jax.jit(lambda p, x, e: jattn.attn_decode_quant(
            p, x, jcfg, e, jnp.int32(pos)))(
                jmix, jnp.asarray(x),
                {k: jnp.asarray(v) for k, v in ent.items()})
        jax.effects_barrier()
    tent = {k: torch.from_numpy(v.copy()) for k, v in ent.items()}
    got, gent = tattn.attn_decode_quant(tmix, torch.from_numpy(x), cfg,
                                        tent, pos)
    assert gent is tent
    np.testing.assert_allclose(f32(got), f32(want), **DECODE_TOL)
    others = np.arange(smax) != pos
    for name in ent:
        np.testing.assert_array_equal(tent[name].numpy()[:, others],
                                      ent[name][:, others])
    for (t, s), name in zip(seen, ("k", "v")):
        np.testing.assert_allclose(tent[name + "_s"].numpy(),
                                   np.asarray(went[name + "_s"]),
                                   **DECODE_TOL)
        assert_codes_match(tent[name].numpy()[:, pos],
                           np.asarray(went[name])[:, pos],
                           t[:, 0] / np.maximum(s, np.float32(1e-8))[
                               :, 0, :, None])


# -- the served models -----------------------------------------------------
@pytest.mark.parametrize("arch", QUANT_ARCHS)
def test_quantised_prefill_and_decode_match_reference(arch):
    """Prefill and 4 decode steps: the cache's names, dtypes and shapes
    equal, codes equal (but for near-ties), scales and logits within 1e-4,
    and each step's greedy token equal."""
    jlm, jparams, tlm, tparams, cfg = models(arch, kv_cache_quant=True)
    toks, stubs = inputs(cfg)
    jb, tb = batches(toks, stubs)
    prompt = cfg.vision_tokens + S
    maxlen = max_len(cfg)
    with recorded_quantize() as seen:
        jl, jcache = jax.jit(lambda p, b: jlm.prefill(p, b, maxlen))(
            jparams, jb)
        jstep = jax.jit(jlm.decode_step)
        jlogits = [jl]
        for i in range(EXTRA):
            jl, jcache = jstep(jparams, jcache,
                               jnp.asarray(toks[:, S + i:S + i + 1]),
                               jnp.int32(prompt + i))
            jlogits.append(jl)
        jax.effects_barrier()
    tl, tcache = tlm.prefill(tparams, tb, maxlen)
    tlogits = [tl]
    for i in range(EXTRA):
        tl, tcache = tlm.decode_step(tparams, tcache, torch.from_numpy(
            toks[:, S + i:S + i + 1]), prompt + i)
        tlogits.append(tl)
    for got, want in zip(tlogits, jlogits):
        np.testing.assert_allclose(f32(got), f32(want), **TOL)
        np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                      np.asarray(want).argmax(-1))
    assert layout(tcache) == layout(jcache)
    ratios = ratio_caches(seen, cfg, prompt, EXTRA, maxlen)
    flips = 0
    for key, name, want in leaves(jcache):
        got = tcache[key][name]
        if (key, name) in ratios:
            assert got.dtype == torch.int8
            flips += assert_codes_match(got.numpy(), np.asarray(want),
                                        ratios[key, name])
        else:
            np.testing.assert_allclose(f32(got), f32(want), **TOL)
    print(f"{arch}: {flips} codes one apart at near-ties of {len(seen)} "
          f"quantised tensors")


@pytest.mark.parametrize("arch", QUANT_ARCHS)
def test_quantised_greedy_generate_matches_reference(arch):
    jlm, jparams, tlm, tparams, cfg = models(arch, kv_cache_quant=True)
    toks, stubs = inputs(cfg, seed=1)
    jb, tb = batches(toks, stubs)
    want = JEngine(jlm, jparams, max_len=max_len(cfg)).generate(jb, steps=6)
    got = ServeEngine(tlm, tparams, max_len=max_len(cfg)).generate(tb, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ["whisper-base", "minicpm3-4b"])
def test_the_flag_leaves_cross_and_latent_caches_alone(arch):
    """whisper's ``attn_cross`` and minicpm3's MLA sub-layers are not
    quantised: under the flag the prefill and two decode steps give the
    unflagged caches and logits exactly, as in the reference (whose
    flagged zero cache has the unflagged layout)."""
    _, _, plain, tparams, cfg = models(arch)
    quant = LM(dataclasses.replace(cfg, kv_cache_quant=True))
    jcfg = dataclasses.replace(jconfigs.reduced_config(arch),
                               kv_cache_quant=True)
    toks, stubs = inputs(cfg)
    _, tb = batches(toks, stubs)
    runs = []
    for lm in (plain, quant):
        logits, cache = lm.prefill(tparams, tb, max_len(cfg))
        out = [logits]
        for i in range(2):
            logits, cache = lm.decode_step(tparams, cache, torch.from_numpy(
                toks[:, S + i:S + i + 1]), S + i)
            out.append(logits)
        runs.append((out, cache))
    (want, wcache), (got, gcache) = runs
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert layout(gcache) == layout(wcache)
    for key, name, t in leaves(wcache):
        assert torch.equal(gcache[key][name], t)
    assert layout(quant.init_cache(B, max_len(cfg))) == \
        layout(jbuild(jcfg).init_cache(B, max_len(cfg)))


def test_int8_kv_cache_decode_near_full_precision():
    """The twin of the reference's ``test_int8_kv_cache_decode``: chatglm3
    reduced, int8 against full-precision logits below 0.15 over a prefill
    and 3 decode steps, and the int8 cache under 0.6 of the full one's
    bytes."""
    cfg = tconfigs.reduced_config("chatglm3-6b")
    lm, lm_q = build(cfg), build(dataclasses.replace(cfg,
                                                     kv_cache_quant=True))
    jlm = jbuild(jconfigs.reduced_config("chatglm3-6b"))
    params = convert.lm_params_from_arrays(
        cfg, to_numpy(jlm.init(jax.random.key(0))), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 20)))
    b = {"inputs": toks[:, :16]}
    l0, c0 = lm.prefill(params, b, 28)
    l1, c1 = lm_q.prefill(params, b, 28)
    assert c1["sub0"]["k"].dtype == torch.int8
    errs = [float((l0 - l1).abs().max())]
    for i in range(3):
        t = toks[:, 16 + i:17 + i]
        l0, c0 = lm.decode_step(params, c0, t, 16 + i)
        l1, c1 = lm_q.decode_step(params, c1, t, 16 + i)
        errs.append(float((l0 - l1).abs().max()))
    assert max(errs) < 0.15, errs
    full = sum(t.numel() * t.element_size() for _, _, t in leaves(c0))
    quant = sum(t.numel() * t.element_size() for _, _, t in leaves(c1))
    assert quant < 0.6 * full


# -- the prefill's max_len cache, every family -------------------------------
@pytest.mark.parametrize("arch", list(jconfigs.ARCHS))
def test_prefill_cache_is_the_reference_padded_cache(arch):
    """The prefill's cache has ``max_len`` on every sequence axis and
    equals the reference's padded cache: the prompt's entries within 1e-4,
    exact zeros after them."""
    jlm, jparams, tlm, tparams, cfg = models(arch)
    toks, stubs = inputs(cfg)
    jb, tb = batches(toks, stubs)
    maxlen = max_len(cfg)
    _, jcache = jax.jit(lambda p, b: jlm.prefill(p, b, maxlen))(jparams, jb)
    _, tcache = tlm.prefill(tparams, tb, maxlen)
    assert layout(tcache) == layout(jcache)
    prompt = cfg.vision_tokens + S
    for key, name, want in leaves(jcache):
        got = tcache[key][name]
        assert tuple(got.shape) == want.shape, (key, name)
        if name in tmodel._SEQ_ENTRIES:
            assert got.shape[2] == maxlen
            assert not bool(got[:, :, prompt:].any())
        np.testing.assert_allclose(f32(got), f32(want), **TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["full", "int8"])
def test_prefill_writes_into_one_cache_of_max_len(quant):
    """The cache the prefill returns is the one zero cache it made with
    ``init_cache`` (the same storage), so no stacked or padded copy of it
    is ever made."""
    _, _, tlm, tparams, cfg = models("jamba-1.5-large-398b",
                                     kv_cache_quant=quant)
    made = []
    orig = tlm.init_cache

    def init_cache(*args, **kwargs):
        made.append(orig(*args, **kwargs))
        return made[-1]

    toks, stubs = inputs(cfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tlm, "init_cache", init_cache)
        _, cache = tlm.prefill(tparams, batches(toks, stubs)[1], max_len(cfg))
    assert len(made) == 1
    assert [(k, n, t.data_ptr()) for k, n, t in leaves(cache)] == \
        [(k, n, t.data_ptr()) for k, n, t in leaves(made[0])]
    assert cache["sub0"]["k"].dtype == (torch.int8 if quant
                                        else torch.float32)


def test_prefill_refuses_a_prompt_past_max_len():
    _, _, tlm, tparams, cfg = models("qwen1.5-0.5b")
    toks, _ = inputs(cfg)
    with pytest.raises(ValueError, match="max_len"):
        tlm.prefill(tparams, {"inputs": torch.from_numpy(toks)}, S)


@pytest.mark.parametrize("arch", list(jconfigs.ARCHS))
def test_every_arch_builds_with_the_int8_cache(arch):
    """``LM`` builds with ``kv_cache_quant`` for every arch, and its zero
    cache is the reference's: int8 codes and fp32 scales for each
    self-attention sub-layer, the other entries unchanged."""
    cfg = dataclasses.replace(tconfigs.reduced_config(arch),
                              kv_cache_quant=True)
    jcfg = dataclasses.replace(jconfigs.reduced_config(arch),
                               kv_cache_quant=True)
    got = LM(cfg).init_cache(B, 24)
    assert layout(got) == layout(jbuild(jcfg).init_cache(B, 24))
    assert not any(bool(t.any()) for _, _, t in leaves(got))
    quantised = [m == "attn" and not cfg.mla for m, _ in cfg.layout]
    for i, q in enumerate(quantised):
        assert ("k_s" in got[f"sub{i}"]) == q

