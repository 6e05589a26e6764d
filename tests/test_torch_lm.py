"""The port's LM serving path against the JAX reference's, on the CPU.

The reference makes the weights (``LM.init``); they reach the port as
numpy arrays through ``convert.lm_params_from_arrays`` (bf16 as its
``uint16`` bits), so both packages run the same model.  The reference runs
``jax.jit`` of its model on the CPU; the port runs on CPU tensors, where
prefill attention is the model's chunked attention.

Tolerance: logits at rtol = atol = 1e-4 in fp32 (sums in another order
than XLA's, through a few layers).  In bf16 the two frameworks round at
other places (each fused XLA computation against each torch op), so bf16
logits agree within 5e-2 and greedy tokens are not compared.  The MoE
archs (llama4 scout and maverick) route in fp32 in both packages, and
their routing (``topi`` of every MoE layer) must be equal exactly.
minicpm3's MLA (its reduced sibling has dv = 24 > dh = 16) is held to
the same bounds.  The SSM archs (mamba2, and the jamba hybrid of attention, mamba and top-2
MoE sub-layers) run the SSD scan in fp32 in both packages and are held
to the same bounds.
"""
import contextlib
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import pipeline as jpipe
from repro.models import moe as jmoe
from repro.models.model import build as jbuild
from repro.serve.engine import ServeEngine as JEngine
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.data import pipeline as tpipe
from repro_torch.models import moe as tmoe
from repro_torch.models.model import LM, build
from repro_torch.serve.engine import ServeEngine
from torch_port_util import reference_compiled_here  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["qwen1.5-0.5b", "chatglm3-6b", "codeqwen1.5-7b", "minicpm3-4b",
         "llama4-scout-17b-a16e", "llama4-maverick-400b-a17b",
         "mamba2-1.3b", "jamba-1.5-large-398b"]
MOE_ARCHS = ["llama4-scout-17b-a16e", "llama4-maverick-400b-a17b",
             "jamba-1.5-large-398b"]
SSM_ARCHS = ["mamba2-1.3b", "jamba-1.5-large-398b"]
TOL = dict(rtol=1e-4, atol=1e-4)
B, S, EXTRA = 2, 12, 4
MAXLEN = S + EXTRA + 4


def to_numpy(tree):
    """A reference pytree as numpy; bf16 leaves as their uint16 bits."""
    def leaf(a):
        a = np.asarray(a)
        return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a
    return jax.tree.map(leaf, tree)


def f32(a):
    if torch.is_tensor(a):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def models(arch, dtype="float32"):
    """(reference LM, its params, port LM, carried params, port cfg)."""
    over = dict(param_dtype=dtype, activation_dtype=dtype)
    jcfg = dataclasses.replace(jconfigs.reduced_config(arch), **over)
    tcfg = dataclasses.replace(tconfigs.reduced_config(arch), **over)
    jlm = jbuild(jcfg)
    jparams = jlm.init(jax.random.key(0))
    tparams = convert.lm_params_from_arrays(tcfg, to_numpy(jparams),
                                            device="cpu")
    return jlm, jparams, build(tcfg), tparams, tcfg


def leaves(cache):
    """``(sub-layer, name, tensor)`` of every cache leaf."""
    return [(key, name, t) for key, ent in cache.items()
            for name, t in ent.items()]


def tokens(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, S + EXTRA)).astype(np.int32)


def test_configs_are_the_references():
    assert list(tconfigs.ARCHS) == list(jconfigs.ARCHS)
    for arch in jconfigs.ARCHS:
        for get in ("get_config", "reduced_config"):
            want = dataclasses.asdict(getattr(jconfigs, get)(arch))
            assert dataclasses.asdict(getattr(tconfigs, get)(arch)) == want
        cfg = tconfigs.get_config(arch)
        ref = jconfigs.get_config(arch)
        assert (cfg.vocab_padded, cfg.num_periods, cfg.approx_params(),
                cfg.active_params()) == (ref.vocab_padded, ref.num_periods,
                                         ref.approx_params(),
                                         ref.active_params())
    assert tconfigs.SHAPES == jconfigs.SHAPES
    assert tconfigs.valid_cells() == jconfigs.valid_cells()


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    jlm, jparams, tlm, tparams, cfg = models(arch)
    toks = tokens(cfg)
    jl, jcache = jax.jit(lambda p, b: jlm.prefill(p, b, MAXLEN))(
        jparams, {"inputs": jnp.asarray(toks[:, :S])})
    tl, tcache = tlm.prefill(tparams, {"inputs": torch.from_numpy(
        toks[:, :S])}, MAXLEN)
    assert tl.dtype == torch.float32 and tl.shape == (B, cfg.vocab_padded)
    np.testing.assert_allclose(f32(tl), f32(jl), **TOL)
    assert tcache.keys() == jcache.keys()
    for key, name, want in leaves(jcache):
        assert tcache[key][name].shape == want.shape
        np.testing.assert_allclose(f32(tcache[key][name]), f32(want), **TOL)
    jstep = jax.jit(jlm.decode_step)
    for i in range(EXTRA):
        tok = toks[:, S + i:S + i + 1]
        jl, jcache = jstep(jparams, jcache, jnp.asarray(tok), jnp.int32(S + i))
        tl, tcache = tlm.decode_step(tparams, tcache, torch.from_numpy(tok),
                                     S + i)
        np.testing.assert_allclose(f32(tl), f32(jl), **TOL)
    for key, name, want in leaves(jcache):
        np.testing.assert_allclose(f32(tcache[key][name]), f32(want), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_reference(arch):
    jlm, jparams, tlm, tparams, cfg = models(arch)
    toks = tokens(cfg, seed=1)[:, :S]
    want = JEngine(jlm, jparams, max_len=MAXLEN).generate(
        {"inputs": jnp.asarray(toks)}, steps=6)
    got = ServeEngine(tlm, tparams, max_len=MAXLEN).generate(
        {"inputs": torch.from_numpy(toks)}, steps=6)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill_of_the_longer_prompt(arch):
    """Decode logits at step i equal the prefill logits of the prompt
    extended by those i tokens (the reference's test_decode check)."""
    _, _, tlm, tparams, cfg = models(arch)
    toks = torch.from_numpy(tokens(cfg, seed=2))
    logits, cache = tlm.prefill(tparams, {"inputs": toks[:, :S]}, MAXLEN)
    for i in range(EXTRA):
        ref, _ = tlm.prefill(tparams, {"inputs": toks[:, :S + i]}, MAXLEN)
        np.testing.assert_allclose(f32(logits), f32(ref), **TOL)
        logits, cache = tlm.decode_step(tparams, cache,
                                        toks[:, S + i:S + i + 1], S + i)


@contextlib.contextmanager
def recorded_routing():
    """Both packages' ``_route`` record each call's ``topi`` and its
    smallest top-1/top-2 probability gap, as numpy, into the yielded
    ``{"ref": [...], "port": [...]}``.  The reference is run under
    ``jax.disable_jit()``, so its scan runs eagerly and records values."""
    seen = {"ref": [], "port": []}

    def rec(where, route):
        def run(params, xt, cfg):
            topi, topw, aux = route(params, xt, cfg)
            x32 = np.asarray(f32(xt), np.float64)
            logits = x32 @ np.asarray(f32(params["router"]), np.float64)
            top2 = np.sort(logits, axis=-1)[:, -2:]
            seen[where].append((np.asarray(topi), float(
                (top2[:, 1] - top2[:, 0]).min())))
            return topi, topw, aux
        return run

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmoe, "_route", rec("ref", jmoe._route))
        mp.setattr(tmoe, "_route", rec("port", tmoe._route))
        yield seen


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_routing_matches_reference(arch):
    """Every MoE layer's ``topi`` in prefill and two decode steps equals
    the reference's; a failure names the call and its smallest top-1/
    top-2 logit gap."""
    jlm, jparams, tlm, tparams, cfg = models(arch)
    toks = tokens(cfg, seed=4)
    with recorded_routing() as seen, jax.disable_jit():
        _, jcache = jlm.prefill(jparams, {"inputs": jnp.asarray(
            toks[:, :S])}, MAXLEN)
        _, tcache = tlm.prefill(tparams, {"inputs": torch.from_numpy(
            toks[:, :S])}, MAXLEN)
        for i in range(2):
            tok = toks[:, S + i:S + i + 1]
            _, jcache = jlm.decode_step(jparams, jcache, jnp.asarray(tok),
                                        jnp.int32(S + i))
            tlm.decode_step(tparams, tcache, torch.from_numpy(tok), S + i)
    moe_layers = sum(f == "moe" for _, f in cfg.layout) * cfg.num_periods
    assert len(seen["ref"]) == len(seen["port"]) == 3 * moe_layers
    print(f"{arch}: smallest top-1/top-2 logit gap "
          f"{min(gap for _, gap in seen['ref']):.3e}")
    for n, ((want, gap), (got, _)) in enumerate(zip(seen["ref"],
                                                    seen["port"])):
        np.testing.assert_array_equal(
            got, want, err_msg=f"call {n}: smallest top-1/top-2 logit "
                               f"gap {gap:.3e}")


def test_bf16_prefill_and_decode_near_reference():
    bf16_near_reference("qwen1.5-0.5b")


def test_bf16_moe_prefill_and_decode_near_reference():
    """llama4-scout in bf16: the router stays fp32, and the logits keep
    the dense model's bound."""
    tparams = bf16_near_reference("llama4-scout-17b-a16e")
    ffn = tparams["blocks"][0]["sub0"]["ffn"]
    assert ffn["router"].dtype == torch.float32
    assert ffn["w_gate"].dtype == torch.bfloat16


def bf16_near_reference(arch):
    """Prefill and two decode steps in bf16 against the reference within
    5e-2; returns the port's params."""
    jlm, jparams, tlm, tparams, cfg = models(arch, "bfloat16")
    assert tparams["embed"].dtype == torch.bfloat16
    toks = tokens(cfg, seed=3)
    jl, jcache = jax.jit(lambda p, b: jlm.prefill(p, b, MAXLEN))(
        jparams, {"inputs": jnp.asarray(toks[:, :S])})
    tl, tcache = tlm.prefill(tparams, {"inputs": torch.from_numpy(
        toks[:, :S])}, MAXLEN)
    for _, name, t in leaves(tcache):
        assert t.dtype == (torch.float32 if name == "h" else torch.bfloat16)
    np.testing.assert_allclose(f32(tl), f32(jl), rtol=5e-2, atol=5e-2)
    jstep = jax.jit(jlm.decode_step)
    for i in range(2):
        tok = toks[:, S + i:S + i + 1]
        jl, jcache = jstep(jparams, jcache, jnp.asarray(tok), jnp.int32(S + i))
        tl, tcache = tlm.decode_step(tparams, tcache, torch.from_numpy(tok),
                                     S + i)
        np.testing.assert_allclose(f32(tl), f32(jl), rtol=5e-2, atol=5e-2)
    return tparams


def test_carried_weights_are_bit_equal():
    _, jparams, _, tparams, cfg = models("chatglm3-6b", "bfloat16")
    want = to_numpy(jparams)
    assert len(tparams["blocks"]) == cfg.num_periods
    for p in range(cfg.num_periods):
        got = tparams["blocks"][p]["sub0"]["mixer"]["wq"]
        ref = want["blocks"]["sub0"]["mixer"]["wq"][p]
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy()
                                      .view(np.uint16), ref)
    # fp32 arrays are rounded to the config's bf16 on the way in.
    fp = convert.lm_params_from_arrays(cfg, jax.tree.map(
        lambda a: np.asarray(jnp.asarray(a, jnp.float32)), jparams),
        device="cpu")
    assert torch.equal(fp["embed"], tparams["embed"])
    with pytest.raises(ValueError, match="float32 or uint16"):
        convert.lm_params_from_arrays(cfg, {"embed": np.zeros(3, np.int8),
                                            "blocks": {}}, device="cpu")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_carried_moe_weights_are_bit_equal(arch):
    """Every leaf of a bf16 MoE model carries bit for bit; the router
    arrives and stays fp32, and so it does when every leaf comes as fp32."""
    _, jparams, _, tparams, cfg = models(arch, "bfloat16")
    want = to_numpy(jparams)
    for p in range(cfg.num_periods):
        for i, (_, ffn) in enumerate(cfg.layout):
            got_ffn = tparams["blocks"][p][f"sub{i}"]["ffn"]
            ref_ffn = want["blocks"][f"sub{i}"]["ffn"]
            assert got_ffn.keys() == ref_ffn.keys()
            assert ("router" in got_ffn) == (ffn == "moe")
            for name, ref in ref_ffn.items():
                got = got_ffn[name]
                if name == "router":
                    assert ref.dtype == np.float32
                    assert got.dtype == torch.float32
                    np.testing.assert_array_equal(got.numpy(), ref[p])
                else:
                    assert got.dtype == torch.bfloat16
                    np.testing.assert_array_equal(
                        got.view(torch.int16).numpy().view(np.uint16),
                        ref[p])
    fp = convert.lm_params_from_arrays(cfg, jax.tree.map(
        lambda a: np.asarray(jnp.asarray(a, jnp.float32)), jparams),
        device="cpu")
    sub = f"sub{[f for _, f in cfg.layout].index('moe')}"
    moe = fp["blocks"][0][sub]["ffn"]
    assert moe["router"].dtype == torch.float32
    assert torch.equal(moe["router"],
                       tparams["blocks"][0][sub]["ffn"]["router"])
    assert torch.equal(moe["w_up"], tparams["blocks"][0][sub]["ffn"]["w_up"])


def test_carried_weights_default_to_the_card():
    """Without ``device`` the weights go to CUDA: without a card that
    raises, and nothing lands on the CPU unless the caller asks for it."""
    cfg = tconfigs.reduced_config("qwen1.5-0.5b")
    tree = {"embed": np.ones((4, 2), np.float32), "blocks": {}}
    if torch.cuda.is_available():
        assert convert.lm_params_from_arrays(cfg, tree)["embed"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            convert.lm_params_from_arrays(cfg, tree)
    got = convert.lm_params_from_arrays(cfg, tree, device="cpu")
    assert got["embed"].device.type == "cpu"


def test_sampled_generate_uses_the_generator():
    _, _, tlm, tparams, cfg = models("qwen1.5-0.5b")
    eng = ServeEngine(tlm, tparams, max_len=MAXLEN)
    batch = {"inputs": torch.from_numpy(tokens(cfg)[:, :S])}
    runs = [eng.generate(batch, 5, temperature=1.0,
                         generator=torch.Generator().manual_seed(s))
            for s in (7, 7, 8)]
    assert torch.equal(runs[0], runs[1])
    assert runs[0].shape == (B, 5)
    assert int(runs[0].max()) < cfg.vocab_size


def test_init_cache_has_the_prefill_layout():
    _, _, tlm, tparams, cfg = models("chatglm3-6b")
    _, cache = tlm.prefill(tparams, {"inputs": torch.zeros(
        (B, S), dtype=torch.int64)}, MAXLEN)
    zero = tlm.init_cache(B, MAXLEN)
    assert zero.keys() == cache.keys()
    for name in ("k", "v"):
        assert zero["sub0"][name].shape == cache["sub0"][name].shape
        assert zero["sub0"][name].dtype == cache["sub0"][name].dtype
        assert not bool(zero["sub0"][name].any())


@pytest.mark.parametrize("arch", ["chatglm3-6b", "minicpm3-4b"] + SSM_ARCHS)
def test_init_cache_matches_the_reference(arch):
    """``init_cache`` has the reference's entries, key, shape and dtype,
    in fp32 and bf16, and the prefill's layout; it is all zeros."""
    jlm, jparams, tlm, tparams, cfg = models(arch)
    for dt, jdt in ((None, None), (torch.bfloat16, jnp.bfloat16)):
        want = jlm.init_cache(B, MAXLEN, jdt)
        got = tlm.init_cache(B, MAXLEN, dt)
        assert got.keys() == want.keys()
        for key, name, ref in leaves(want):
            t = got[key][name]
            assert tuple(t.shape) == ref.shape, (key, name)
            assert str(t.dtype).removeprefix("torch.") == str(ref.dtype)
            assert not bool(t.any())
    _, cache = tlm.prefill(tparams, {"inputs": torch.zeros(
        (B, S), dtype=torch.int64)}, MAXLEN)
    zero = tlm.init_cache(B, MAXLEN)
    assert [(k, n, t.shape, t.dtype) for k, n, t in leaves(zero)] == \
        [(k, n, t.shape, t.dtype) for k, n, t in leaves(cache)]


def assert_carried_bit_equal(jparams, tparams, cfg) -> set:
    """Every block leaf of a bf16 model carries bit for bit, key for key;
    those in ``convert.FP32_LEAVES`` arrive and stay fp32.  Returns the
    names of the fp32 leaves seen."""
    want = to_numpy(jparams)
    seen = set()
    for p in range(cfg.num_periods):
        def walk(got, ref, path):
            assert got.keys() == ref.keys(), path
            for name, r in ref.items():
                if isinstance(r, dict):
                    walk(got[name], r, path + (name,))
                    continue
                g = got[name]
                if name in convert.FP32_LEAVES:
                    seen.add(name)
                    assert r.dtype == np.float32 and g.dtype == torch.float32
                    np.testing.assert_array_equal(g.numpy(), r[p])
                else:
                    assert g.dtype == torch.bfloat16, path + (name,)
                    np.testing.assert_array_equal(
                        g.view(torch.int16).numpy().view(np.uint16), r[p])
        walk(tparams["blocks"][p], want["blocks"], ())
    return seen


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_carried_ssm_weights_are_bit_equal(arch):
    """Every leaf of a bf16 SSM model carries bit for bit; ``a_log``,
    ``dt_bias`` and ``d_skip`` arrive and stay fp32, as the router does."""
    _, jparams, _, tparams, cfg = models(arch, "bfloat16")
    seen = assert_carried_bit_equal(jparams, tparams, cfg)
    assert {"a_log", "dt_bias", "d_skip"} <= seen


def test_carried_mla_weights_are_bit_equal():
    """minicpm3's MLA leaves (``wq_a``, ``q_norm``, ``wq_b``, ``wkv_a``,
    ``kv_norm``, ``wkv_b``, ``wo``) carry bit for bit in bf16, none fp32."""
    _, jparams, _, tparams, cfg = models("minicpm3-4b", "bfloat16")
    assert not assert_carried_bit_equal(jparams, tparams, cfg)
    assert sorted(tparams["blocks"][0]["sub0"]["mixer"]) == sorted(
        ["wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wkv_b", "wo"])


def test_bf16_mla_prefill_and_decode_near_reference():
    """minicpm3 in bf16 keeps the dense model's bound; the latent cache is
    bf16."""
    tparams = bf16_near_reference("minicpm3-4b")
    assert tparams["blocks"][0]["sub0"]["mixer"]["wkv_b"].dtype == \
        torch.bfloat16


def test_bf16_ssm_prefill_and_decode_near_reference():
    """mamba2 in bf16 keeps the dense model's bound; the SSM's decay, step
    bias and skip and its state stay fp32."""
    tparams = bf16_near_reference("mamba2-1.3b")
    mixer = tparams["blocks"][0]["sub0"]["mixer"]
    assert mixer["a_log"].dtype == torch.float32
    assert mixer["wx"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_bf16_ssm_no_farther_from_fp32_than_the_reference(arch):
    """Each package's bf16 logits (prefill and two decode steps) against
    the reference's fp32 run of the same bf16 weights: the port's distance,
    in norm, stays within 1.5x the reference's own.  (In jamba's eight
    sub-layers both land about 2e-2 from fp32 in norm, 0.06 at most, so
    the dense model's 5e-2 between the two does not hold there.)"""
    jlm, jparams, tlm, tparams, cfg = models(arch, "bfloat16")
    j32 = build_ref32(cfg)
    p32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jparams)
    toks = tokens(cfg, seed=3)
    runs = {}
    for name, lm, params, prefill, step in (
            ("ref", jlm, jparams, jax.jit(lambda p, b: jlm.prefill(
                p, b, MAXLEN)), jax.jit(jlm.decode_step)),
            ("fp32", j32, p32, jax.jit(lambda p, b: j32.prefill(
                p, b, MAXLEN)), jax.jit(j32.decode_step))):
        lg, c = prefill(params, {"inputs": jnp.asarray(toks[:, :S])})
        out = [f32(lg)]
        for i in range(2):
            lg, c = step(params, c, jnp.asarray(toks[:, S + i:S + i + 1]),
                         jnp.int32(S + i))
            out.append(f32(lg))
        runs[name] = out
    tl, tc = tlm.prefill(tparams, {"inputs": torch.from_numpy(
        toks[:, :S])}, MAXLEN)
    runs["port"] = [f32(tl)]
    for i in range(2):
        tl, tc = tlm.decode_step(tparams, tc, torch.from_numpy(
            toks[:, S + i:S + i + 1]), S + i)
        runs["port"].append(f32(tl))
    for got, ref, want in zip(runs["port"], runs["ref"], runs["fp32"]):
        d_port = np.linalg.norm(got - want) / np.linalg.norm(want)
        d_ref = np.linalg.norm(ref - want) / np.linalg.norm(want)
        assert d_port <= 1.5 * d_ref, (d_port, d_ref)


def build_ref32(cfg):
    return jbuild(dataclasses.replace(jconfigs.reduced_config(cfg.arch_id),
                                      param_dtype="float32",
                                      activation_dtype="float32"))


def test_ssm_decode_crosses_a_chunk_boundary():
    """Reduced mamba2 (chunk 16): a 15-token prefill decoded through
    positions 15-17 matches the prefills of 16-18 tokens, the first of
    which fills the chunk and the others pad a second one."""
    _, _, tlm, tparams, cfg = models("mamba2-1.3b")
    assert cfg.ssm.chunk_size == 16
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, 18)))
    logits, cache = tlm.prefill(tparams, {"inputs": toks[:, :15]}, MAXLEN)
    for pos in range(15, 18):
        logits, cache = tlm.decode_step(tparams, cache,
                                        toks[:, pos:pos + 1], pos)
        ref, _ = tlm.prefill(tparams, {"inputs": toks[:, :pos + 1]}, MAXLEN)
        np.testing.assert_allclose(f32(logits), f32(ref), **TOL)


def test_random_init_from_a_generator():
    cfg = tconfigs.reduced_config("codeqwen1.5-7b")
    lm = LM(cfg)
    a = lm.init(torch.Generator().manual_seed(0))
    b = lm.init(torch.Generator().manual_seed(0))
    assert torch.equal(a["blocks"][1]["sub0"]["ffn"]["w_up"],
                       b["blocks"][1]["sub0"]["ffn"]["w_up"])
    assert ("lm_head" in a) == (not cfg.tie_embeddings)
    assert a["embed"].shape == (cfg.vocab_padded, cfg.d_model)


def test_unported_options_raise():
    """The int8 KV cache is ported: the flag builds and serves
    (tests/test_torch_kv_int8.py holds it to the reference).  The
    multi-GPU options still raise."""
    _, _, _, tparams, cfg = models("chatglm3-6b")
    quant = LM(dataclasses.replace(cfg, kv_cache_quant=True))
    out = ServeEngine(quant, tparams, max_len=MAXLEN).generate(
        {"inputs": torch.from_numpy(tokens(cfg)[:, :S])}, 3)
    assert out.shape == (B, 3) and int(out.max()) < cfg.vocab_size
    assert quant.init_cache(B, MAXLEN)["sub0"]["k"].dtype == torch.int8
    lm = LM(cfg)
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        ServeEngine(lm, {}, 8, mesh=object())
    # Training is ported (tests/test_torch_train.py); sharded training is
    # not.
    from repro_torch.train.trainer import TrainConfig, Trainer
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        Trainer(lm, None, TrainConfig(), mesh=object(), device="cpu")


@pytest.mark.parametrize("step", [0, 3])
def test_synthetic_data_matches_reference(step):
    cfg = tconfigs.reduced_config("paligemma-3b")
    want = jpipe.add_modality_stubs(
        jpipe.SyntheticLM(512, 16, 3, seed=5).batch_at(step), cfg, step)
    got = tpipe.add_modality_stubs(
        tpipe.SyntheticLM(512, 16, 3, seed=5).batch_at(step), cfg, step)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.is_tensor(got[k])
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def launch(*args, cuda_visible=None):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    if cuda_visible is not None:
        env["CUDA_VISIBLE_DEVICES"] = cuda_visible
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300)


def served_on_the_cpu(arch):
    proc = launch("--arch", arch, "--reduced", "--device", "cpu",
                  "--batch", "2", "--prompt-len", "8", "--gen", "4")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "generated (2, 4) tokens" in proc.stdout
    assert proc.stdout.count("req ") == 2


def test_serve_launcher_on_the_cpu():
    served_on_the_cpu("qwen1.5-0.5b")


def test_moe_serve_launcher_on_the_cpu():
    served_on_the_cpu("llama4-scout-17b-a16e")


def test_ssm_serve_launcher_on_the_cpu():
    served_on_the_cpu("mamba2-1.3b")


def test_mla_serve_launcher_on_the_cpu():
    served_on_the_cpu("minicpm3-4b")


def test_serve_launcher_refuses_without_a_card():
    proc = launch("--arch", "qwen1.5-0.5b", "--reduced", cuda_visible="")
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "generated" not in proc.stdout
