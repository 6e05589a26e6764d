"""The port's dense LM serving path against the JAX reference's, on the CPU.

The reference makes the weights (``LM.init``); they reach the port as
numpy arrays through ``convert.lm_params_from_arrays`` (bf16 as its
``uint16`` bits), so both packages run the same model.  The reference runs
``jax.jit`` of its model on the CPU; the port runs on CPU tensors, where
prefill attention is the model's chunked attention.

Tolerance: logits at rtol = atol = 1e-4 in fp32 (sums in another order
than XLA's, through a few layers).  In bf16 the two frameworks round at
other places (each fused XLA computation against each torch op), so bf16
logits agree within 5e-2 and greedy tokens are not compared.
"""
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
from repro.models.model import build as jbuild
from repro.serve.engine import ServeEngine as JEngine
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.data import pipeline as tpipe
from repro_torch.models.model import LM, build
from repro_torch.serve.engine import ServeEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["qwen1.5-0.5b", "chatglm3-6b", "codeqwen1.5-7b"]
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
    tparams = convert.lm_params_from_arrays(tcfg, to_numpy(jparams))
    return jlm, jparams, build(tcfg), tparams, tcfg


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
    for name in ("k", "v"):
        assert tcache["sub0"][name].shape == jcache["sub0"][name].shape
        np.testing.assert_allclose(f32(tcache["sub0"][name]),
                                   f32(jcache["sub0"][name]), **TOL)
    jstep = jax.jit(jlm.decode_step)
    for i in range(EXTRA):
        tok = toks[:, S + i:S + i + 1]
        jl, jcache = jstep(jparams, jcache, jnp.asarray(tok), jnp.int32(S + i))
        tl, tcache = tlm.decode_step(tparams, tcache, torch.from_numpy(tok),
                                     S + i)
        np.testing.assert_allclose(f32(tl), f32(jl), **TOL)
    np.testing.assert_allclose(f32(tcache["sub0"]["k"]),
                               f32(jcache["sub0"]["k"]), **TOL)


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


def test_bf16_prefill_and_decode_near_reference():
    jlm, jparams, tlm, tparams, cfg = models("qwen1.5-0.5b", "bfloat16")
    assert tparams["embed"].dtype == torch.bfloat16
    toks = tokens(cfg, seed=3)
    jl, jcache = jax.jit(lambda p, b: jlm.prefill(p, b, MAXLEN))(
        jparams, {"inputs": jnp.asarray(toks[:, :S])})
    tl, tcache = tlm.prefill(tparams, {"inputs": torch.from_numpy(
        toks[:, :S])}, MAXLEN)
    assert tcache["sub0"]["k"].dtype == torch.bfloat16
    np.testing.assert_allclose(f32(tl), f32(jl), rtol=5e-2, atol=5e-2)
    jstep = jax.jit(jlm.decode_step)
    for i in range(2):
        tok = toks[:, S + i:S + i + 1]
        jl, jcache = jstep(jparams, jcache, jnp.asarray(tok), jnp.int32(S + i))
        tl, tcache = tlm.decode_step(tparams, tcache, torch.from_numpy(tok),
                                     S + i)
        np.testing.assert_allclose(f32(tl), f32(jl), rtol=5e-2, atol=5e-2)


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
        lambda a: np.asarray(jnp.asarray(a, jnp.float32)), jparams))
    assert torch.equal(fp["embed"], tparams["embed"])
    with pytest.raises(ValueError, match="float32 or uint16"):
        convert.lm_params_from_arrays(cfg, {"embed": np.zeros(3, np.int8),
                                            "blocks": {}})


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


def test_random_init_from_a_generator():
    cfg = tconfigs.reduced_config("codeqwen1.5-7b")
    lm = LM(cfg)
    a = lm.init(torch.Generator().manual_seed(0))
    b = lm.init(torch.Generator().manual_seed(0))
    assert torch.equal(a["blocks"][1]["sub0"]["ffn"]["w_up"],
                       b["blocks"][1]["sub0"]["ffn"]["w_up"])
    assert ("lm_head" in a) == (not cfg.tie_embeddings)
    assert a["embed"].shape == (cfg.vocab_padded, cfg.d_model)


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "mamba2-1.3b",
                                  "minicpm3-4b", "whisper-base",
                                  "paligemma-3b", "jamba-1.5-large-398b",
                                  "llama4-maverick-400b-a17b"])
def test_unported_families_raise_at_construction(arch):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        LM(tconfigs.reduced_config(arch))


def test_unported_options_raise():
    cfg = tconfigs.reduced_config("chatglm3-6b")
    with pytest.raises(NotImplementedError, match="int8"):
        LM(dataclasses.replace(cfg, kv_cache_quant=True))
    lm = LM(cfg)
    with pytest.raises(NotImplementedError, match="training"):
        lm.loss({}, {})
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        ServeEngine(lm, {}, 8, mesh=object())


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


def test_serve_launcher_on_the_cpu():
    proc = launch("--arch", "qwen1.5-0.5b", "--reduced", "--device", "cpu",
                  "--batch", "2", "--prompt-len", "8", "--gen", "4")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "generated (2, 4) tokens" in proc.stdout
    assert proc.stdout.count("req ") == 2


def test_serve_launcher_refuses_without_a_card():
    proc = launch("--arch", "qwen1.5-0.5b", "--reduced", cuda_visible="")
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "generated" not in proc.stdout
