"""The port's Whisper encoder-decoder (the encoder, cross-attention and
their decode cache) against the JAX reference's, on the CPU.

Reduced whisper-base (d 64, 4 heads of 16 over 2 KV heads, 2 encoder and
2 decoder layers, ``encoder_seq`` 24) in both packages.  The reference's
functions run as XLA on the CPU (its model under ``jax.jit``); the port's
on CPU tensors, where attention is the model's chunked attention.  The
same numpy inputs, made from a seed, go to both, and the reference's
``LM.init`` weights reach the port through
``convert.lm_params_from_arrays``.

Tolerance, fp32: rtol = atol = 1e-5 for ``cross_attn_forward``,
``_cross_kv``, ``_cross_decode``, ``_encode`` and the prefill's ``xk``/
``xv`` (the same products summed in another order); 1e-4 for logits
(through every layer and the vocabulary projection), as
``tests/test_torch_lm.py`` holds the decoders.  bf16 logits within 5e-2
(each framework rounds at its own points).  Greedy tokens are equal.

Two controls must fail the fp32 checks: the encoder run causal, and the
cross-attention run causal.
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
from torch.utils._pytree import tree_leaves, tree_map

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.models.model import build as jbuild
from repro.serve.engine import ServeEngine as JEngine
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.models.model import LM, build
from repro_torch.serve.engine import ServeEngine
from torch_port_util import reference_compiled_here  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "whisper-base"
TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
B, S, EXTRA = 2, 12, 4
MAXLEN = S + EXTRA + 4
# ``_encode`` past one key block and one query chunk of the reduced
# config (attn_chunk 32): 40 frames in blocks of 16 keys, the last ragged.
LONG = dict(encoder_seq=40, attn_kv_block=16)


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


def cfgs(dtype="float32", **over):
    """Reduced whisper-base in both packages (reference, port)."""
    over = dict(param_dtype=dtype, activation_dtype=dtype, **over)
    return [dataclasses.replace(mod.reduced_config(ARCH), **over)
            for mod in (jconfigs, tconfigs)]


def models(dtype="float32", **over):
    """(reference LM, its params, port LM, carried params, port cfg)."""
    jcfg, tcfg = cfgs(dtype, **over)
    jlm = jbuild(jcfg)
    jparams = jlm.init(jax.random.key(0))
    tparams = convert.lm_params_from_arrays(tcfg, to_numpy(jparams),
                                            device="cpu")
    return jlm, jparams, build(tcfg), tparams, tcfg


def inputs(cfg, seed=0):
    """(tokens (B, S + EXTRA), frames (B, encoder_seq, D)) as numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + EXTRA)).astype(np.int32)
    frames = rng.normal(size=(B, cfg.encoder_seq, cfg.d_model))
    return toks, frames.astype(np.float32)


def batches(toks, frames, n=S):
    """The same prompt as a reference batch and a port batch."""
    return ({"inputs": jnp.asarray(toks[:, :n]),
             "frames": jnp.asarray(frames)},
            {"inputs": torch.from_numpy(toks[:, :n]),
             "frames": torch.from_numpy(frames)})


def cross_weights(cfg, seed=0):
    """Seeded numpy weights of ``attn_init(cross=True)``'s shapes."""
    rng = np.random.default_rng(seed)
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    shapes = {"wq": (d, qd), "wk": (d, kvd), "wv": (d, kvd), "wo": (qd, d),
              "xwq": (d, qd), "xwk": (d, kvd), "xwv": (d, kvd),
              "xwo": (qd, d)}
    return {n: (rng.normal(size=s) * s[0] ** -0.5).astype(np.float32)
            for n, s in shapes.items()}


def both(tree):
    return ({n: jnp.asarray(a) for n, a in tree.items()},
            {n: torch.from_numpy(a) for n, a in tree.items()})


def close(got, want, tol=TOL):
    np.testing.assert_allclose(f32(got), f32(want), **tol)


def far(got, want, tol=TOL):
    """``got`` fails ``close`` at ``tol`` (a control)."""
    with pytest.raises(AssertionError):
        close(got, want, tol)


# -- the functions, one by one ----------------------------------------------
@pytest.mark.parametrize("sq", [1, S, 40])
def test_cross_attn_forward_matches_reference(sq):
    """Prompts of 1, 12 and 40 tokens (40 crosses the reduced config's
    32-row q chunk) over 24 frames, non-causal: the causal control (the
    last prompt row would see one frame per row) must fail."""
    jcfg, tcfg = cfgs()
    jp, tp = both(cross_weights(tcfg, 1))
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, sq, tcfg.d_model)).astype(np.float32)
    enc = rng.normal(size=(B, tcfg.encoder_seq, tcfg.d_model)).astype(
        np.float32)
    want = jattn.cross_attn_forward(jp, jnp.asarray(x), jnp.asarray(enc),
                                    jcfg)
    tx = torch.from_numpy(x)
    kv = tmodel._cross_kv(tp, torch.from_numpy(enc), tcfg)
    got = tattn.cross_attn_forward(tp, tx, kv, tcfg)
    close(got, want)
    orig = tattn.chunked_attention
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tattn, "chunked_attention",
                   lambda *a, **k: orig(*a, **dict(k, causal=True)))
        ctl = tattn.cross_attn_forward(tp, tx, kv, tcfg)
    far(ctl, want)


def test_cross_kv_matches_reference():
    jcfg, tcfg = cfgs()
    jp, tp = both(cross_weights(tcfg, 3))
    enc = np.random.default_rng(4).normal(
        size=(B, tcfg.encoder_seq, tcfg.d_model)).astype(np.float32)
    want = jmodel._cross_kv(jp, jnp.asarray(enc), jcfg)
    got = tmodel._cross_kv(tp, torch.from_numpy(enc), tcfg)
    assert got.keys() == want.keys() == {"xk", "xv"}
    for name in want:
        assert tuple(got[name].shape) == want[name].shape == (
            B, tcfg.encoder_seq, tcfg.num_kv_heads, tcfg.head_dim)
        close(got[name], want[name])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_decode_matches_reference(dtype):
    """One token over a cache of 24 frames.  In bf16 the scores are fp32
    from bf16 operands and P is rounded to bf16 before P·V, in both
    packages: the outputs agree within 2e-2."""
    jcfg, tcfg = cfgs(dtype)
    w = cross_weights(tcfg, 5)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(B, 1, tcfg.d_model)).astype(np.float32)
    shape = (B, tcfg.encoder_seq, tcfg.num_kv_heads, tcfg.head_dim)
    ent = {n: rng.normal(size=shape).astype(np.float32)
           for n in ("xk", "xv")}
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16

    def j(tree):
        return {n: jnp.asarray(a, jdt) for n, a in tree.items()}

    def t(tree):
        return {n: torch.from_numpy(a).to(tdt) for n, a in tree.items()}

    want = jmodel._cross_decode(j(w), jnp.asarray(x, jdt), j(ent), jcfg)
    got = tmodel._cross_decode(t(w), torch.from_numpy(x).to(tdt), t(ent),
                               tcfg)
    assert got.dtype == tdt and tuple(got.shape) == (B, 1, tcfg.d_model)
    close(got, want, TOL if dtype == "float32" else
          dict(rtol=2e-2, atol=2e-2))


@pytest.mark.parametrize("over", [{}, LONG], ids=["reduced", "kv-blocks"])
def test_encode_matches_reference(over):
    """``_encode`` over the frames: non-causal self-attention with RoPE
    at 0..Se-1 in every layer.  ``kv-blocks`` runs 40 frames in 16-key
    blocks, so the reference's online softmax crosses a key block.  The
    causal control must fail."""
    jlm, jparams, tlm, tparams, cfg = models(**over)
    frames = np.random.default_rng(7).normal(
        size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    want = jax.jit(jlm._encode)(jparams, jnp.asarray(frames))
    got = tlm._encode(tparams, torch.from_numpy(frames))
    assert tuple(got.shape) == (B, cfg.encoder_seq, cfg.d_model)
    close(got, want)
    orig = tattn.attn_forward
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tattn, "attn_forward",
                   lambda *a, **k: orig(*a, **dict(k, causal=True)))
        ctl = tlm._encode(tparams, torch.from_numpy(frames))
    far(ctl, want)


# -- the model ----------------------------------------------------------------
def test_prefill_and_decode_match_reference():
    """Prefill logits within 1e-4 and every cache leaf in the reference's
    shape, ``xk``/``xv`` within 1e-5 and self K/V within 1e-4; then four
    decode steps' logits within 1e-4."""
    jlm, jparams, tlm, tparams, cfg = models()
    toks, frames = inputs(cfg)
    jb, tb = batches(toks, frames)
    jl, jcache = jax.jit(lambda p, b: jlm.prefill(p, b, MAXLEN))(jparams, jb)
    tl, tcache = tlm.prefill(tparams, tb, MAXLEN)
    assert tl.dtype == torch.float32 and tl.shape == (B, cfg.vocab_padded)
    close(tl, jl, LOGIT_TOL)
    assert tcache.keys() == jcache.keys()
    for key, ent in jcache.items():
        assert tcache[key].keys() == ent.keys() == {"k", "v", "xk", "xv"}
        for name, want in ent.items():
            assert tuple(tcache[key][name].shape) == want.shape
            close(tcache[key][name], want,
                  TOL if name in ("xk", "xv") else LOGIT_TOL)
    jstep = jax.jit(jlm.decode_step)
    for i in range(EXTRA):
        tok = toks[:, S + i:S + i + 1]
        jl, jcache = jstep(jparams, jcache, jnp.asarray(tok), jnp.int32(S + i))
        tl, tcache = tlm.decode_step(tparams, tcache, torch.from_numpy(tok),
                                     S + i)
        close(tl, jl, LOGIT_TOL)


def test_greedy_generate_matches_reference():
    jlm, jparams, tlm, tparams, cfg = models()
    toks, frames = inputs(cfg, seed=1)
    jb, tb = batches(toks, frames)
    want = JEngine(jlm, jparams, max_len=MAXLEN).generate(jb, steps=8)
    got = ServeEngine(tlm, tparams, max_len=MAXLEN).generate(tb, steps=8)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bf16_prefill_and_decode_near_reference():
    jlm, jparams, tlm, tparams, cfg = models("bfloat16")
    toks, frames = inputs(cfg, seed=3)
    jb, tb = batches(toks, frames)
    jl, jcache = jax.jit(lambda p, b: jlm.prefill(p, b, MAXLEN))(jparams, jb)
    tl, tcache = tlm.prefill(tparams, tb, MAXLEN)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(tcache))
    tol = dict(rtol=5e-2, atol=5e-2)
    close(tl, jl, tol)
    jstep = jax.jit(jlm.decode_step)
    for i in range(2):
        tok = toks[:, S + i:S + i + 1]
        jl, jcache = jstep(jparams, jcache, jnp.asarray(tok), jnp.int32(S + i))
        tl, tcache = tlm.decode_step(tparams, tcache, torch.from_numpy(tok),
                                     S + i)
        close(tl, jl, tol)


def test_decode_matches_prefill_of_the_longer_prompt():
    """Decode at step i equals the prefill of the prompt extended by
    those i tokens over the same frames; decoding with the cache's ``xk``
    zeroed (the control) does not."""
    _, _, tlm, tparams, cfg = models()
    toks, frames = inputs(cfg, seed=2)
    t, fr = torch.from_numpy(toks), torch.from_numpy(frames)
    logits, cache = tlm.prefill(tparams, {"inputs": t[:, :S],
                                          "frames": fr}, MAXLEN)
    for i in range(EXTRA):
        ref, _ = tlm.prefill(tparams, {"inputs": t[:, :S + i],
                                       "frames": fr}, MAXLEN)
        close(logits, ref, LOGIT_TOL)
        logits, cache = tlm.decode_step(tparams, cache, t[:, S + i:S + i + 1],
                                        S + i)
    _, cache = tlm.prefill(tparams, {"inputs": t[:, :S], "frames": fr},
                           MAXLEN)
    cache["sub0"]["xk"].zero_()
    ctl, _ = tlm.decode_step(tparams, cache, t[:, S:S + 1], S)
    ref, _ = tlm.prefill(tparams, {"inputs": t[:, :S + 1], "frames": fr},
                         MAXLEN)
    far(ctl, ref, LOGIT_TOL)


def test_init_cache_matches_the_reference():
    """``init_cache`` has the reference's entries, shapes and dtypes in
    fp32 and bf16, all zeros, and the prefill's layout: ``xk``/``xv`` at
    ``encoder_seq``, which the prefill does not pad to ``max_len``."""
    jlm, _, tlm, tparams, cfg = models()
    for dt, jdt in ((None, None), (torch.bfloat16, jnp.bfloat16)):
        want = jlm.init_cache(B, MAXLEN, jdt)
        got = tlm.init_cache(B, MAXLEN, dt)
        assert got.keys() == want.keys()
        for key, ent in want.items():
            assert got[key].keys() == ent.keys()
            for name, ref in ent.items():
                t = got[key][name]
                assert tuple(t.shape) == ref.shape, (key, name)
                assert str(t.dtype).removeprefix("torch.") == str(ref.dtype)
                assert not bool(t.any())
    toks, frames = inputs(cfg)
    _, cache = tlm.prefill(tparams, batches(toks, frames)[1], MAXLEN)
    zero = tlm.init_cache(B, MAXLEN)
    assert {(k, n): (t.shape, t.dtype) for k, e in zero.items()
            for n, t in e.items()} == \
        {(k, n): (t.shape, t.dtype) for k, e in cache.items()
         for n, t in e.items()}
    assert cache["sub0"]["xk"].shape[2] == cfg.encoder_seq
    assert cache["sub0"]["k"].shape[2] == MAXLEN


def test_pad_cache_seq_leaves_the_frames():
    """The prefill's ``_write_period`` puts a period's self K at
    ``[p, :, :S]`` of the ``max_len`` cache and its frames' ``xk`` whole
    at ``[p]``: the frames keep ``encoder_seq``."""
    _, _, tlm, _, cfg = models()
    cache = tlm.init_cache(B, MAXLEN)
    ent = {"sub0": {
        "k": torch.ones(B, S, cfg.num_kv_heads, cfg.head_dim),
        "xk": torch.ones(B, cfg.encoder_seq, cfg.num_kv_heads,
                         cfg.head_dim)}}
    tmodel._write_period(cache, 1, ent)
    out = cache["sub0"]
    assert out["k"].shape[2] == MAXLEN and not bool(out["k"][:, :, S:].any())
    assert bool(out["k"][1, :, :S].all()) and not bool(out["k"][0].any())
    assert out["xk"].shape[2] == cfg.encoder_seq
    assert bool(out["xk"][1].all()) and not bool(out["xk"][0].any())


def test_converter_unstacks_the_encoder():
    """The reference's layer-stacked ``encoder`` arrives as one dict per
    layer, bit for bit in bf16, beside the cross-attention weights and
    ``norm_cross`` of each period."""
    _, jparams, _, tparams, cfg = models("bfloat16")
    want = to_numpy(jparams)
    assert isinstance(tparams["encoder"], list)
    assert len(tparams["encoder"]) == cfg.encoder_layers == 2
    for i, layer in enumerate(tparams["encoder"]):
        ref = jax.tree.map(lambda a: a[i], want["encoder"])
        assert jax.tree.structure(ref) == jax.tree.structure(
            tree_map(lambda t: 0, layer))
        for got, r in zip(tree_leaves(layer), jax.tree.leaves(ref)):
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                got.view(torch.int16).numpy().view(np.uint16), r)
    assert tparams["enc_final_norm"].shape == (cfg.d_model,)
    for p in range(cfg.num_periods):
        sub = tparams["blocks"][p]["sub0"]
        assert sorted(sub) == ["ffn", "mixer", "norm_cross", "norm_ffn",
                               "norm_in"]
        for name in ("xwq", "xwk", "xwv", "xwo"):
            np.testing.assert_array_equal(
                sub["mixer"][name].view(torch.int16).numpy().view(np.uint16),
                want["blocks"]["sub0"]["mixer"][name][p])


def test_random_init_has_the_reference_tree():
    """The port's own seeded init makes the reference's tree, stacks as
    lists, with the reference's shapes and dtypes."""
    jcfg, tcfg = cfgs("bfloat16")
    want = jax.eval_shape(jbuild(jcfg).init, jax.random.key(0))
    got = LM(tcfg).init(torch.Generator().manual_seed(0))
    assert got.keys() == want.keys()
    for name in ("blocks", "encoder"):
        n = len(got[name])
        assert n == (tcfg.num_periods if name == "blocks" else
                     tcfg.encoder_layers)
        for i in range(n):
            ref = jax.tree.map(lambda a: (a.shape[1:], str(a.dtype)),
                               want[name])
            mine = tree_map(lambda t: (tuple(t.shape), str(t.dtype)
                                       .removeprefix("torch.")), got[name][i])
            assert mine == ref
    assert got["lm_head"].shape == (tcfg.d_model, tcfg.vocab_padded)


def test_the_card_path_runs_the_kernel_three_times_a_layer():
    """Off the CPU the prefill hands every attention to the flash kernel:
    per encoder layer one non-causal (Se, Se) call, per decoder layer one
    causal (S, S) self and one non-causal (S, Se) cross call, each on
    contiguous tensors (the wrapper refuses others).  Run on the ``meta``
    device with the kernel's wrapper recording its calls."""
    _, _, tlm, tparams, cfg = models()
    calls = []

    def record(q, k, v, *, causal=True, prefix_len=0):
        assert q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
        assert prefix_len == 0
        calls.append((q.shape[1], k.shape[1], causal))
        b, sq, kvh, g, _ = q.shape
        return torch.empty((b, sq, kvh, g, v.shape[-1]), dtype=q.dtype,
                           device=q.device)

    meta = tree_map(lambda t: t.to("meta"), tparams)
    toks, frames = inputs(cfg)
    batch = {"inputs": torch.from_numpy(toks[:, :S]).to("meta"),
             "frames": torch.from_numpy(frames).to("meta")}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fa, "flash_attention", record)
        logits, cache = tlm.prefill(meta, batch, MAXLEN)
    se = cfg.encoder_seq
    assert calls == [(se, se, False)] * cfg.encoder_layers + \
        [(S, S, True), (S, se, False)] * cfg.num_layers
    assert tuple(cache["sub0"]["xk"].shape) == (
        cfg.num_periods, B, se, cfg.num_kv_heads, cfg.head_dim)


def test_modality_stub_frames_match_reference():
    from repro.data import pipeline as jpipe
    cfg = tconfigs.reduced_config(ARCH)
    want = jpipe.add_modality_stubs(
        jpipe.SyntheticLM(512, 16, 3, seed=5).batch_at(2), cfg, 2)
    got = tpipe.add_modality_stubs(
        tpipe.SyntheticLM(512, 16, 3, seed=5).batch_at(2), cfg, 2)
    assert got["frames"].dtype == torch.float32
    assert tuple(got["frames"].shape) == (3, cfg.encoder_seq, cfg.d_model)
    np.testing.assert_array_equal(got["frames"].numpy(),
                                  np.asarray(want["frames"]))


def test_serve_launcher_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--batch", "2", "--prompt-len", "8",
         "--gen", "4"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "arch whisper-base on cpu: generated (2, 4) tokens" in proc.stdout
    assert proc.stdout.count("req ") == 2
