"""The port's VLM (PaliGemma: the vision prefix and its prefix-LM mask)
against the JAX reference's, on the CPU.

Reduced paligemma-3b (8 vision tokens of width 48, d 64, 4 query heads of
16 over 1 KV head, 2 layers, ``attn_chunk`` 32) in both packages.  The
reference's functions run as XLA on the CPU (its model under
``jax.jit``); the port's on CPU tensors, where attention is the model's
chunked attention and the flash kernel's wrapper runs its plain version.
The same numpy inputs, made from a seed, go to both, and the reference's
``LM.init`` weights reach the port through
``convert.lm_params_from_arrays``.

Tolerance, fp32: rtol = atol = 1e-5 for the attention functions,
``_embed_inputs`` and the prefill's K/V cache (the same products summed
in another order); 1e-4 for logits (through every layer and the
vocabulary projection), as ``tests/test_torch_lm.py`` holds the decoders.
bf16 logits within 5e-2 (each framework rounds at its own points).
Greedy tokens are equal.

Two controls must fail the fp32 checks: the prefix ignored (every row
causal), and the patches zeroed.
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
from repro.models.model import build as jbuild
from repro.serve.engine import ServeEngine as JEngine
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention as tattn
from repro_torch.models.model import LM, build
from repro_torch.serve.engine import ServeEngine
from torch_port_util import reference_compiled_here  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "paligemma-3b"
TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
B, S, EXTRA = 2, 12, 4
# A prompt whose 8 + 40 positions pass the reduced attn_chunk of 32.
LONG = 40
MAXLEN = 8 + LONG + EXTRA + 4


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


def close(got, want, tol=TOL):
    np.testing.assert_allclose(f32(got), f32(want), **tol)


def far(got, want, tol=TOL):
    """``got`` fails ``close`` at ``tol`` (a control)."""
    with pytest.raises(AssertionError):
        close(got, want, tol)


def cfgs(dtype="float32", **over):
    """Reduced paligemma-3b in both packages (reference, port)."""
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


def inputs(cfg, seed=0, n=LONG + EXTRA):
    """(tokens (B, n), patches (B, vision_tokens, vision_embed_dim)) as
    numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, n)).astype(np.int32)
    patches = rng.normal(size=(B, cfg.vision_tokens, cfg.vision_embed_dim))
    return toks, patches.astype(np.float32)


def batches(toks, patches, n=S):
    """The same prompt as a reference batch and a port batch."""
    return ({"inputs": jnp.asarray(toks[:, :n]),
             "patches": jnp.asarray(patches)},
            {"inputs": torch.from_numpy(toks[:, :n]),
             "patches": torch.from_numpy(patches)})


# -- the mask -----------------------------------------------------------------
# b, sq, sk, kv, g, dh, dv, prefix
MASK_CASES = {
    "prefix-0": (2, 40, 40, 2, 2, 16, 16, 0),
    "ragged-prefix": (2, 40, 40, 2, 2, 16, 16, 13),
    "aligned-prefix": (1, 150, 150, 1, 2, 16, 16, 64),
    "g8-kv1": (2, 48, 48, 1, 8, 16, 16, 8),
    "d256": (1, 40, 40, 1, 2, 256, 256, 17),
    "sq-lt-sk": (1, 30, 50, 2, 1, 16, 16, 20),
}


@pytest.mark.parametrize("case", sorted(MASK_CASES))
def test_plain_kernel_prefix_matches_reference(case):
    """``flash_attention_plain(prefix_len=…)`` (the kernel's yardstick)
    and the wrapper on CPU tensors against the reference's
    ``chunked_attention(prefix_len=…)``; the prefix ignored must fail
    wherever there is one."""
    b, sq, sk, kv, g, dh, dv, prefix = MASK_CASES[case]
    rng = np.random.default_rng(sq + dh + prefix)
    q = rng.normal(size=(b, sq, kv, g, dh)).astype(np.float32)
    k = rng.normal(size=(b, sk, kv, dh)).astype(np.float32)
    v = rng.normal(size=(b, sk, kv, dv)).astype(np.float32)
    want = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=True,
                                   prefix_len=prefix)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = fa.flash_attention_plain(tq, tk, tv, causal=True,
                                   prefix_len=prefix)
    close(got, want)
    close(fa.flash_attention(tq, tk, tv, prefix_len=prefix), want)
    if prefix:
        far(fa.flash_attention_plain(tq, tk, tv, causal=True), want)


@pytest.mark.parametrize("prefix", [40, 41, 1000])
def test_a_prefix_past_sq_is_non_causal(prefix):
    """Every key lies in a prefix of Sq or more: the causal call equals
    the non-causal one (in both packages)."""
    rng = np.random.default_rng(prefix)
    q = rng.normal(size=(2, 40, 1, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 40, 1, 16)).astype(np.float32)
            for _ in range(2))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = jattn.chunked_attention(jq, jk, jv, causal=False)
    close(jattn.chunked_attention(jq, jk, jv, causal=True, prefix_len=prefix),
          want)
    got = fa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                   causal=True, prefix_len=prefix)
    close(got, want)


def test_prefix_is_ignored_unless_causal():
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(1, 20, 1, 2, 8)).astype(
        np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(1, 20, 1, 8)).astype(
        np.float32)) for _ in range(2))
    assert torch.equal(fa.flash_attention_plain(q, k, v, causal=False,
                                                prefix_len=7),
                       fa.flash_attention_plain(q, k, v, causal=False))


@pytest.mark.parametrize("bad", [-1, 2.5, "8"])
def test_wrapper_refuses_a_bad_prefix(bad):
    q = torch.zeros((1, 4, 1, 1, 8))
    k = v = torch.zeros((1, 4, 1, 8))
    with pytest.raises((ValueError, TypeError)):
        fa.flash_attention(q, k, v, prefix_len=bad)
    with pytest.raises((ValueError, TypeError)):
        fa.flash_attention_plain(q, k, v, prefix_len=bad)


@pytest.mark.parametrize("prefix,chunk", [(13, 16), (8, 32), (30, 8)])
def test_chunked_attention_online_path_matches_reference(prefix, chunk):
    """The port's ``chunked_attention`` on its online-softmax path (keys
    in blocks of 16, the model's ``attn_kv_block`` set so) with a
    prefix, against the reference's at the same chunking."""
    rng = np.random.default_rng(prefix + chunk)
    q = rng.normal(size=(2, 48, 1, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 48, 1, 16)).astype(np.float32)
            for _ in range(2))
    kw = dict(causal=True, prefix_len=prefix, chunk=chunk, kv_block=16)
    want = jattn.chunked_attention(*map(jnp.asarray, (q, k, v)), **kw)
    got = tattn.chunked_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    close(got, want)


# -- the functions ------------------------------------------------------------
@pytest.mark.parametrize("kv_block", [1024, 16], ids=["one-block", "online"])
def test_attn_forward_with_a_prefix_matches_reference(kv_block):
    jlm, jparams, _, tparams, tcfg = models(attn_kv_block=kv_block)
    jcfg = jlm.cfg
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["sub0"]["mixer"])
    tp = tparams["blocks"][0]["sub0"]["mixer"]
    x = np.random.default_rng(5).normal(
        size=(B, tcfg.vision_tokens + LONG, tcfg.d_model)).astype(np.float32)
    want, (jk, jv) = jattn.attn_forward(jp, jnp.asarray(x), jcfg,
                                        prefix_len=tcfg.vision_tokens,
                                        return_kv=True)
    tx = torch.from_numpy(x)
    got, (k, v) = tattn.attn_forward(tp, tx, tcfg,
                                     prefix_len=tcfg.vision_tokens,
                                     return_kv=True)
    close(got, want)
    close(k, jk)
    close(v, jv)
    far(tattn.attn_forward(tp, tx, tcfg), want)


def test_embed_inputs_match_reference():
    """The projected patches (unscaled) before the √d-scaled tokens, and
    ``prefix_len`` = ``vision_tokens``; with the patches zeroed (the
    control) the prefix differs."""
    jlm, jparams, tlm, tparams, cfg = models()
    toks, patches = inputs(cfg)
    jb, tb = batches(toks, patches)
    jx, jprefix, jenc = jax.jit(jlm._embed_inputs)(jparams, jb)
    x, prefix, enc = tlm._embed_inputs(tparams, tb)
    assert prefix == int(jprefix) == cfg.vision_tokens == 8
    assert enc is None and jenc is None
    assert tuple(x.shape) == (B, cfg.vision_tokens + S, cfg.d_model)
    close(x, jx)
    ctl, _, _ = tlm._embed_inputs(tparams, dict(
        tb, patches=torch.zeros_like(tb["patches"])))
    far(ctl, jx)


# -- the model ----------------------------------------------------------------
@pytest.mark.parametrize("n", [S, LONG], ids=["short", "past-attn-chunk"])
def test_prefill_matches_reference(n):
    """Prefill logits within 1e-4 and the K/V cache within 1e-5, prompts
    of 8 + 12 and 8 + 40 positions (the second past the reduced
    ``attn_chunk`` of 32)."""
    jlm, jparams, tlm, tparams, cfg = models()
    toks, patches = inputs(cfg)
    jb, tb = batches(toks, patches, n)
    jl, jcache = jax.jit(lambda p, b: jlm.prefill(p, b, MAXLEN))(jparams, jb)
    tl, tcache = tlm.prefill(tparams, tb, MAXLEN)
    assert tl.dtype == torch.float32 and tl.shape == (B, cfg.vocab_padded)
    close(tl, jl, LOGIT_TOL)
    assert tcache.keys() == jcache.keys()
    for key, ent in jcache.items():
        assert tcache[key].keys() == ent.keys() == {"k", "v"}
        for name, want in ent.items():
            assert tuple(tcache[key][name].shape) == want.shape == (
                cfg.num_periods, B, MAXLEN, cfg.num_kv_heads, cfg.head_dim)
            close(tcache[key][name], want)


@pytest.mark.parametrize("control", ["prefix ignored", "patches zeroed"])
def test_prefill_controls_fail_the_logits_check(control):
    """Every self-attention run plain causal (its prefix dropped), or the
    image's patches zeroed: the logits leave the reference's 1e-4."""
    jlm, jparams, tlm, tparams, cfg = models()
    toks, patches = inputs(cfg, seed=1)
    jb, tb = batches(toks, patches)
    jl, _ = jax.jit(lambda p, b: jlm.prefill(p, b, MAXLEN))(jparams, jb)
    close(tlm.prefill(tparams, tb, MAXLEN)[0], jl, LOGIT_TOL)
    orig = tattn.attn_forward
    with pytest.MonkeyPatch.context() as mp:
        if control == "prefix ignored":
            mp.setattr(tattn, "attn_forward",
                       lambda *a, **k: orig(*a, **dict(k, prefix_len=0)))
        else:
            tb = dict(tb, patches=torch.zeros_like(tb["patches"]))
        tl, _ = tlm.prefill(tparams, tb, MAXLEN)
    far(tl, jl, LOGIT_TOL)


def test_prefill_and_decode_match_reference():
    """Four decode steps after the prefill, at positions offset by the
    vision tokens, each step's logits within 1e-4."""
    jlm, jparams, tlm, tparams, cfg = models()
    toks, patches = inputs(cfg, seed=2)
    jb, tb = batches(toks, patches)
    jl, jcache = jax.jit(lambda p, b: jlm.prefill(p, b, MAXLEN))(jparams, jb)
    tl, tcache = tlm.prefill(tparams, tb, MAXLEN)
    jstep = jax.jit(jlm.decode_step)
    p0 = cfg.vision_tokens + S
    for i in range(EXTRA):
        tok = toks[:, S + i:S + i + 1]
        jl, jcache = jstep(jparams, jcache, jnp.asarray(tok),
                           jnp.int32(p0 + i))
        tl, tcache = tlm.decode_step(tparams, tcache, torch.from_numpy(tok),
                                     p0 + i)
        close(tl, jl, LOGIT_TOL)


@pytest.mark.parametrize("n", [S, LONG], ids=["short", "past-attn-chunk"])
def test_greedy_generate_matches_reference(n):
    jlm, jparams, tlm, tparams, cfg = models()
    toks, patches = inputs(cfg, seed=3)
    jb, tb = batches(toks, patches, n)
    want = JEngine(jlm, jparams, max_len=MAXLEN).generate(jb, steps=8)
    got = ServeEngine(tlm, tparams, max_len=MAXLEN).generate(tb, steps=8)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bf16_prefill_and_decode_near_reference():
    jlm, jparams, tlm, tparams, cfg = models("bfloat16")
    toks, patches = inputs(cfg, seed=4)
    jb, tb = batches(toks, patches)
    jl, jcache = jax.jit(lambda p, b: jlm.prefill(p, b, MAXLEN))(jparams, jb)
    tl, tcache = tlm.prefill(tparams, tb, MAXLEN)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(tcache))
    tol = dict(rtol=5e-2, atol=5e-2)
    close(tl, jl, tol)
    jstep = jax.jit(jlm.decode_step)
    p0 = cfg.vision_tokens + S
    for i in range(2):
        tok = toks[:, S + i:S + i + 1]
        jl, jcache = jstep(jparams, jcache, jnp.asarray(tok),
                           jnp.int32(p0 + i))
        tl, tcache = tlm.decode_step(tparams, tcache, torch.from_numpy(tok),
                                     p0 + i)
        close(tl, jl, tol)


def test_decode_matches_prefill_of_the_longer_prompt():
    """Decode at step i equals the prefill of the prompt extended by
    those i tokens over the same image; a decode after a prefill of
    another image (the patches zeroed: the control) does not."""
    _, _, tlm, tparams, cfg = models()
    toks, patches = inputs(cfg, seed=5)
    t, pt = torch.from_numpy(toks), torch.from_numpy(patches)
    p0 = cfg.vision_tokens + S
    logits, cache = tlm.prefill(tparams, {"inputs": t[:, :S],
                                          "patches": pt}, MAXLEN)
    for i in range(EXTRA):
        ref, _ = tlm.prefill(tparams, {"inputs": t[:, :S + i],
                                       "patches": pt}, MAXLEN)
        close(logits, ref, LOGIT_TOL)
        logits, cache = tlm.decode_step(tparams, cache, t[:, S + i:S + i + 1],
                                        p0 + i)
    _, cache = tlm.prefill(tparams, {"inputs": t[:, :S],
                                     "patches": torch.zeros_like(pt)},
                           MAXLEN)
    ctl, _ = tlm.decode_step(tparams, cache, t[:, S:S + 1], p0)
    ref, _ = tlm.prefill(tparams, {"inputs": t[:, :S + 1], "patches": pt},
                         MAXLEN)
    far(ctl, ref, LOGIT_TOL)


def test_converter_carries_vis_proj():
    """``vis_proj`` arrives bit for bit in bf16, (vision_embed_dim,
    d_model), beside the reference's other top-level leaves."""
    _, jparams, _, tparams, cfg = models("bfloat16")
    want = to_numpy(jparams)
    assert tparams.keys() == want.keys()
    got = tparams["vis_proj"]
    assert got.dtype == torch.bfloat16
    assert tuple(got.shape) == (cfg.vision_embed_dim, cfg.d_model)
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(
        np.uint16), want["vis_proj"])


def test_random_init_has_the_reference_tree():
    """The port's own seeded init makes the reference's tree (``vis_proj``
    included) with its shapes and dtypes."""
    jcfg, tcfg = cfgs("bfloat16")
    want = jax.eval_shape(jbuild(jcfg).init, jax.random.key(0))
    got = LM(tcfg).init(torch.Generator().manual_seed(0))
    assert got.keys() == want.keys()
    assert (tuple(got["vis_proj"].shape), str(got["vis_proj"].dtype)) == \
        (want["vis_proj"].shape, "torch." + str(want["vis_proj"].dtype))
    ref = jax.tree.map(lambda a: (a.shape[1:], str(a.dtype)), want["blocks"])
    for period in got["blocks"]:
        assert tree_map(lambda t: (tuple(t.shape), str(t.dtype).removeprefix(
            "torch.")), period) == ref


def test_the_card_path_runs_the_kernel_once_a_layer_with_the_prefix():
    """Off the CPU the prefill hands every layer's attention to the flash
    kernel once, causal, over the vision tokens and the prompt, with
    ``prefix_len`` = ``vision_tokens``, on contiguous tensors (the
    wrapper refuses others).  Run on the ``meta`` device with the
    kernel's wrapper recording its calls."""
    _, _, tlm, tparams, cfg = models()
    calls = []

    def record(q, k, v, *, causal=True, prefix_len=0):
        assert q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
        calls.append((q.shape[1], k.shape[1], causal, prefix_len,
                      q.shape[-1], v.shape[-1]))
        b, sq, kvh, g, _ = q.shape
        return torch.empty((b, sq, kvh, g, v.shape[-1]), dtype=q.dtype,
                           device=q.device)

    meta = tree_map(lambda t: t.to("meta"), tparams)
    toks, patches = inputs(cfg)
    batch = {"inputs": torch.from_numpy(toks[:, :S]).to("meta"),
             "patches": torch.from_numpy(patches).to("meta")}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fa, "flash_attention", record)
        _, cache = tlm.prefill(meta, batch, MAXLEN)
    n = cfg.vision_tokens + S
    assert calls == [(n, n, True, cfg.vision_tokens, cfg.head_dim,
                      cfg.head_dim)] * cfg.num_layers
    assert tuple(cache["sub0"]["k"].shape) == (
        cfg.num_periods, B, MAXLEN, cfg.num_kv_heads, cfg.head_dim)


def test_int8_kv_cache_still_raises():
    """paligemma builds and serves with the int8 KV cache: the image and
    the prompt are quantised into int8 codes with fp32 scales, and greedy
    decode runs over them (tests/test_torch_kv_int8.py holds it to the
    reference)."""
    _, _, _, tparams, cfg = models()
    quant = LM(dataclasses.replace(cfg, kv_cache_quant=True))
    toks, patches = inputs(cfg)
    batch = batches(toks, patches)[1]
    _, cache = quant.prefill(tparams, batch, MAXLEN)
    n = cfg.vision_tokens + S
    assert cache["sub0"]["k"].dtype == torch.int8
    assert cache["sub0"]["v_s"].dtype == torch.float32
    assert bool(cache["sub0"]["k_s"][:, :, :n].all())
    assert not bool(cache["sub0"]["k_s"][:, :, n:].any())
    out = ServeEngine(quant, tparams, max_len=MAXLEN).generate(batch, 3)
    assert out.shape == (B, 3) and int(out.max()) < cfg.vocab_size


def test_serve_launcher_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--batch", "2", "--prompt-len", "8",
         "--gen", "4"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "arch paligemma-3b on cpu: generated (2, 4) tokens" in proc.stdout
    assert proc.stdout.count("req ") == 2
