"""The flash-attention gradient's plain version and autograd Function
against autograd of the forward's plain version and ``jax.grad`` of the
reference's ``chunked_attention``, on the CPU; and the forward's
log-sum-exp, which the backward takes, against ``jax.nn.logsumexp`` of the
reference's scaled, masked scores.

Inputs and the output's cotangent are made by numpy from a seed and handed
to both packages.  The reference has no backward Pallas kernel: its model
trains through jax autodiff of ``chunked_attention``
(``src/repro/models/attention.py:70``), so that is the gradient the port's
backward kernel (``csrc/flash_attention_bwd.cu``, card only; its card
tests are in ``tests/test_torch_chip.py``) stands in for.

Tolerance: rtol = atol = 1e-5 in fp32 (sums in another order than
autograd's and XLA's; the plain version takes the softmax over whole rows
against the reference's online softmax over key blocks).

The mma.sync and FMA source (``csrc/flash_attention_bwd.cu``: every fp32
call, misaligned views and the pairs the wgmma body is not built for)
also runs here, compiled by the host's ``g++`` against
``tools/cuda_emulate.py``'s emulation of the CUDA it uses (a thread per
CUDA thread, ``mma.sync``'s fragment layouts), given the plain forward's
lse: held against the plain version within the card tests' bounds, 1e-5
in fp32 and 5e-3 in bf16, each of dq, dk, dv in norm.  The wgmma body
(TMA, ``wgmma``) runs on the card only.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention as tattn
from torch_port_util import reference_compiled_here  # noqa: F401

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import cuda_emulate  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)

# (b, sq, sk, kv heads, g, dh, dv, causal, prefix_len)
CASES = {
    "causal": (2, 40, 40, 2, 1, 16, 16, True, 0),
    "gqa": (1, 37, 37, 2, 3, 16, 16, True, 0),
    "dh-ne-dv": (1, 30, 30, 2, 2, 24, 16, True, 0),
    "prefix": (2, 33, 33, 1, 4, 16, 16, True, 12),
    "prefix-past-sk": (1, 20, 20, 2, 1, 8, 8, True, 25),
    "non-causal-sq-lt-sk": (2, 17, 45, 2, 2, 16, 24, False, 0),
    "non-causal-sq-gt-sk": (1, 45, 17, 1, 2, 16, 16, False, 0),
    "causal-sq-lt-sk": (1, 20, 35, 2, 1, 16, 16, True, 0),
    "several-plain-chunks": (1, 700, 700, 1, 2, 8, 8, True, 0),
}


def inputs(case, seed=0):
    b, sq, sk, kvh, g, dh, dv, causal, prefix = case
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, kvh, g, dh)).astype(np.float32)
    k = rng.normal(size=(b, sk, kvh, dh)).astype(np.float32)
    v = rng.normal(size=(b, sk, kvh, dv)).astype(np.float32)
    do = rng.normal(size=(b, sq, kvh, g, dv)).astype(np.float32)
    return q, k, v, do


def plain_lse(q, k, v, causal, prefix):
    return fa.flash_attention_plain(q, k, v, causal=causal,
                                    prefix_len=prefix, return_lse=True)[1]


def close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_backward_matches_autograd_of_the_plain_forward(name):
    *_, causal, prefix = CASES[name]
    q, k, v, do = map(torch.from_numpy, inputs(CASES[name]))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o, lse = fa.flash_attention_plain(*leaves, causal=causal,
                                      prefix_len=prefix, return_lse=True)
    want = torch.autograd.grad(o, leaves, do)
    got = fa.flash_attention_bwd_plain(q, k, v, o.detach(), do,
                                       lse.detach(), causal=causal,
                                       prefix_len=prefix)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        close(g, w)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_forward_lse_matches_jax_logsumexp(name):
    """The plain forward's lse against ``jax.nn.logsumexp`` of the
    reference's scaled scores under ``chunked_attention``'s mask (keys
    past Sk and, when causal, keys after the row and at or past the
    prefix, at -1e30); its output is the one without lse."""
    b, sq, sk, kvh, g, dh, dv, causal, prefix = CASES[name]
    q, k, v, _ = inputs(CASES[name])
    s = jnp.einsum("bckgd,bskd->bkgcs", q, k) * dh ** -0.5
    kpos, qpos = jnp.arange(sk), jnp.arange(sq)
    mask = jnp.ones((sq, sk), bool)
    if causal:
        mask = (kpos[None, :] <= qpos[:, None]) | (kpos[None, :] < prefix)
    want = jax.nn.logsumexp(jnp.where(mask, s, -1e30), axis=-1)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    o, lse = fa.flash_attention_plain(tq, tk, tv, causal=causal,
                                      prefix_len=prefix, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (b, kvh, g, sq)
    close(lse, want)
    assert torch.equal(o, fa.flash_attention_plain(
        tq, tk, tv, causal=causal, prefix_len=prefix))


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_backward_matches_jax_grad_of_chunked_attention(name):
    """Given the plain forward's lse, against ``jax.vjp`` of the
    reference's ``chunked_attention`` with the model's blocking (small
    chunks and key blocks, so its online softmax spans several blocks)."""
    b, sq, sk, kvh, g, dh, dv, causal, prefix = CASES[name]
    q, k, v, do = inputs(CASES[name])

    def ref(q, k, v):
        return jattn.chunked_attention(q, k, v, causal=causal,
                                       prefix_len=prefix, chunk=16,
                                       kv_block=16)

    o, vjp = jax.vjp(ref, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = fa.flash_attention_bwd_plain(
        tq, tk, tv, torch.from_numpy(np.array(o)), torch.from_numpy(do),
        plain_lse(tq, tk, tv, causal, prefix), causal=causal,
        prefix_len=prefix)
    for g_, w in zip(got, want):
        close(g_, w)


@pytest.mark.parametrize("name", ["gqa", "prefix", "non-causal-sq-lt-sk"])
def test_function_gradient_is_the_backward(name):
    """``FlashAttention`` on CPU tensors: the forward's plain version, and
    its gradient ``flash_attention_bwd`` (the plain version on the CPU),
    the same function as the chunked attention's autograd gradient."""
    *_, causal, prefix = CASES[name]
    q, k, v, do = map(torch.from_numpy, inputs(CASES[name], seed=1))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = fa.flash_bwd_launches
    o = fa.FlashAttention.apply(*leaves, causal, prefix)
    got = torch.autograd.grad(o, leaves, do)
    assert fa.flash_bwd_launches == before       # no kernel on the CPU
    want = fa.flash_attention_bwd_plain(q, k, v, o.detach(), do,
                                        plain_lse(q, k, v, causal, prefix),
                                        causal=causal, prefix_len=prefix)
    for g_, w in zip(got, want):
        assert torch.equal(g_, w)
    chunked = [t.clone().requires_grad_(True) for t in (q, k, v)]
    oc = tattn.chunked_attention(*chunked, causal=causal, prefix_len=prefix,
                                 chunk=16, kv_block=16)
    for g_, w in zip(got, torch.autograd.grad(oc, chunked, do)):
        close(g_, w)


def test_function_saves_nothing_without_grad():
    """Serving calls the Function with nothing requiring grad: no graph,
    nothing saved, a plain output.  Under grad it saves q, k, v, the
    output and the forward's lse."""
    q, k, v, _ = map(torch.from_numpy, inputs(CASES["causal"]))
    o = fa.FlashAttention.apply(q, k, v, True, 0)
    assert o.grad_fn is None
    assert torch.equal(o, fa.flash_attention_plain(q, k, v))
    leaf = q.clone().requires_grad_(True)
    o = fa.FlashAttention.apply(leaf, k, v, True, 0)
    saved = o.grad_fn.saved_tensors
    assert len(saved) == 5
    assert torch.equal(saved[4], plain_lse(q, k, v, True, 0))


def test_bf16_plain_backward_rounds_p_and_ds():
    """In bf16 the plain version rounds P (before dV) and dS (before dQ and
    dK) to bf16 and sums in fp32: it lies as close to the fp32 gradient of
    the same bf16 inputs as bf16's rounding allows (2^-8 relative), and its
    outputs are bf16."""
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in inputs(CASES["gqa"], seed=2))
    o, lse = fa.flash_attention_plain(q, k, v, return_lse=True)
    got = fa.flash_attention_bwd_plain(q, k, v, o, do, lse)
    exact = fa.flash_attention_bwd_plain(*(t.float() for t in (q, k, v, o,
                                                                do)), lse)
    for g_, w in zip(got, exact):
        assert g_.dtype == torch.bfloat16
        assert float((g_.float() - w).norm() / w.norm()) < 2 ** -7


def test_backward_wrapper_takes_the_plain_version_on_the_cpu():
    q, k, v, do = map(torch.from_numpy, inputs(CASES["prefix"]))
    o, lse = fa.flash_attention_plain(q, k, v, prefix_len=12,
                                      return_lse=True)
    before = fa.flash_bwd_launches
    by_body = dict(fa.flash_bwd_launches_by_body)
    got = fa.flash_attention_bwd(q, k, v, o, do, lse, prefix_len=12)
    want = fa.flash_attention_bwd_plain(q, k, v, o, do, lse, prefix_len=12)
    assert fa.flash_bwd_launches == before
    assert fa.flash_bwd_launches_by_body == by_body
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_backward_wrapper_checks_its_inputs():
    q, k, v, do = map(torch.from_numpy, inputs(CASES["causal"]))
    o, lse = fa.flash_attention_plain(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="does not match"):
        fa.flash_attention_bwd(q, k, v, o[:, :-1], do, lse)
    with pytest.raises(ValueError, match="does not match"):
        fa.flash_attention_bwd(q, k, v, o, do.double(), lse)
    with pytest.raises(ValueError, match="lse .* does not match"):
        fa.flash_attention_bwd(q, k, v, o, do, lse[..., :-1])
    with pytest.raises(ValueError, match="lse .* does not match"):
        fa.flash_attention_bwd(q, k, v, o, do, lse.double())
    with pytest.raises(ValueError, match="prefix_len"):
        fa.flash_attention_bwd(q, k, v, o, do, lse, prefix_len=-1)
    with pytest.raises(ValueError, match="no flash-attention kernel"):
        fa.flash_attention_bwd(*(t.to("meta") for t in (q, k, v, o, do,
                                                         lse)))


@pytest.fixture(scope="module")
def emulated():
    return cuda_emulate.build()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", sorted(cuda_emulate.CASES))
def test_kernel_source_emulated_on_the_cpu_matches_plain(emulated, name,
                                                         dtype):
    """The backward's mma.sync and FMA source (its D pass and two kernels
    at the 64-, 128- and 256-column builds, fp32 and bf16 tiles) run by
    the CPU emulation, given the plain forward's lse, against the plain
    version."""
    errs = cuda_emulate.relative_errors(emulated, cuda_emulate.CASES[name],
                                        dtype)
    assert max(errs) <= (1e-5 if dtype == torch.float32 else 5e-3), errs
