"""The port's MoE FFN (``repro_torch.models.moe``) against the reference's.

The same numpy inputs (made from a seed) go through the reference's
functions in JAX on the CPU and through the port's on CPU tensors.

Tolerance: rtol = atol = 1e-5 in fp32 (the same products, summed in
another order).  In bf16 the two frameworks round each product and the
gated activation to bf16 at their own points: outputs differ by up to one
bf16 ulp (1.6e-2 at |y| near 2.8) and must agree within ``BF16_TOL``,
rtol = atol = 2e-2.  Routing runs in fp32
in both and ``topi`` must be equal exactly; each routing comparison
reports the smallest top-1/top-2 probability gap among its tokens, which
says how near a tie it came.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import MoEConfig as JMoE
from repro.models import moe as jmoe
from repro_torch import configs as tconfigs
from repro_torch.configs.base import MoEConfig as TMoE
from repro_torch.models import moe as tmoe
from torch_port_util import reference_compiled_here  # noqa: F401

ARCH = "llama4-scout-17b-a16e"
T, E = 64, 4
TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def cfgs(top_k=1, capacity_factor=1.25, dtype="float32"):
    """The reduced llama4-scout config in both packages (d 64, d_ff 128,
    4 experts) with ``top_k`` and ``capacity_factor`` set."""
    over = dict(param_dtype=dtype, activation_dtype=dtype)
    moe = dict(num_experts=E, top_k=top_k, capacity_factor=capacity_factor)
    return (dataclasses.replace(jconfigs.reduced_config(ARCH),
                                moe=JMoE(**moe), **over),
            dataclasses.replace(tconfigs.reduced_config(ARCH),
                                moe=TMoE(**moe), **over))


def arrays(cfg, seed=0, tokens=T):
    """Seeded numpy router, experts and tokens (fp32)."""
    rng = np.random.default_rng(seed)
    d, f = cfg.d_model, cfg.d_ff
    w = {"router": rng.standard_normal((d, E)) * d ** -0.5,
         "w_gate": rng.standard_normal((E, d, f)) * d ** -0.5,
         "w_up": rng.standard_normal((E, d, f)) * d ** -0.5,
         "w_down": rng.standard_normal((E, f, d)) * f ** -0.5}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    return w, rng.standard_normal((tokens, d)).astype(np.float32)


def both(a, bf16):
    """One numpy array as a (jax, torch) pair; bf16 as the same bits."""
    if not bf16:
        return jnp.asarray(a), torch.from_numpy(a)
    bits = a.astype(ml_dtypes.bfloat16).view(np.uint16)
    return (jnp.asarray(bits.view(ml_dtypes.bfloat16)),
            torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16))


def params_pair(w, bf16=False):
    """(reference params, port params); the router stays fp32."""
    pairs = {k: both(v, bf16 and k != "router") for k, v in w.items()}
    return ({k: p[0] for k, p in pairs.items()},
            {k: p[1] for k, p in pairs.items()})


def f32(a):
    if torch.is_tensor(a):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def top_gap(probs):
    """Smallest top-1/top-2 probability gap over the rows."""
    p = np.sort(np.asarray(probs), axis=-1)
    return float((p[:, -1] - p[:, -2]).min())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_init_shapes_and_dtypes(dtype):
    jcfg, tcfg = cfgs(dtype=dtype)
    want = jmoe.moe_init(jax.random.key(0), jcfg, jnp.dtype(dtype))
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    got = tmoe.moe_init(torch.Generator().manual_seed(0), tcfg, tdt)
    again = tmoe.moe_init(torch.Generator().manual_seed(0), tcfg, tdt)
    assert got.keys() == want.keys()
    d, f = tcfg.d_model, tcfg.d_ff
    for name, t in got.items():
        assert tuple(t.shape) == want[name].shape
        assert str(t.dtype).removeprefix("torch.") == str(want[name].dtype)
        assert torch.equal(t, again[name])
        fan_in = f if name == "w_down" else d
        assert float(t.float().abs().max()) <= 2 * fan_in ** -0.5 * 1.01
    assert got["router"].dtype == torch.float32
    assert got["w_gate"].shape == (E, d, f) and got["w_down"].shape == (E, f, d)


@pytest.mark.parametrize("top_k", [1, 2])
def test_route_matches_reference(top_k):
    jcfg, tcfg = cfgs(top_k)
    w, x = arrays(tcfg, seed=top_k)
    x[5] = 0.0          # a row whose probabilities all tie
    jp, tp = params_pair(w)
    jx, tx = both(x, False)
    ji, jw, jaux = jmoe._route(jp, jx, jcfg)
    ti, tw, taux = tmoe._route(tp, tx, tcfg)
    probs = jax.nn.softmax(jx @ jp["router"], axis=-1)
    live = np.delete(np.asarray(probs), 5, axis=0)
    gap = top_gap(live)
    print(f"top_k={top_k}: smallest top-1/top-2 gap {gap:.3e}")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji),
                                  err_msg=f"gap {gap:.3e}")
    assert ti[5].tolist() == list(range(top_k))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TOL)
    assert taux.keys() == jaux.keys()
    for name in jaux:
        np.testing.assert_allclose(float(taux[name]), float(jaux[name]),
                                   **TOL)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_top_k_breaks_ties_as_lax_top_k(k):
    probs = np.array([[0.2, 0.3, 0.3, 0.2], [0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.4, 0.1, 0.4]], np.float32)
    jw, ji = jax.lax.top_k(jnp.asarray(probs), k)
    tw, ti = tmoe._top_k(torch.from_numpy(probs), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


def routing(case, top_k, tokens):
    """(topi, topw) numpy of one dispatch case: ``random`` routing (each
    row's experts distinct, weights summing to 1), every token on expert 2
    (the other groups empty), or a decode step (one token)."""
    rng = np.random.default_rng(7)
    if case == "one-expert":
        topi = np.full((tokens, top_k), 2, np.int32)
        topi[:, 1:] = np.arange(top_k - 1) * (E - 1) // max(top_k - 1, 1)
    else:
        topi = np.stack([rng.permutation(E)[:top_k] for _ in range(tokens)])
    topw = rng.uniform(0.1, 1.0, (tokens, top_k)).astype(np.float32)
    topw /= topw.sum(-1, keepdims=True)
    return topi.astype(np.int32), topw


DISPATCH_CASES = {"random": T, "one-expert": T, "decode": 1}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("case", sorted(DISPATCH_CASES))
def test_dispatch_ragged_matches_reference(case, top_k, dtype):
    bf16 = dtype == "bfloat16"
    tokens = DISPATCH_CASES[case]
    jcfg, tcfg = cfgs(top_k, dtype=dtype)
    w, x = arrays(tcfg, seed=3, tokens=tokens)
    jp, tp = params_pair(w, bf16)
    jx, tx = both(x, bf16)
    topi, topw = routing(case, top_k, tokens)
    want = jmoe._dispatch_ragged(jp, jx, jnp.asarray(topi),
                                 jnp.asarray(topw), jcfg)
    got = tmoe._dispatch_ragged(tp, tx, torch.from_numpy(topi).long(),
                                torch.from_numpy(topw), tcfg)
    assert got.dtype == tx.dtype and tuple(got.shape) == want.shape
    np.testing.assert_allclose(f32(got), f32(want),
                               **(BF16_TOL if bf16 else TOL))


def test_empty_groups_launch_nothing(monkeypatch):
    """Every token on one expert: one matmul triple runs, for that expert
    alone, and rows past the groups' sum come out zero."""
    _, tcfg = cfgs(1)
    w, x = arrays(tcfg, seed=4)
    _, tp = params_pair(w)
    calls = []
    real = tmoe.activation

    def counting(name):
        act = real(name)

        def run(z):
            calls.append(z.shape[0])
            return act(z)
        return run

    monkeypatch.setattr(tmoe, "activation", counting)
    xs = torch.from_numpy(x)
    out = tmoe._expert_ffn_ragged(tp, xs, [0, 0, T - 8, 0], "silu")
    assert calls == [T - 8]
    assert not bool(out[T - 8:].any())
    h = xs[:T - 8] @ tp["w_gate"][2]
    want = (torch.nn.functional.silu(h) * (xs[:T - 8] @ tp["w_up"][2])) \
        @ tp["w_down"][2]
    torch.testing.assert_close(out[:T - 8], want, **TOL)


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("drops", [False, True], ids=["kept", "dropped"])
def test_dispatch_capacity_matches_reference(drops, top_k):
    """Capacity 1.25 with every token on one expert drops tokens; capacity
    factor E with random routing keeps them all."""
    jcfg, tcfg = cfgs(top_k, capacity_factor=1.25 if drops else float(E))
    w, x = arrays(tcfg, seed=5)
    jp, tp = params_pair(w)
    jx, tx = both(x, False)
    topi, topw = routing("one-expert" if drops else "random", top_k, T)
    cap = tmoe._capacity(T, tcfg)
    assert cap == jmoe._capacity(T, jcfg)
    most = max(np.bincount(topi.reshape(-1), minlength=E))
    assert (most > cap) == drops, (most, cap)
    want = jmoe._dispatch_capacity(jp, jx, jnp.asarray(topi),
                                   jnp.asarray(topw), jcfg)
    got = tmoe._dispatch_capacity(tp, tx, torch.from_numpy(topi).long(),
                                  torch.from_numpy(topw), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if drops:
        # Every token past capacity has all its slots dropped.
        assert not bool(got[cap:].any()) and bool(got[:cap].all())


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "capacity"])
def test_moe_apply_matches_reference(exact, top_k):
    jcfg, tcfg = cfgs(top_k)
    w, x = arrays(tcfg, seed=6, tokens=2 * 24)
    x = x.reshape(2, 24, -1)
    jp, tp = params_pair(w)
    jx, tx = both(x, False)
    jy, jaux = jmoe.moe_apply(jp, jx, jcfg, exact=exact)
    ty, taux = tmoe.moe_apply(tp, tx, tcfg, exact=exact)
    assert tuple(ty.shape) == x.shape
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for name in jaux:
        np.testing.assert_allclose(float(taux[name]), float(jaux[name]),
                                   **TOL)


def test_moe_apply_refuses_a_mesh():
    _, tcfg = cfgs()
    w, x = arrays(tcfg)
    _, tp = params_pair(w)
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        tmoe.moe_apply(tp, torch.from_numpy(x)[None], tcfg, exact=True,
                       decode=True, mesh=object())
