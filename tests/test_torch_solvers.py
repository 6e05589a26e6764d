"""The port's solvers and fused step against the JAX reference's.

Each test builds a small seeded plan with the reference package and
carries it across with ``torch_port_util.carry_plan``, so both packages
run the same stream bytes.  The reference runs with ``backend="xla"`` and
with ``backend="pallas"`` (Pallas in interpret mode on the CPU, as the
reference's own tests run it); the port runs on CPU tensors, where the
fused step is ``spmv_plain`` plus the epilogue's torch function, with the
same in-place state and device-side loop control word the CUDA kernel
keeps.

Tolerance: rtol = atol = 1e-5 on vectors and scalars, because the fp32
sums (scatter-add, dots) run in another order than XLA's.  Iteration
counts, ``converged``, ``fused`` and ``tol_effective`` must be equal.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import format as F
from repro.core import partition as P
from repro.core import spmv as jspmv
from repro.data import matrices as JM
from repro.kernels import ops as jops
from repro.solvers import cg as jcg
from repro.solvers.power_iteration import (
    _pagerank_epilogue as j_pagerank_epilogue,
    _power_epilogue as j_power_epilogue)
from repro import solvers as jsolvers
from repro_torch import solvers
from repro_torch.core import spmv as tspmv
from repro_torch.kernels import ops
from repro_torch.kernels import serpens_spmv as ks
from repro_torch.solvers import cg as tcg
from repro_torch.solvers.power_iteration import (
    _pagerank_epilogue as t_pagerank_epilogue,
    _power_epilogue as t_power_epilogue)

from torch_port_util import carry_plan

TOL = dict(rtol=1e-5, atol=1e-5)   # fp32 sums in another order
SMALL = dict(segment_width=64, lanes=8, sublanes=4, raw_window=4)
REF_BACKENDS = ["xla", "pallas"]


def cfg(dtype="float32", **kw):
    return F.SerpensConfig(**dict(SMALL, **kw), value_dtype=dtype)


def both_ops(rows, cols, vals, shape, config, backend="xla",
             spec=P.PlanSpec()):
    jplan = P.make_plan(rows, cols, vals, shape, config, spec)
    return (jspmv.SerpensOperator(jplan, backend=backend),
            tspmv.SerpensOperator(carry_plan(jplan), device="cpu"))


def graph(n=96, nnz=700, seed=1):
    rows, cols, vals = JM.power_law_graph(n, nnz, seed=seed)
    return rows, cols, JM.column_normalize(rows, cols, vals, n), (n, n)


def spd(n=56, seed=6):
    """Sparse symmetric diagonally-dominant (hence SPD) matrix."""
    rng = np.random.default_rng(seed)
    a = np.zeros((n, n), np.float32)
    idx = rng.integers(0, n, (4 * n, 2))
    a[idx[:, 0], idx[:, 1]] = rng.normal(size=4 * n)
    a = (a + a.T) / 2
    a[np.arange(n), np.arange(n)] = np.abs(a).sum(1) + 1.0
    rows, cols = np.nonzero(a)
    b = rng.normal(size=n).astype(np.float32)
    return rows, cols, a[rows, cols], (n, n), a, b


def gapped(n=48, seed=5):
    """SPD with a well-separated top eigenvalue (power iteration)."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    w = np.linspace(1.0, 2.0, n)
    w[-1] = 4.0
    a = ((q * w) @ q.T).astype(np.float32)
    a[np.abs(a) < 0.02] = 0.0
    rows, cols = np.nonzero(a)
    return rows, cols, a[rows, cols], (n, n), a


def quiet(fn, *a, **kw):
    """Run a solver with the bf16 tolerance-clamp warning silenced."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return fn(*a, **kw)


# -- the fused step --------------------------------------------------------
def step_inputs(name, jop, rng):
    """The x of one fused step and its extras, as numpy."""
    m = jop.shape[0]
    rp, lanes = jop.plan.out_rows_padded, jop.config.lanes

    def acc_layout(v):
        return np.pad(v, (0, rp - m)).reshape(-1, lanes)

    if name == "cg":
        sol, r, p = (rng.normal(size=m).astype(np.float32)
                     for _ in range(3))
        rs = np.array([[float(r @ r)]], np.float32)
        return p, (acc_layout(sol), acc_layout(r), acc_layout(p), rs)
    if name == "pagerank":
        r = rng.uniform(size=m).astype(np.float32)
        r /= r.sum()
        consts = np.array([[0.85, m]], np.float32)
        return r, (acc_layout(r), acc_layout(np.ones(m, np.float32)),
                   consts)
    v = rng.normal(size=m).astype(np.float32)
    v /= np.linalg.norm(v)
    return v, (acc_layout(v),)


EPILOGUES = {"cg": (jcg._cg_epilogue, tcg._cg_epilogue),
             "pagerank": (j_pagerank_epilogue, t_pagerank_epilogue),
             "power": (j_power_epilogue, t_power_epilogue)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", REF_BACKENDS)
@pytest.mark.parametrize("name", sorted(EPILOGUES))
def test_run_stream_fused_matches_reference(name, backend, dtype):
    r, c, v, shape = graph(seed=3)
    jop, top = both_ops(r, c, v, shape, cfg(dtype, tiles_per_chunk=2))
    x, extras = step_inputs(name, jop, np.random.default_rng(4))
    jep, tep = EPILOGUES[name]
    jcfg, sm = jop.config, jop.plan.shards[0]
    kp = jop.plan.num_segments_local * jcfg.segment_width
    jacc, jouts = jops.run_stream_fused(
        jnp.asarray(sm.idx), jnp.asarray(sm.val), jnp.asarray(sm.seg_ids),
        jnp.asarray(sm.seg_ids[::jcfg.tiles_per_chunk]),
        jnp.asarray(np.pad(x, (0, kp - x.size))), epilogue=jep,
        extras=tuple(jnp.asarray(e) for e in extras),
        num_rows_padded=jop.plan.out_rows_padded,
        segment_width=jcfg.segment_width,
        tiles_per_chunk=jcfg.tiles_per_chunk, backend=backend)
    idx, val, seg = top._shards[0]
    t_extras = tuple(torch.from_numpy(e.copy()) for e in extras)
    d0 = ops.trace_dispatch_count()
    tacc, touts = ops.run_stream_fused(
        idx, val, seg, torch.from_numpy(x), epilogue=tep, extras=t_extras,
        num_rows_padded=top.plan.out_rows_padded,
        segment_width=jcfg.segment_width,
        tiles_per_chunk=jcfg.tiles_per_chunk, backend="torch")
    assert ops.trace_dispatch_count() - d0 == 1      # one pass over A
    np.testing.assert_allclose(tacc.numpy(), np.asarray(jacc), **TOL)
    assert len(touts) == len(jouts)
    for t, j in zip(touts, jouts):
        assert tuple(t.shape) == tuple(j.shape)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    # Registered epilogues work in place: the state outputs are the
    # extras themselves, as on the card.
    spec = ks._EPILOGUES[tep]
    for i, j in enumerate(spec.state):
        assert touts[i] is t_extras[j]


def test_plain_fused_step_leaves_extras_alone():
    r, c, v, shape = graph(seed=3)
    _, top = both_ops(r, c, v, shape, cfg())
    x, extras = step_inputs("cg", top, np.random.default_rng(4))
    t_extras = tuple(torch.from_numpy(e.copy()) for e in extras)
    idx, val, seg = top._shards[0]
    acc, outs = ks.spmv_fused_plain(
        idx, val, seg, torch.from_numpy(x), t_extras,
        epilogue=tcg._cg_epilogue, num_rows_padded=top.plan.out_rows_padded,
        segment_width=top.config.segment_width)
    for e, t in zip(extras, t_extras):
        np.testing.assert_array_equal(t.numpy(), e)
    assert outs[0] is not t_extras[0]
    np.testing.assert_allclose(acc.numpy()[:shape[0]],
                               top.to_dense() @ x, **TOL)


def test_unregistered_epilogue_runs_on_cpu():
    r, c, v, shape = graph(seed=7)
    jop, top = both_ops(r, c, v, shape, cfg())
    x = np.random.default_rng(8).normal(size=shape[0]).astype(np.float32)
    s = np.full((1, 1), 0.5, np.float32)

    def scale(acc2, s11):          # jnp and torch both take this
        return (acc2 * s11 + 1.0,)

    assert scale not in ks._EPILOGUES
    jacc, (jout,) = jop.matvec_fused(x, scale, extras=(jnp.asarray(s),))
    before = ks.spmv_fused_launches
    tacc, (tout,) = top.matvec_fused(x, scale, extras=(torch.from_numpy(s),))
    assert ks.spmv_fused_launches == before          # no kernel on CPU
    np.testing.assert_allclose(tacc.numpy(), np.asarray(jacc), **TOL)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    with pytest.raises(ValueError, match="registered"):
        top.matvec_fused(x, scale, extras=(torch.from_numpy(s),),
                         loop=ks.FusedLoop("cpu", stop=0.0, max_iters=1))


def test_registering_an_unknown_epilogue_raises():
    with pytest.raises(ValueError, match="no epilogue"):
        ks.fused_epilogue("jacobi")


def test_an_epilogue_name_takes_one_function():
    """The kernel's arithmetic for a name is fixed, so a second torch
    function cannot claim it; re-registering the same one is harmless."""
    def other_cg(ap2, sol2, r2, p2, rs11):
        return sol2, r2, p2, rs11

    with pytest.raises(ValueError, match="already registered"):
        ks.fused_epilogue("cg")(other_cg)
    assert other_cg not in ks._EPILOGUES
    assert ks.fused_epilogue("cg")(tcg._cg_epilogue) is tcg._cg_epilogue
    assert ks._EPILOGUES[tcg._cg_epilogue] is ks.EPILOGUE_SPECS["cg"]


def test_fused_step_checks_its_extras():
    r, c, v, shape = graph(seed=3)
    _, top = both_ops(r, c, v, shape, cfg())
    x, extras = step_inputs("cg", top, np.random.default_rng(4))
    t_extras = [torch.from_numpy(e.copy()) for e in extras]
    with pytest.raises(ValueError, match="takes 4 extras"):
        top.matvec_fused(x, tcg._cg_epilogue, extras=t_extras[:3])
    t_extras[3] = torch.zeros(1, 2)
    with pytest.raises(ValueError, match="expected 1"):
        top.matvec_fused(x, tcg._cg_epilogue, extras=t_extras)


# -- the solvers -------------------------------------------------------------
def run_both(kind, dtype, fused, backend):
    if kind == "pagerank":
        r, c, v, shape = graph(seed=1)
        jop, top = both_ops(r, c, v, shape, cfg(dtype), backend)
        kw = dict(tol=1e-6, max_iters=200, fused=fused)
        return (quiet(jsolvers.pagerank, jop, backend=backend, **kw),
                quiet(solvers.pagerank, top, **kw))
    if kind == "cg":
        r, c, v, shape, _, b = spd(seed=6)
        jop, top = both_ops(r, c, v, shape, cfg(dtype), backend)
        kw = dict(tol=1e-6, fused=fused)
        return (quiet(jsolvers.conjugate_gradient, jop, b, backend=backend,
                      **kw),
                quiet(solvers.conjugate_gradient, top, b, **kw))
    r, c, v, shape, _ = gapped(seed=5)
    jop, top = both_ops(r, c, v, shape, cfg(dtype), backend)
    kw = dict(tol=1e-5, max_iters=300, fused=fused)
    return (quiet(jsolvers.power_iteration, jop, backend=backend, **kw),
            quiet(solvers.power_iteration, top, **kw))


@pytest.mark.parametrize("backend", REF_BACKENDS)
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["pagerank", "cg", "power_iteration"])
def test_solver_matches_reference(kind, dtype, fused, backend):
    jres, tres = run_both(kind, dtype, fused, backend)
    assert tres.iterations == jres.iterations > 0
    assert tres.converged == jres.converged
    assert tres.fused == jres.fused == fused
    assert tres.tol_effective == jres.tol_effective
    assert tres.x.dtype == torch.float32
    np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x), **TOL)
    np.testing.assert_allclose(tres.residual, jres.residual, rtol=1e-3,
                               atol=1e-6)
    if kind == "power_iteration":
        np.testing.assert_allclose(tres.eigenvalue, jres.eigenvalue, **TOL)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_pagerank_respects_max_iters(fused):
    r, c, v, shape = graph(seed=3)
    jop, top = both_ops(r, c, v, shape, cfg())
    jres = jsolvers.pagerank(jop, tol=0.0, max_iters=5, fused=fused)
    tres = solvers.pagerank(top, tol=0.0, max_iters=5, fused=fused)
    assert tres.iterations == jres.iterations == 5
    assert not tres.converged and not jres.converged
    np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x), **TOL)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_cg_warm_start_and_max_iters(fused):
    r, c, v, shape, a, b = spd(seed=10)
    jop, top = both_ops(r, c, v, shape, cfg())
    full = solvers.conjugate_gradient(top, b, tol=1e-6, fused=fused)
    jfull = jsolvers.conjugate_gradient(jop, b, tol=1e-6, fused=fused)
    assert full.iterations == jfull.iterations
    warm = solvers.conjugate_gradient(top, b, x0=full.x, tol=1e-5,
                                      fused=fused)
    jwarm = jsolvers.conjugate_gradient(jop, b, x0=np.asarray(full.x),
                                        tol=1e-5, fused=fused)
    assert warm.iterations == jwarm.iterations == 0 and warm.converged
    assert warm.host_syncs == 1
    capped = solvers.conjugate_gradient(top, b, tol=0.0, max_iters=3,
                                        fused=fused)
    assert capped.iterations == 3 and not capped.converged
    none = solvers.conjugate_gradient(top, b, tol=0.0, max_iters=0,
                                      fused=fused)
    assert none.iterations == 0
    np.testing.assert_array_equal(none.x.numpy(), np.zeros(shape[0]))


def test_solvers_reject_rectangular_and_bad_b():
    rng = np.random.default_rng(4)
    _, top = both_ops(rng.integers(0, 10, 30), rng.integers(0, 20, 30),
                      rng.normal(size=30).astype(np.float32), (10, 20),
                      cfg())
    with pytest.raises(ValueError, match="square"):
        solvers.pagerank(top)
    with pytest.raises(ValueError, match="square"):
        solvers.power_iteration(top)
    with pytest.raises(ValueError, match="square"):
        solvers.conjugate_gradient(top, np.ones(10, np.float32))
    r, c, v, shape, _, _ = spd(seed=12)
    _, sq = both_ops(r, c, v, shape, cfg())
    with pytest.raises(ValueError, match="expected"):
        solvers.conjugate_gradient(sq, np.zeros(shape[0] + 1, np.float32))
    with pytest.raises(NotImplementedError, match="multi-GPU slice"):
        solvers.pagerank(sq, mesh=object(), axis="x")
    with pytest.raises(ValueError, match="unknown solver"):
        solvers.solve(sq, "gauss")


def test_fused_rejected_on_multi_shard_and_auto_falls_back():
    rows, cols, vals = JM.uniform_random(90, 90, 700, seed=79)
    jop, top = both_ops(rows, cols, vals, (90, 90), cfg(),
                        spec=P.PlanSpec("row", 2))
    assert not top.supports_fused_epilogue and not jop.supports_fused_epilogue
    b = np.ones(90, np.float32)
    with pytest.raises(ValueError, match="fused"):
        solvers.conjugate_gradient(top, b, fused=True)
    with pytest.raises(ValueError, match="shards=2"):
        top.matvec_fused(b, tcg._cg_epilogue)
    res = solvers.pagerank(top, max_iters=3, fused="auto")
    jres = jsolvers.pagerank(jop, max_iters=3, fused="auto")
    assert not res.fused and not jres.fused and res.iterations == 3
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), **TOL)


@pytest.mark.parametrize("spec", [P.PlanSpec("single", 1, "balanced"),
                                  P.PlanSpec()])
def test_supports_fused_matches_reference(spec):
    r, c, v, shape = graph(seed=2)
    for config in (cfg(), F.OPTIMIZED_CONFIG):
        jop, top = both_ops(r, c, v, shape, config, spec=spec)
        assert top.supports_fused_epilogue == jop.supports_fused_epilogue


def test_acc_layout_roundtrip():
    r, c, v, shape, _, _ = spd(n=50, seed=83)
    jop, top = both_ops(r, c, v, shape, cfg())
    x = np.random.default_rng(89).normal(size=50).astype(np.float32)
    t2 = top.to_acc_layout(x)
    np.testing.assert_array_equal(t2.numpy(), np.asarray(jop.to_acc_layout(x)))
    np.testing.assert_array_equal(top.from_acc_layout(t2).numpy(), x)


@pytest.mark.parametrize("kind", ["pagerank", "cg", "power_iteration"])
def test_one_pass_over_a_per_iteration(kind):
    """The port counts passes that ran (the reference counts per trace):
    one per iteration, fused or not, plus CG's r0 pass outside the span."""
    for fused in (True, False):
        d0 = ops.trace_dispatch_count()
        _, res = run_both(kind, "float32", fused, "xla")
        extra = 1 if kind == "cg" else 0
        assert ops.trace_dispatch_count() - d0 == res.iterations + extra
        if fused:
            chunks = -(-res.iterations // ops.FUSED_CHUNK)
            assert res.host_syncs == max(1, chunks)
        else:
            assert res.host_syncs >= res.iterations


def test_fused_loop_control_word():
    """cont starts from the first measure; a stopped loop skips steps."""
    r, c, v, shape = graph(seed=3)
    _, top = both_ops(r, c, v, shape, cfg())
    loop = ks.FusedLoop("cpu", stop=1.0, max_iters=4,
                        first=torch.tensor(0.5))
    assert loop.ctrl.tolist() == [0, 0]
    r2 = top.to_acc_layout(np.full(shape[0], 1.0 / shape[0], np.float32))
    before = r2.clone()
    extras = (r2, top.to_acc_layout(np.ones(shape[0], np.float32)),
              torch.tensor([[0.85, shape[0]]]))
    top.matvec_fused(top.from_acc_layout(r2), t_pagerank_epilogue,
                     extras=extras, loop=ks.FusedLoop(
                         "cpu", stop=0.0, max_iters=0, scalars=(0.0,)))
    np.testing.assert_array_equal(r2.numpy(), before.numpy())
    loop = ks.FusedLoop("cpu", stop=0.0, max_iters=2, scalars=(0.0,))
    for _ in range(4):
        top.matvec_fused(top.from_acc_layout(r2), t_pagerank_epilogue,
                         extras=extras, loop=loop)
    assert loop.ctrl.tolist() == [0, 2]


@pytest.mark.parametrize("kind", ["pagerank", "cg", "power_iteration"])
def test_fused_solvers_leave_the_start_vector_alone(kind):
    """The fused body updates its state in place; a caller's x0/r0/v0
    whose length already fills the accumulator must not become it."""
    r, c, v, shape, _, b = spd(n=64, seed=6)
    _, top = both_ops(r, c, v, shape, cfg())
    assert top.plan.out_rows_padded == shape[0]
    start = torch.full((shape[0],), 1.0 / shape[0])
    before = start.clone()
    if kind == "cg":
        res = solvers.conjugate_gradient(top, b, x0=start, tol=1e-6,
                                         fused=True)
    elif kind == "pagerank":
        res = solvers.pagerank(top, r0=start, max_iters=5, fused=True)
    else:
        res = solvers.power_iteration(top, v0=start, max_iters=5,
                                      fused=True)
    assert res.iterations > 0
    torch.testing.assert_close(start, before, rtol=0, atol=0)
