"""The port's SerpensOperator against the JAX reference's, on one plan.

Each case encodes seeded triples with the reference package, carries the
plan across with ``repro_torch.convert.plan_from_arrays`` and applies it
through both operators on the CPU.  Tolerance: rtol = atol = 1e-5, because
the fp32 scatter-adds (stream, aux spill and the shard combine) sum in
another order.
"""
import numpy as np
import pytest
import torch

from repro.core import format as F
from repro.core import partition as P
from repro.core import spmv as jspmv
from repro_torch.core import format as TF
from repro_torch.core import spmv as tspmv
from repro_torch.kernels import ops

from torch_port_util import assert_same_plan, carry_plan, random_coo

TOL = dict(rtol=1e-5, atol=1e-5)   # fp32 sums in another order
SMALL = dict(segment_width=64, lanes=8, sublanes=4, raw_window=4)
CONFIGS = {
    "small": F.SerpensConfig(**SMALL),
    "spill": F.SerpensConfig(**dict(SMALL, raw_window=2),
                             spill_hot_rows=True, lane_balance=1.1),
    "bf16": F.SerpensConfig(**SMALL, value_dtype="bfloat16"),
}
SPECS = [("single", 1, "modulo"), ("single", 1, "balanced"),
         ("row", 3, "modulo"), ("row", 2, "balanced"),
         ("col", 2, "modulo"), ("col", 3, "balanced")]
M, K = 150, 400


def both_ops(name, spec, seed=0):
    r, c, v = random_coo(M, K, 2500, seed=seed, hot_rows=4)
    jplan = P.make_plan(r, c, v, (M, K), CONFIGS[name], P.PlanSpec(*spec))
    tplan = carry_plan(jplan)
    assert_same_plan(jplan, tplan)
    return (jspmv.SerpensOperator(jplan),
            tspmv.SerpensOperator(tplan, device="cpu"))


def vectors(seed, n=None):
    rng = np.random.default_rng(seed)
    shape_x = (K,) if n is None else (K, n)
    shape_y = (M,) if n is None else (M, n)
    return (rng.normal(size=shape_x).astype(np.float32),
            rng.normal(size=shape_y).astype(np.float32))


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: f"{s[0]}{s[1]}-{s[2]}")
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_operator_matches_reference(name, spec):
    jop, top = both_ops(name, spec)
    x, y = vectors(1)
    got = top.matvec(x)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), np.asarray(jop.matvec(x)), **TOL)
    np.testing.assert_allclose(top(x, 1.5, -0.75, y).numpy(),
                               np.asarray(jop(x, 1.5, -0.75, y)), **TOL)
    xm, ym = vectors(2, n=4)
    np.testing.assert_allclose(top.matmat(xm, -0.5, 2.0, ym).numpy(),
                               np.asarray(jop.matmat(xm, -0.5, 2.0, ym)),
                               **TOL)
    np.testing.assert_allclose(top.matmat(xm).numpy(),
                               np.asarray(jop.matmat(xm)), **TOL)


def test_spill_and_row_perm_paths_are_exercised():
    _, top = both_ops("spill", ("single", 1, "balanced"))
    assert top.plan.n_aux > 0 and top.plan.row_perm is not None
    dense = top.to_dense()
    x, _ = vectors(3)
    np.testing.assert_allclose(top.matvec(x).numpy(), dense @ x, **TOL)


def test_device_bytes_counts_held_tensors():
    jop, top = both_ops("spill", ("row", 2, "balanced"))
    plan = top.plan
    stream = sum(sm.idx.nbytes + sm.val.nbytes + sm.seg_ids.nbytes
                 for sm in plan.shards)
    aux = sum(sm.aux_rows.nbytes + sm.aux_cols.nbytes + sm.aux_vals.nbytes
              for sm in plan.shards if sm.n_aux)
    assert top.device_bytes == stream + aux + 8 * plan.row_perm.size
    assert (top.stream_bytes, top.padded_slots, top.nnz) == \
        (jop.stream_bytes, jop.padded_slots, jop.nnz)


def test_coerce_policy():
    jop, top = both_ops("small", ("single", 1, "modulo"))
    x, _ = vectors(4)
    for bad in (x.astype(np.int32), x > 0):
        with pytest.raises(TypeError, match="floating dtype"):
            top.matvec(bad)
        with pytest.raises(TypeError, match="floating dtype"):
            jop.matvec(bad)
    with pytest.raises(TypeError, match="floating dtype"):
        top.matvec(torch.from_numpy(x.astype(np.int64)))
    with pytest.raises(TypeError, match="floating dtype"):
        top(x, y=np.zeros(M, np.int32), beta=1.0)
    got64 = top.matvec(x.astype(np.float64))
    assert got64.dtype == torch.float32
    np.testing.assert_allclose(got64.numpy(), top.matvec(x).numpy(), **TOL)
    with pytest.raises(ValueError, match="leading dimension"):
        top.matvec(x[:-1])
    with pytest.raises(ValueError, match="1-D x"):
        top.matvec(x[:, None])
    with pytest.raises(ValueError, match=r"\(K, N\) matrix"):
        top.matmat(x)


def test_spmv_and_from_dense_match_reference():
    r, c, v = random_coo(60, 90, 500, seed=5)
    cfg = CONFIGS["small"]
    jop = jspmv.SerpensSpMV(r, c, v, (60, 90), cfg)
    top = tspmv.SerpensSpMV(r, c, v, (60, 90),
                            TF.SerpensConfig(**SMALL), device="cpu")
    assert top.host.idx.tobytes() == jop.host.idx.tobytes()
    x = np.random.default_rng(6).normal(size=90).astype(np.float32)
    np.testing.assert_allclose(top(x, 2.0).numpy(), np.asarray(jop(x, 2.0)),
                               **TOL)
    dense = np.zeros((60, 90), np.float32)
    np.add.at(dense, (r, c), v)
    tfd = tspmv.from_dense(dense, TF.SerpensConfig(**SMALL), device="cpu")
    jfd = jspmv.from_dense(dense, cfg)
    np.testing.assert_allclose(tfd.matvec(x).numpy(),
                               np.asarray(jfd.matvec(x)), **TOL)
    np.testing.assert_allclose(tfd.to_dense(), dense, **TOL)


def test_backend_is_resolved_against_the_device():
    _, top = both_ops("small", ("single", 1, "modulo"))
    assert top.backend == "torch"
    x, _ = vectors(7)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        top.matvec(x, backend="cuda")
    with pytest.raises(ValueError, match="JAX backend"):
        top.matvec(x, backend="xla")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tspmv.SerpensOperator(top.plan, device="cpu", backend="cuda")


def test_default_device_is_cuda(monkeypatch):
    _, top = both_ops("small", ("single", 1, "modulo"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tspmv.SerpensOperator(top.plan)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.resolve_device("cuda:0")


def test_later_slices_raise_not_implemented():
    """The operator's mesh path is ported (tests/test_torch_mesh_spmv.py
    runs it in gloo worlds against the reference's shard_map, and
    tests/test_torch_mesh_serve.py the registry, service and solvers over
    it); a mesh without an axis is refused before anything runs, by the
    operator and by a solver, and an axis without a mesh by the
    operator."""
    from repro_torch import solvers

    _, top = both_ops("small", ("single", 1, "modulo"))
    assert top.with_mesh(None, "x") is top
    with pytest.raises(ValueError, match="mesh requires axis"):
        top.with_mesh(object(), None)
    with pytest.raises(ValueError, match="must be given together"):
        tspmv.SerpensOperator(top.plan, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="must be given together"):
        tspmv.SerpensOperator(top.plan, device="cpu", axis="x")
    with pytest.raises(ValueError, match="partition must be 'row' or 'col'"):
        tspmv.ShardedSerpensSpMV(None, None, None, (M, K), object(), "x",
                                 "diag")
    with pytest.raises(ValueError, match="mesh requires axis"):
        solvers.pagerank(top, mesh=object())
    # The cost report is ported (tests/test_torch_profile.py).
    assert top.cost_report()["stream_bytes"] == top.stream_bytes
