"""The CUDA kernels on the card, against their plain PyTorch versions.

Marked ``cuda``: every test takes the ``card`` fixture, which skips when
no CUDA device is present.  On a machine with one, run::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_chip.py

Tolerance, elementwise: ``|kernel - plain| <= 1e-5 * (|A| @ |x|) + 1e-6``
— the kernels sum with fp32 atomics, in an order that differs from the
plain ``index_add_`` and from run to run.  The fused solver step's
reductions are also taken in another order than torch's: its scalars must
agree within ``1e-5 * sum(|terms|) + 1e-6`` and its state vectors within
``1e-5`` of the larger of the vector's magnitude before and after the step.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_map

from repro_torch.core import format as TF
from repro_torch.core import partition as TP
from repro_torch.core.features import features_of
from repro_torch.core.registry import MatrixRegistry
from repro_torch.core.spmv import SerpensOperator
from repro_torch.kernels import ops
from repro_torch.kernels import serpens_spmv as ks
from repro_torch.serve.spmv_service import SpMVService
from repro_torch import solvers
from repro_torch.data import matrices as TM
from repro_torch.solvers.cg import _cg_epilogue
from repro_torch.solvers.power_iteration import (_pagerank_epilogue,
                                                 _power_epilogue)

from repro_torch.configs import reduced_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention as tattn
from repro_torch.models.model import LM
from repro_torch.serve.engine import ServeEngine

from torch_port_util import random_coo

pytestmark = pytest.mark.cuda

SMALL = dict(segment_width=64, lanes=8, sublanes=4, raw_window=4)
CONFIGS = {
    "paper": TF.PAPER_CONFIG,
    "optimized": TF.OPTIMIZED_CONFIG,
    "small": TF.SerpensConfig(**SMALL),
    "tpc2": TF.SerpensConfig(segment_width=128, lanes=16, sublanes=8,
                             tiles_per_chunk=2),
    "raw2-bf16": TF.SerpensConfig(**dict(SMALL, raw_window=2),
                                  value_dtype="bfloat16"),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def assert_close(got, want, scale):
    assert got.shape == want.shape and got.is_cuda
    assert bool(torch.isfinite(got).all())
    bad = (got - want).abs() > 1e-5 * scale + 1e-6
    assert not bool(bad.any()), int(bad.sum())


def card_stream(name, dev, m=3000, k=20000, nnz=40000, seed=0):
    cfg = CONFIGS[name]
    r, c, v = random_coo(m, k, nnz, seed=seed, hot_rows=5)
    plan = TP.make_plan(r, c, v, (m, k), cfg, TP.PlanSpec())
    idx, val, seg = ops.device_arrays(plan.shards[0], dev)
    geo = dict(num_rows_padded=plan.out_rows_padded,
               segment_width=cfg.segment_width)
    kp = plan.num_segments_local * cfg.segment_width
    return idx, val, seg, geo, kp, cfg.tiles_per_chunk


# Stream-pass plans forced beside each stream's own: (lane_group, windows,
# splits).  One lane, 3 (a partial last group), 4 and 8 lanes, several
# windows and splits.
SPMV_FORCED = [(1, 3, 2), (4, 1, 4), (4, 2, 3), (8, 3, 1), (8, 1, 5),
               (3, 2, 2)]
SPMV_PLANS = [None] + SPMV_FORCED
SPMV_IDS = ["planned"] + ["lg{}-w{}-s{}".format(*f) for f in SPMV_FORCED]


def forced_plan(idx, rows_padded, forced):
    lg, windows, splits = forced
    return ks.spmv_plan_of(idx.shape[2], rows_padded, min(lg, idx.shape[2]),
                           windows, splits)


def run_spmv(idx, val, seg, x, geo, tpc=1, forced=None):
    """spmv (or, given ``forced``, the runner on that plan); one launch,
    and the plan that ran must be the one asked for."""
    rows = geo["num_rows_padded"]
    before = ks.spmv_launches
    if forced is None:
        plan = ks._card_spmv_plan(idx, rows)
        got = ks.spmv(idx, val, seg, x, tiles_per_chunk=tpc, **geo)
    else:
        plan = forced_plan(idx, rows, forced)
        got = ks._spmv_run(idx, val, seg, x, plan, **geo)
    torch.cuda.synchronize()
    assert ks.spmv_launches == before + 1 and ks.spmv_last_plan == plan
    return got, plan


@pytest.mark.parametrize("forced", SPMV_PLANS, ids=SPMV_IDS)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_spmv_kernel_matches_plain(card, name, forced):
    idx, val, seg, geo, kp, tpc = card_stream(name, card)
    x = torch.randn(kp, device=card)
    got, _ = run_spmv(idx, val, seg, x, geo, tpc, forced)
    assert_close(got, ks.spmv_plain(idx, val, seg, x, **geo),
                 ks.spmv_plain(idx, val.abs(), seg, x.abs(), **geo))


def run_spmm(idx, val, seg, x, geo, tpc=1, plan=None):
    """spmm (or, given a ``plan``, the runner on that plan) and the vector
    width whose counter moved; the launches must match the plan's passes."""
    forced = plan is not None
    if not forced:
        l2 = torch.cuda.get_device_properties(x.device).L2_cache_size
        plan = ks.spmm_plan(x, geo["num_rows_padded"], l2)
    before = (ks.spmm_launches, dict(ks.spmm_launches_by_width))
    if forced:
        got = ks._spmm_run(idx, val, seg, x, plan, **geo)
    else:
        got = ks.spmm(idx, val, seg, x, tiles_per_chunk=tpc, **geo)
    torch.cuda.synchronize()
    moved = {w: c - before[1][w] for w, c in ks.spmm_launches_by_width.items()
             if c != before[1][w]}
    assert moved == {plan.vec: len(plan.windows)}
    assert ks.spmm_launches == before[0] + len(plan.windows)
    return got, plan.vec


def assert_spmm_close(got, idx, val, seg, x, geo):
    assert_close(got, ks.spmm_plain(idx, val, seg, x, **geo),
                 ks.spmm_plain(idx, val.abs(), seg, x.abs(), **geo))


# N -> the vector width an aligned X of N columns runs at.
SPMM_VEC = {1: 1, 2: 2, 3: 1, 4: 4, 8: 4, 16: 4, 17: 1, 64: 4}


@pytest.mark.parametrize("n", sorted(SPMM_VEC))
@pytest.mark.parametrize("name", ["paper", "tpc2", "raw2-bf16"])
def test_spmm_kernel_matches_plain(card, name, n):
    idx, val, seg, geo, kp, tpc = card_stream(name, card)
    x = torch.randn(kp, n, device=card)
    got, vec = run_spmm(idx, val, seg, x, geo, tpc)
    assert vec == SPMM_VEC[n]
    rows = geo["num_rows_padded"]                # a small acc: one pass
    assert ks.spmm_plan(x, rows, 50 << 20).windows == ((0, rows),)
    assert_spmm_close(got, idx, val, seg, x, geo)


@pytest.mark.parametrize("offset,vec", [(1, 1), (2, 2), (3, 1), (4, 4)])
@pytest.mark.parametrize("name", ["paper", "raw2-bf16"])
def test_spmm_on_an_offset_x(card, name, offset, vec):
    """X one or more elements into its storage, as a slice of a padded
    buffer may be: the width follows the real address."""
    idx, val, seg, geo, kp, tpc = card_stream(name, card)
    base = torch.randn(kp * 16 + offset, device=card)
    x = base[offset:].view(kp, 16)
    got, ran = run_spmm(idx, val, seg, x, geo, tpc)
    assert ran == vec
    assert_spmm_close(got, idx, val, seg, x, geo)


@pytest.mark.parametrize("n,vec,passes", [
    (16, 4, 3), (16, 2, 2), (6, 2, 2), (5, 1, 2), (64, 4, 2), (2, 2, 7)])
@pytest.mark.parametrize("name", ["paper", "raw2-bf16"])
def test_spmm_forced_row_windows(card, name, n, vec, passes):
    """Passes over row windows, each applying only the slots of its rows,
    all into the one output."""
    idx, val, seg, geo, kp, _ = card_stream(name, card)
    rows = geo["num_rows_padded"]
    plan = ks.SpmmPlan(vec, tuple((rows * i // passes,
                                   rows * (i + 1) // passes)
                                  for i in range(passes)))
    x = torch.randn(kp, n, device=card)
    got, _ = run_spmm(idx, val, seg, x, geo, plan=plan)
    assert_spmm_close(got, idx, val, seg, x, geo)


def row_0xffff_stream(dev):
    """A stream whose live row 0xFFFF packs into a negative int32."""
    cfg = TF.SerpensConfig(**SMALL)
    m = cfg.lanes * 0x10000
    r = np.array([m - 1, 3], np.int64)
    c = np.array([5, 60], np.int64)
    v = np.array([2.0, -1.0], np.float32)
    sm = TF.encode(r, c, v, (m, 64), cfg)
    idx, val, seg = ops.device_arrays(sm, dev)
    return m, idx, val, seg, sm.padded_rows


def test_row_0xffff_on_the_card(card):
    """65,536 lane-local rows: not one lane fits in shared memory, so the
    plan takes one lane per block in two windows."""
    m, idx, val, seg, rows = row_0xffff_stream(card)
    x = torch.arange(64, dtype=torch.float32, device=card)
    got, plan = run_spmv(idx, val, seg, x,
                         dict(num_rows_padded=rows, segment_width=64))
    assert (plan.lane_group, len(plan.windows)) == (1, 2)
    assert float(got[m - 1]) == 10.0 and float(got[3]) == -60.0
    assert float(got.abs().sum()) == 70.0


@pytest.mark.parametrize("n", [1, 2, 3, 4, 16])
def test_row_0xffff_through_spmm(card, n):
    m, idx, val, seg, rows = row_0xffff_stream(card)
    scale = torch.arange(1, n + 1, dtype=torch.float32, device=card)
    x = torch.arange(64, dtype=torch.float32, device=card)[:, None] * scale
    got, _ = run_spmm(idx, val, seg, x.contiguous(),
                      dict(num_rows_padded=rows, segment_width=64))
    assert torch.equal(got[m - 1], 10.0 * scale)
    assert torch.equal(got[3], -60.0 * scale)
    assert float(got.abs().sum()) == float(70.0 * scale.sum())


def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    idx, val, seg, geo, kp, _ = card_stream("small", card)
    x = torch.randn(kp, 2, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        ks.spmm(idx, val, seg, x.t().contiguous().t(), **geo)
    with pytest.raises(ValueError, match="float32"):
        ks.spmv(idx, val, seg, x[:, 0].double().contiguous(), **geo)
    with pytest.raises(ValueError, match="share one device"):
        ks.spmv(idx, val, seg, x[:, 0].cpu().contiguous(), **geo)
    with pytest.raises(ValueError, match="multiple of segment_width"):
        ks.spmv(idx, val, seg, x[:-1, 0].contiguous(), **geo)
    with pytest.raises(ValueError, match="not a fallback"):
        SerpensOperator(TP.make_plan(*random_coo(30, 40, 90), (30, 40),
                                     CONFIGS["small"], TP.PlanSpec()),
                        device=card, backend="torch")


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["sync", "pipelined"])
def test_service_on_the_card_launches_both_kernels(card, pipelined):
    m, k = 2000, 3000
    r, c, v = random_coo(m, k, 30000, seed=3, hot_rows=4)
    reg = MatrixRegistry(config=TF.OPTIMIZED_CONFIG, device=card)
    mid = reg.put(r, c, v, (m, k))
    with pytest.raises(ValueError, match="registry binds on"):
        SpMVService(reg, device="cpu")
    svc = SpMVService(reg, max_bucket=16, device=card)
    rng = np.random.default_rng(4)
    xs = rng.normal(size=(12, k)).astype(np.float32)
    dense = np.zeros((m, k), np.float64)
    np.add.at(dense, (r, c), v.astype(np.float64))
    before = (ks.spmv_launches, ks.spmm_launches)
    if pipelined:
        # The rest are queued before the stage threads start, so they
        # coalesce into SpMM batches whatever the timing.
        t0 = svc.submit(mid, xs[0], alpha=2.0)
        with svc:
            lone = svc.result(t0, timeout=120)
        tickets = [svc.submit(mid, x) for x in xs[1:]]
        with svc:
            res = [svc.result(t, timeout=120) for t in tickets]
    else:
        t0 = svc.submit(mid, xs[0], alpha=2.0)
        lone = svc.flush()[t0]
        tickets = [svc.submit(mid, x) for x in xs[1:]]
        out = svc.flush()
        res = [out[t] for t in tickets]
    assert (lone.batch_size, lone.bucket_n) == (1, 1)
    assert ks.spmv_launches > before[0] and ks.spmm_launches > before[1]
    np.testing.assert_allclose(lone.y, 2.0 * dense @ xs[0], rtol=1e-4,
                               atol=1e-4)
    for x, got in zip(xs[1:], res):
        np.testing.assert_allclose(got.y, dense @ x, rtol=1e-4, atol=1e-4)
    reg.close()


def test_auto_put_served_on_the_card(card):
    """An auto-tuned entry on the card serves a lone request and a batch
    within the tolerance of fp64, through both stream kernels; after the
    tuner's ranking flips, a re-tune swaps the plan, drops the old
    binding's device bytes, and the new plan serves right too."""
    n = 4000
    r, c, v = TM.power_law_graph(n, 60000, seed=5)
    reg = MatrixRegistry(device=card)
    mid = reg.put(r, c, v, (n, n), spec="auto")
    d = reg.tune_decision(mid)
    assert d.candidate.backend == "cuda" and reg.tuner.backend == "cuda"
    dense = np.zeros((n, n), np.float64)
    np.add.at(dense, (r, c), v.astype(np.float64))
    scale = np.zeros((n, n), np.float64)
    np.add.at(scale, (r, c), np.abs(v.astype(np.float64)))
    xs = np.random.default_rng(6).normal(size=(9, n)).astype(np.float32)

    def serve_and_check():
        svc = SpMVService(reg, max_bucket=8, retune_every=0, device=card)
        before = (ks.spmv_launches, ks.spmm_launches)
        t0 = svc.submit(mid, xs[0])
        out = svc.flush()
        tickets = [svc.submit(mid, x) for x in xs[1:]]
        out.update(svc.flush())
        assert ks.spmv_launches > before[0] and ks.spmm_launches > before[1]
        for t, x in zip([t0] + tickets, xs):
            got = torch.from_numpy(out[t].y)
            assert_close(got.to(card), torch.from_numpy(dense @ x).float()
                         .to(card), torch.from_numpy(scale @ np.abs(x))
                         .float().to(card))
        return svc.snapshot()["tuner_observations"][mid]

    assert serve_and_check() == 2
    held = reg.device_bytes_in_use
    other = next(cand for cand in reg.tuner.candidates(
        features_of(TF.prepare(r, c, v, (n, n), reg.default_config)))
        if cand.key != d.candidate.key)
    reg.tuner.observe(d.bucket, other, slots_per_s=1e15,
                      requests_per_s=1e15)
    assert reg.retune(mid) is True
    assert reg.tune_decision(mid).candidate.key == other.key
    assert reg.device_bytes_in_use == 0 < held
    assert serve_and_check() == 2
    assert reg.get(mid).plan.spec == other.spec
    reg.close()


# -- the fused solver step ----------------------------------------------------
EPILOGUES = {"cg": _cg_epilogue, "pagerank": _pagerank_epilogue,
             "power": _power_epilogue}


def spd_coo(n, nnz, seed):
    """Mirror the upper triangle of a random pattern; diagonal = row's
    sum of |off-diagonal| + 1 (symmetric, diagonally dominant: SPD)."""
    r, c, v = random_coo(n, n, nnz, seed=seed)
    up = r < c
    r, c, v = r[up], c[up], v[up]
    diag = np.bincount(np.concatenate([r, c]),
                       weights=np.abs(np.concatenate([v, v])),
                       minlength=n) + 1.0
    ar = np.arange(n)
    return (np.concatenate([r, c, ar]), np.concatenate([c, r, ar]),
            np.concatenate([v, v, diag.astype(np.float32)]))


def fused_case(name, cfg, dev, n=6000, nnz=60000, seed=0):
    """A square card operator and one solver step's x and extras: CG's
    first iteration, a PageRank step from a random distribution, a power
    step from a random unit vector."""
    r, c, v = spd_coo(n, nnz, seed)
    if name == "pagerank":
        v = TM.column_normalize(r, c, v, n)
    op = SerpensOperator(TP.make_plan(r, c, v, (n, n), cfg, TP.PlanSpec()),
                         device=dev)
    g = torch.Generator(device="cpu").manual_seed(seed)
    if name == "cg":
        b = op.to_acc_layout(torch.randn(n, generator=g).to(dev))
        extras = (torch.zeros_like(b), b.clone(), b.clone(),
                  (b * b).sum().reshape(1, 1))
        x = op.from_acc_layout(extras[2])
    elif name == "pagerank":
        rv = torch.rand(n, generator=g).to(dev)
        extras = (op.to_acc_layout(rv / rv.sum()),
                  op.to_acc_layout(torch.ones(n, device=dev)),
                  torch.tensor([[0.85, n]], device=dev))
        x = op.from_acc_layout(extras[0])
    else:
        vv = torch.randn(n, generator=g).to(dev)
        extras = (op.to_acc_layout(vv / vv.norm()),)
        x = op.from_acc_layout(extras[0])
    return op, x, extras


def scalar_scale(name, i, acc, extras, want):
    """sum(|terms|) of the reduced scalar output i (plain inputs)."""
    if name == "power" and i == 1:                  # λ = Σ v·Av
        return float((extras[0] * acc.view_as(extras[0])).abs().sum())
    return float(want.abs().sum())      # Σ r², Σ|Δr|, ‖Av − λv‖: all terms ≥ 0


# The fused step's stream pass on forced plans too: several windows and
# splits (acc zeroed first), and one split whose plain stores must write
# every element of the uninitialised acc, with a partial last group.
FUSED_FORCED = [(1, 2, 3), (4, 2, 2), (8, 1, 4), (3, 1, 1)]


@pytest.mark.parametrize("forced", [None] + FUSED_FORCED,
                         ids=["planned"] + ["lg{}-w{}-s{}".format(*f)
                                            for f in FUSED_FORCED])
@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
@pytest.mark.parametrize("name", sorted(EPILOGUES))
def test_fused_kernel_matches_plain(card, name, cfg_name, forced):
    op, x, extras = fused_case(name, CONFIGS[cfg_name], card)
    ep = EPILOGUES[name]
    if not op.supports_fused_epilogue:
        with pytest.raises(ValueError, match="fused epilogue needs"):
            op.matvec_fused(x, ep, extras=extras)
        return
    idx, val, seg = op._shards[0]
    geo = dict(num_rows_padded=op.plan.out_rows_padded,
               segment_width=op.config.segment_width)
    want_acc, want = ks.spmv_fused_plain(idx, val, seg, x, extras,
                                         epilogue=ep, **geo)
    scale = ks.spmv_plain(idx, val.abs(), seg,
                          ops.pad_x(x.abs(), op.plan.num_segments_local,
                                    op.config.segment_width), **geo)
    k_extras = tuple(e.clone() for e in extras)
    kx = op.from_acc_layout(k_extras[0 if name != "cg" else 2])
    before = ks.spmv_fused_launches
    spec = ks._EPILOGUES[ep]
    if forced is None:
        plan = ks._card_spmv_plan(idx, geo["num_rows_padded"])
        acc, got = op.matvec_fused(kx, ep, extras=k_extras)
    else:
        plan = forced_plan(idx, geo["num_rows_padded"], forced)
        loop = ks.FusedLoop(card, stop=-float("inf"), max_iters=1,
                            scalars=(0.0,) * spec.scalars)
        acc, got = ks._spmv_fused_run(spec, loop, idx, val, seg, kx,
                                      k_extras, plan, **geo)
    torch.cuda.synchronize()
    assert ks.spmv_fused_launches == before + 1
    assert ks.spmv_last_plan == plan
    assert_close(acc, want_acc, scale)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        err = float((g - w).abs().max())
        if i < len(spec.state):
            assert g is k_extras[spec.state[i]]          # in place
            mag = max(float(w.abs().max()),
                      float(extras[spec.state[i]].abs().max()))
            assert err <= 1e-5 * mag, (i, err, mag)
        else:
            assert err <= 1e-5 * scalar_scale(name, i, want_acc, extras,
                                              w) + 1e-6, (i, err)


def test_unregistered_epilogue_raises_on_the_card(card):
    op, x, extras = fused_case("power", CONFIGS["small"], card, n=500,
                               nnz=3000)

    def double(acc2, v2):
        return (2.0 * acc2 + v2,)

    before = ks.spmv_fused_launches
    with pytest.raises(ValueError, match="not registered"):
        op.matvec_fused(x, double, extras=extras)
    assert ks.spmv_fused_launches == before


@pytest.mark.parametrize("kind", ["pagerank", "cg", "power_iteration"])
def test_small_solve_on_the_card(card, kind):
    cfg = CONFIGS["paper"]
    r, c, v = spd_coo(4000, 40000, seed=1)
    if kind == "pagerank":
        v = TM.column_normalize(r, c, v, 4000)
    plan = TP.make_plan(r, c, v, (4000, 4000), cfg, TP.PlanSpec())
    op = SerpensOperator(plan, device=card)
    cpu = SerpensOperator(plan, device="cpu")
    b = np.random.default_rng(2).normal(size=4000).astype(np.float32)
    kw = {"pagerank": dict(tol=1e-6, max_iters=200),
          "cg": dict(b=b, tol=1e-6),
          "power_iteration": dict(tol=1e-5, max_iters=100)}[kind]
    before = ks.spmv_fused_launches
    fused = solvers.solve(op, kind, fused=True, **kw)
    launched = ks.spmv_fused_launches - before
    unfused = solvers.solve(op, kind, fused=False, **kw)
    plain = solvers.solve(cpu, kind, **kw)
    assert fused.fused and not unfused.fused
    assert launched >= fused.iterations > 0
    assert fused.host_syncs <= -(-fused.iterations // 8) + 1
    for other in (unfused, plain):
        assert abs(fused.iterations - other.iterations) <= 1
        np.testing.assert_allclose(fused.x.cpu().numpy(),
                                   other.x.cpu().numpy(), rtol=1e-3,
                                   atol=1e-5)
    if kind != "power_iteration":
        assert fused.converged


def test_service_solve_on_the_card(card):
    r, c, v = spd_coo(3000, 30000, seed=4)
    reg = MatrixRegistry(config=CONFIGS["paper"], device=card)
    mid = reg.put(r, c, TM.column_normalize(r, c, v, 3000), (3000, 3000))
    svc = SpMVService(reg, device=card)
    before = ks.spmv_fused_launches
    res = svc.solve(mid, "pagerank", tol=1e-6, max_iters=200)
    assert res.solve.fused and res.solve.converged
    assert ks.spmv_fused_launches - before >= res.solve.iterations
    assert abs(float(res.y.sum()) - 1.0) < 1e-3
    with svc:
        t = svc.submit_solve(mid, "power_iteration", max_iters=20)
        res2 = svc.result(t, timeout=120)
    assert res2.solve.iterations == 20 and res2.solve.fused
    reg.close()


# -- flash attention ----------------------------------------------------------
FLASH_SHAPES = {            # b, sq, sk, kv, g, dh, dv, causal
    "gqa": (2, 64, 64, 2, 3, 16, 16, True),
    "dv-ne-dh": (1, 100, 100, 1, 4, 32, 24, True),
    "non-causal": (2, 80, 80, 2, 1, 16, 16, False),
    "ragged": (1, 33, 33, 2, 2, 8, 8, True),
    "sq-lt-sk": (1, 50, 70, 2, 2, 16, 16, True),
    "sq-gt-sk": (1, 70, 50, 2, 2, 16, 16, True),   # rows past Sk see all
    "dh128-gqa": (1, 200, 200, 2, 4, 128, 128, True),
    "dh96-dv64": (2, 130, 130, 2, 2, 96, 64, False),
    "odd-dims": (1, 45, 45, 2, 2, 20, 13, True),   # no 16-byte rows
}
# The bf16 bodies against plain in norm: ||Δ|| <= FLASH_BF16_REL·||plain||
# (chip_smoke.py's bound, which a kernel that drops one kv tile fails).
FLASH_BF16_REL = 5e-3


def flash_inputs(card, dtype, b, sq, sk, kv, g, dh, dv, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn((b, sq, kv, g, dh), generator=gen, device=card)
    k = torch.randn((b, sk, kv, dh), generator=gen, device=card)
    v = torch.randn((b, sk, kv, dv), generator=gen, device=card)
    return q.to(dtype), k.to(dtype), v.to(dtype)


def run_flash(q, k, v, causal=True):
    """The kernel's output and the body it ran, read from the counters."""
    before = dict(fa.flash_launches_by_body)
    total = fa.flash_launches
    got = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    ran = [n for n, c in fa.flash_launches_by_body.items()
           if c != before[n]]
    assert fa.flash_launches == total + 1 and len(ran) == 1
    return got, ran[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", sorted(FLASH_SHAPES))
def test_flash_kernel_matches_plain(card, shape, dtype):
    b, sq, sk, kv, g, dh, dv, causal = FLASH_SHAPES[shape]
    q, k, v = flash_inputs(card, dtype, b, sq, sk, kv, g, dh, dv, sq + dh)
    got, body = run_flash(q, k, v, causal)
    # bf16 runs the wgmma body only at dh = dv in {64, 128}; odd dims and
    # the other head dims take the mma body.
    assert body == ("fma" if dtype == torch.float32 else
                    "wgmma" if shape == "dh128-gqa" else "mma")
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == want.shape
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


# The wgmma body's shapes: b, sq, sk, kv, g, d, causal.  Ragged S with
# B >= 2 (a tile that crossed a batch would read the next one's rows),
# chatglm3's GQA (G = 16), non-causal, Sq < Sk, and Sq > Sk (causal rows
# past Sk see every key: q and k both count from 0).
WGMMA_SHAPES = {
    "d64-s130": (2, 130, 130, 2, 1, 64, True),
    "d128-s130": (2, 130, 130, 2, 2, 128, True),
    "d64-s2000": (2, 2000, 2000, 4, 1, 64, True),
    "d128-s2000": (2, 2000, 2000, 2, 1, 128, True),
    "chatglm3-g16": (1, 600, 600, 2, 16, 128, True),
    "d64-non-causal": (2, 300, 300, 2, 2, 64, False),
    "d128-non-causal": (2, 300, 300, 2, 1, 128, False),
    "d64-sq-lt-sk": (2, 200, 333, 2, 2, 64, True),
    "d128-sq-lt-sk": (2, 77, 260, 1, 3, 128, True),
    "d64-sq-gt-sk": (2, 333, 200, 2, 2, 64, True),
    "d128-sq-gt-sk": (1, 260, 77, 1, 3, 128, True),
    "d64-one-row": (3, 1, 1, 2, 1, 64, True),
}


@pytest.mark.parametrize("shape", sorted(WGMMA_SHAPES))
def test_flash_wgmma_body_matches_plain(card, shape):
    b, sq, sk, kv, g, d, causal = WGMMA_SHAPES[shape]
    q, k, v = flash_inputs(card, torch.bfloat16, b, sq, sk, kv, g, d, d,
                           sq + sk + d)
    got, body = run_flash(q, k, v, causal)
    assert body == "wgmma"
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    err = (got.float() - want.float()).norm() / want.float().norm()
    assert float(err) <= FLASH_BF16_REL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_flash_kernel_on_misaligned_inputs(card, dtype):
    """Contiguous tensors that start one element into their storage: the
    kernel must not take its 16-byte loads there, and in bf16 the shape
    rule sends them to the mma body."""
    gen = torch.Generator(device=card).manual_seed(1)

    def shifted(shape):
        n = int(np.prod(shape))
        base = torch.randn(n + 1, generator=gen, device=card).to(dtype)
        return base[1:].view(shape)

    q, k, v = shifted((2, 70, 2, 2, 64)), shifted((2, 70, 2, 64)), \
        shifted((2, 70, 2, 64))
    assert q.data_ptr() % 16 != 0 and q.is_contiguous()
    got, body = run_flash(q, k, v)
    assert body == ("fma" if dtype == torch.float32 else "mma")
    want = fa.flash_attention_plain(q, k, v)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_flash_wrapper_refuses_what_the_kernel_does_not_take(card):
    q = torch.randn((1, 16, 2, 2, 16), device=card)
    k = torch.randn((1, 16, 2, 16), device=card)
    v = torch.randn((1, 16, 2, 16), device=card)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                           k, v)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="up to 128"):
        fa.flash_attention(torch.randn((1, 16, 2, 2, 160), device=card),
                           torch.randn((1, 16, 2, 160), device=card), v)
    with pytest.raises(ValueError, match="cpu"):
        fa.flash_attention(q, k.cpu(), v)
    with pytest.raises(TypeError):
        fa.flash_attention(q, k, v, prefix_len=4)
    cfg = reduced_config("qwen1.5-0.5b")
    p = tattn.attn_init(torch.Generator(device=card).manual_seed(0), cfg,
                        torch.float32)
    with pytest.raises(NotImplementedError, match="VLM"):
        tattn.attn_forward(p, torch.randn((1, 8, 64), device=card), cfg,
                           prefix_len=4)


def test_reduced_lm_generate_on_the_card(card):
    """The card's prefill runs the kernel once per layer and matches the
    CPU model; greedy tokens agree."""
    cfg = reduced_config("qwen1.5-0.5b")
    lm = LM(cfg)
    params = lm.init(torch.Generator().manual_seed(0))
    on_card = tree_map(lambda t: t.to(card), params)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 40)))
    before = fa.flash_launches
    logits, _ = lm.prefill(on_card, {"inputs": toks.to(card)}, 48)
    assert fa.flash_launches - before == cfg.num_layers
    want, _ = lm.prefill(params, {"inputs": toks}, 48)
    torch.testing.assert_close(logits.cpu(), want, rtol=1e-4, atol=1e-4)
    got = ServeEngine(lm, on_card, 48).generate({"inputs": toks.to(card)}, 6)
    ref = ServeEngine(lm, params, 48).generate({"inputs": toks}, 6)
    assert torch.equal(got.cpu(), ref)


def test_cost_report_measures_on_the_card(card):
    """``cost_report(measure=True)`` times the matvec with CUDA events: a
    positive time, at most the card's memory rate (with a margin for the
    data-sheet figure)."""
    r, c, v = random_coo(20000, 30000, 400000, seed=8, hot_rows=5)
    reg = MatrixRegistry(device=card)
    op = reg.get(reg.put(r, c, v, (20000, 30000)))
    rep = op.cost_report(measure=True, iters=20)
    assert rep["measured_matvec_s"] > 0
    assert rep["measured_matvec_s"] >= rep["est_stream_s"]
    assert 0 < rep["roofline_fraction"] <= 1.05
    assert rep["assumed_bandwidth_gbps"] == 3350.0
    modeled = op.cost_report()
    assert modeled["stream_bytes"] == rep["stream_bytes"]


@pytest.mark.parametrize("batch", [None, 1, 4, 40])
def test_sparse_linear_on_the_card_matches_its_cpu_run(card, batch):
    """Rank 1 launches the spmv kernel, rank 2 the SpMM kernel (a batch of
    40 too), each within the kernels' tolerance of the CPU run."""
    from repro_torch.core.sparse_linear import SparseLinear
    rng = np.random.default_rng(9)
    w = rng.normal(size=(2816, 1024)).astype(np.float32)
    b = rng.normal(size=2816).astype(np.float32)
    on_card = SparseLinear.from_dense(w, density=0.15, bias=b, device=card)
    on_cpu = SparseLinear.from_dense(w, density=0.15, bias=b, device="cpu")
    x = rng.normal(size=(1024,) if batch is None
                   else (batch, 1024)).astype(np.float32)
    spmv0, spmm0 = ks.spmv_launches, ks.spmm_launches
    got = on_card(x)
    torch.cuda.synchronize()
    if batch is None:
        assert ks.spmv_launches == spmv0 + 1 and ks.spmm_launches == spmm0
    else:
        assert ks.spmm_launches > spmm0 and ks.spmv_launches == spmv0
    assert got.is_cuda
    want = on_cpu(x)
    wp = np.abs(on_cpu.op.to_dense()).astype(np.float64)
    scale = np.abs(x) @ wp.T if batch else wp @ np.abs(x)
    assert_close(got, want.to(card),
                 torch.from_numpy(scale).float().to(card))


def test_bf16_put_verifies_full_on_the_card(card):
    """A bf16 put gated by ``verify="full"`` installs and serves on the
    card; a corrupted plan is refused."""
    from repro_torch.analysis.verify import VerificationError
    from repro_torch.core import registry as R
    r, c, v = random_coo(3000, 20000, 40000, seed=10, hot_rows=5)
    reg = MatrixRegistry(device=card, verify="full",
                         config=CONFIGS["raw2-bf16"])
    mid = reg.put(r, c, v, (3000, 20000), value_dtype="bfloat16")
    op = reg.get(mid)
    assert op.value_dtype == "bfloat16" and op.device.type == "cuda"
    x = np.random.default_rng(11).normal(size=20000).astype(np.float32)
    xc = x.astype(np.float64)[c]
    want = np.bincount(r, weights=v * xc, minlength=3000)
    # bf16 values: within the reference's bound 2^-8 (|A| |x|).
    bound = 2.0 ** -8 * np.bincount(r, weights=np.abs(v * xc),
                                    minlength=3000) + 1e-6
    assert np.all(np.abs(op.matvec(x).cpu().numpy() - want) <= bound)
    bad = op.plan
    seg = np.array(bad.shards[0].seg_ids)
    seg[0], seg[-1] = seg[-1], seg[0]
    shard = dataclasses.replace(bad.shards[0], seg_ids=seg)
    bad = dataclasses.replace(bad, shards=[shard], seg_ids=seg[None])
    with pytest.raises(VerificationError, match="seg-monotone"):
        R.verify_gate(bad, r, c, v, "fast")
