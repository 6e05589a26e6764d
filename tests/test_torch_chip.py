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
import os
import sys

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

from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models.layers import rms_norm
from repro_torch.models.model import LM, _cross_kv
from repro_torch.serve.engine import ServeEngine

from torch_port_util import random_coo

sys.path.append(os.path.join(os.path.dirname(__file__), ".."))
# Phase 9's control, phase 10's bound, controls and patching helper,
# phase 11's bound and control, and phase 5's misaligned copy.
from chip_smoke import (MLA_LAYER_REL, WHISPER_LAYER_REL,  # noqa: E402
                        causal_cross, dropped_carry, nope_first, offset_copy,
                        patched, without_kv_norm)

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
    "mla-heads": (2, 1000, 1000, 8, 1, 96, 64, True),   # minicpm3's dims
    # Whisper's cross-attention: no causal diagonal stops the key loop,
    # and the last key tile is ragged.
    "non-causal-sq-lt-sk": (1, 50, 170, 2, 2, 16, 16, False),
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
    # bf16 runs the wgmma body only at (dh, dv) in {(64, 64), (128, 128),
    # (96, 64), (256, 256)}; odd dims and the other head dims take the mma
    # body.
    assert body == ("fma" if dtype == torch.float32 else
                    "wgmma" if shape in ("dh128-gqa", "dh96-dv64",
                                         "mla-heads") else "mma")
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == want.shape
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


# The wgmma body's shapes: b, sq, sk, kv, g, dh, dv, causal.  Ragged S
# with B >= 2 (a tile that crossed a batch would read the next one's
# rows), chatglm3's GQA (G = 16), non-causal, Sq < Sk, and Sq > Sk (causal
# rows past Sk see every key: q and k both count from 0); each at
# (dh, dv) = (96, 64) too, where the second q/k column box runs past the
# tensor's 96 columns, and minicpm3's MLA heads (G = 1, 40 heads).
# Whisper's served shapes are non-causal: the encoder over 1500 frames
# (1500 = 11 key tiles of 128 and a ragged 92), and the cross-attention
# of a 192-token prompt, or of the 4 start-of-transcript tokens, over
# them.
WGMMA_SHAPES = {
    "d64-s130": (2, 130, 130, 2, 1, 64, 64, True),
    "d128-s130": (2, 130, 130, 2, 2, 128, 128, True),
    "d64-s2000": (2, 2000, 2000, 4, 1, 64, 64, True),
    "d128-s2000": (2, 2000, 2000, 2, 1, 128, 128, True),
    "chatglm3-g16": (1, 600, 600, 2, 16, 128, 128, True),
    "d64-non-causal": (2, 300, 300, 2, 2, 64, 64, False),
    "d128-non-causal": (2, 300, 300, 2, 1, 128, 128, False),
    "d64-sq-lt-sk": (2, 200, 333, 2, 2, 64, 64, True),
    "d128-sq-lt-sk": (2, 77, 260, 1, 3, 128, 128, True),
    "d64-sq-gt-sk": (2, 333, 200, 2, 2, 64, 64, True),
    "d128-sq-gt-sk": (1, 260, 77, 1, 3, 128, 128, True),
    "d64-one-row": (3, 1, 1, 2, 1, 64, 64, True),
    "llama4-g5": (1, 256, 256, 8, 5, 128, 128, True),
    "mla-s130": (2, 130, 130, 3, 1, 96, 64, True),
    "mla-gqa-s130": (2, 130, 130, 2, 2, 96, 64, True),
    "mla-non-causal": (2, 300, 300, 2, 1, 96, 64, False),
    "mla-sq-lt-sk": (2, 200, 333, 2, 1, 96, 64, True),
    "mla-sq-gt-sk": (2, 333, 200, 2, 1, 96, 64, True),
    "mla-one-row": (3, 1, 1, 2, 1, 96, 64, True),
    "mla-heads": (4, 2000, 2000, 40, 1, 96, 64, True),
    "d64-cross": (2, 192, 1500, 8, 1, 64, 64, False),
    "d64-cross-sot": (3, 4, 1500, 8, 1, 64, 64, False),
    "d64-encoder": (2, 1500, 1500, 8, 1, 64, 64, False),
    # paligemma's heads at its served Sq = 320: 64-key tiles, the first
    # consumer skipping the second's diagonal tile, and the third q tile's
    # second consumer all padding (rows 320-383).
    "d256-s320": (2, 320, 320, 1, 8, 256, 256, True),
}


def check_bf16_flash(got, want):
    """A bf16 body against plain: elementwise within 2e-2 and
    ||Δ|| <= FLASH_BF16_REL·||plain||."""
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    err = (got.float() - want.float()).norm() / want.float().norm()
    assert float(err) <= FLASH_BF16_REL


@pytest.mark.parametrize("shape", sorted(WGMMA_SHAPES))
def test_flash_wgmma_body_matches_plain(card, shape):
    b, sq, sk, kv, g, dh, dv, causal = WGMMA_SHAPES[shape]
    q, k, v = flash_inputs(card, torch.bfloat16, b, sq, sk, kv, g, dh, dv,
                           sq + sk + dh)
    got, body = run_flash(q, k, v, causal)
    assert body == "wgmma"
    check_bf16_flash(got, fa.flash_attention_plain(q, k, v, causal=causal))


@pytest.mark.parametrize("shape", ["mla-s130", "mla-non-causal",
                                   "mla-heads"])
def test_flash_mma_body_at_the_mla_pair(card, shape):
    """The mma body still takes (96, 64) where the wgmma body cannot:
    the same tensors one element into their storage."""
    b, sq, sk, kv, g, dh, dv, causal = WGMMA_SHAPES[shape]
    q, k, v = flash_inputs(card, torch.bfloat16, b, sq, sk, kv, g, dh, dv,
                           sq + sk + dh)
    got, body = run_flash(*map(offset_copy, (q, k, v)), causal)
    assert body == "mma"
    check_bf16_flash(got, fa.flash_attention_plain(q, k, v, causal=causal))


# The prefix-LM mask (prefix_len: keys before it seen by every row) on
# every body: body -> (dtype, dh, dv, offset copy).  The wgmma body takes
# the served heads, paligemma's 256 on 64-key tiles among them; the mma
# body the same heads one element into their storage; the fma body fp32
# at 64 and 256.
PREFIX_BODIES = {
    "wgmma-d64": (torch.bfloat16, 64, 64, False),
    "wgmma-d128": (torch.bfloat16, 128, 128, False),
    "wgmma-mla": (torch.bfloat16, 96, 64, False),
    "wgmma-d256": (torch.bfloat16, 256, 256, False),
    "mma-d64": (torch.bfloat16, 64, 64, True),
    "mma-d256": (torch.bfloat16, 256, 256, True),
    "fma-d64": (torch.float32, 64, 64, False),
    "fma-d256": (torch.float32, 256, 256, False),
}
# b, sq, sk, kv, g, prefix: aligned to the wgmma body's 128-key tile (and
# two of the others' 64), ragged (200 straddles a tile of every body), a
# prefix at and past Sq (every key seen: non-causal), Sq < Sk and Sq > Sk
# (q and k positions both from 0, as the causal mask counts them).
PREFIX_SHAPES = {
    "aligned": (2, 300, 300, 1, 4, 128),
    "ragged": (2, 300, 300, 2, 2, 200),
    "at-sq": (1, 150, 150, 2, 1, 150),
    "past-sq": (2, 130, 130, 1, 2, 1000),
    "sq-lt-sk": (2, 200, 333, 2, 1, 250),
    "sq-gt-sk": (1, 333, 200, 1, 2, 64),
    "paligemma-g8": (2, 320, 320, 1, 8, 256),
}


@pytest.mark.parametrize("shape", sorted(PREFIX_SHAPES))
@pytest.mark.parametrize("body", sorted(PREFIX_BODIES))
def test_flash_prefix_mask_matches_plain(card, body, shape):
    """Each body against ``flash_attention_plain`` with the same prefix;
    the same call with ``prefix_len=0`` (the control) must fail it."""
    dtype, dh, dv, offset = PREFIX_BODIES[body]
    b, sq, sk, kv, g, prefix = PREFIX_SHAPES[shape]
    q, k, v = flash_inputs(card, dtype, b, sq, sk, kv, g, dh, dv,
                           sq + sk + dh + prefix)
    want = fa.flash_attention_plain(q, k, v, prefix_len=prefix)
    if offset:
        q, k, v = map(offset_copy, (q, k, v))
    before = dict(fa.flash_launches_by_body)
    got = fa.flash_attention(q, k, v, prefix_len=prefix)
    ctl = fa.flash_attention(q, k, v, prefix_len=0)
    torch.cuda.synchronize()
    ran = {n: c - before[n] for n, c in fa.flash_launches_by_body.items()}
    assert ran == {n: 2 * (n == body.split("-")[0]) for n in ran}
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
        with pytest.raises(AssertionError):
            torch.testing.assert_close(ctl, want, rtol=2e-5, atol=2e-5)
    else:
        check_bf16_flash(got, want)
        with pytest.raises(AssertionError):
            check_bf16_flash(ctl, want)


# Heads of 256 (and others above 128): (256, 256) on the wgmma body when
# aligned, every other bf16 pair and every offset copy on the mma body,
# fp32 on the fma body: b, sq, sk, kv, g, dh, dv, causal.
D256_SHAPES = {
    "d256-causal": (2, 200, 200, 1, 8, 256, 256, True),
    "d256-non-causal": (2, 130, 170, 1, 2, 256, 256, False),
    "d256-sq-lt-sk": (1, 77, 260, 2, 1, 256, 256, True),
    "d256-dv128": (1, 100, 100, 2, 1, 256, 128, True),
    "d136-dv200": (1, 70, 70, 1, 2, 136, 200, False),
    "d250-odd": (1, 45, 45, 1, 2, 250, 250, True),
}


@pytest.mark.parametrize("offset", [False, True], ids=["aligned", "offset"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", sorted(D256_SHAPES))
def test_flash_wide_heads_match_plain(card, shape, dtype, offset):
    """Head dims past 128: the wgmma body at (256, 256) in bf16 on
    aligned tensors, the 256-column mma (other bf16) and fma (fp32) bodies
    otherwise; ``offset`` gives them copies one element into their
    storage, where no 16-byte load may be taken (the mma body's
    (256, 256))."""
    b, sq, sk, kv, g, dh, dv, causal = D256_SHAPES[shape]
    q, k, v = flash_inputs(card, dtype, b, sq, sk, kv, g, dh, dv,
                           sq + sk + dh)
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    if offset:
        q, k, v = map(offset_copy, (q, k, v))
        assert q.data_ptr() % 16 != 0
    got, body = run_flash(q, k, v, causal)
    assert body == ("fma" if dtype == torch.float32 else
                    "wgmma" if (dh, dv) == (256, 256) and not offset
                    else "mma")
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    else:
        check_bf16_flash(got, want)


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
    with pytest.raises(ValueError, match="up to 256"):
        fa.flash_attention(torch.randn((1, 16, 2, 2, 264), device=card),
                           torch.randn((1, 16, 2, 264), device=card), v)
    with pytest.raises(ValueError, match="up to 256"):
        fa.flash_attention(q, k, torch.randn((1, 16, 2, 272), device=card))
    with pytest.raises(ValueError, match="cpu"):
        fa.flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError, match="prefix_len"):
        fa.flash_attention(q, k, v, prefix_len=-1)


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


def test_reduced_moe_lm_generate_on_the_card(card):
    """Reduced llama4-scout: the card's prefill runs the kernel once per
    layer and its logits match the CPU model's; greedy tokens agree."""
    cfg = reduced_config("llama4-scout-17b-a16e")
    lm = LM(cfg)
    params = lm.init(torch.Generator().manual_seed(0))
    on_card = tree_map(lambda t: t.to(card), params)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 40)))
    before = fa.flash_launches
    logits, _ = lm.prefill(on_card, {"inputs": toks.to(card)}, 48)
    assert fa.flash_launches - before == cfg.num_layers
    want, _ = lm.prefill(params, {"inputs": toks}, 48)
    torch.testing.assert_close(logits.cpu(), want, rtol=1e-4, atol=1e-4)
    got = ServeEngine(lm, on_card, 48).generate({"inputs": toks.to(card)}, 6)
    ref = ServeEngine(lm, params, 48).generate({"inputs": toks}, 6)
    assert torch.equal(got.cpu(), ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-1.5-large-398b"])
def test_reduced_ssm_lm_generate_on_the_card(card, arch, dtype):
    """Reduced mamba2 and jamba on the card against the same model on the
    CPU.  The 33-token prompt's last token opens a third 16-step chunk, so
    it sees the earlier tokens only through the carried state.  fp32:
    last-position logits within 1e-4 and greedy tokens equal; the control,
    the CPU's prefill without the inter-chunk carry, must fail.  bf16: the
    card's logits lie no farther, in norm, from an fp32 run of the same
    weights than twice the CPU's bf16 logits do (each framework rounds
    at its own points; jamba's eight bf16 sub-layers put card and CPU
    0.07 apart at most), and first tokens equal the CPU's wherever its
    top two lie more than twice the measured |Δ| apart.  The flash kernel
    runs once per attention layer (jamba's one)."""
    cfg = dataclasses.replace(reduced_config(arch), param_dtype=dtype,
                              activation_dtype=dtype)
    lm = LM(cfg)
    params = lm.init(torch.Generator().manual_seed(0))
    on_card = tree_map(lambda t: t.to(card), params)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 33)))
    attn_layers = cfg.num_periods * sum(m == "attn" for m, _ in cfg.layout)
    before = fa.flash_launches
    logits, _ = lm.prefill(on_card, {"inputs": toks.to(card)}, 48)
    assert fa.flash_launches - before == attn_layers
    want, _ = lm.prefill(params, {"inputs": toks}, 48)
    got, real = logits.cpu(), slice(0, cfg.vocab_size)
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tssm, "_ssd_chunk", dropped_carry(tssm._ssd_chunk))
            ctl, _ = lm.prefill(params, {"inputs": toks}, 48)
        assert float((got - ctl)[:, real].abs().max()) > 1e-4
        out = ServeEngine(lm, on_card, 48).generate(
            {"inputs": toks.to(card)}, 6)
        ref = ServeEngine(lm, params, 48).generate({"inputs": toks}, 6)
        assert torch.equal(out.cpu(), ref)
    else:
        cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                    activation_dtype="float32")
        exact, _ = LM(cfg32).prefill(tree_map(lambda t: t.float(), params),
                                     {"inputs": toks}, 48)
        exact = exact[:, real]

        def dist(x):
            return float((x[:, real] - exact).norm() / exact.norm())

        assert dist(got) <= 2 * dist(want), (dist(got), dist(want))
        d = float((got - want)[:, real].abs().max())
        top2 = want[:, real].topk(2, dim=-1).values
        for i, gap in enumerate((top2[:, 0] - top2[:, 1]).tolist()):
            if gap > 2 * d:
                assert int(got[i, real].argmax()) == \
                    int(want[i, real].argmax())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_mla_lm_generate_on_the_card(card, dtype):
    """Reduced minicpm3 (rope 8 + nope 8, v 24: dv > dh) on the card
    against the same model on the CPU; its prefill runs the flash kernel
    once per layer, on the fma body in fp32 and the mma body in bf16.
    fp32: last-position logits within 1e-4 and greedy tokens equal.  bf16:
    the card's logits lie no farther, in norm, from an fp32 run of the
    same weights than twice the CPU's bf16 logits do."""
    cfg = dataclasses.replace(reduced_config("minicpm3-4b"),
                              param_dtype=dtype, activation_dtype=dtype)
    lm = LM(cfg)
    params = lm.init(torch.Generator().manual_seed(0))
    on_card = tree_map(lambda t: t.to(card), params)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 40)))
    body = "fma" if dtype == "float32" else "mma"
    before = fa.flash_launches_by_body[body]
    logits, _ = lm.prefill(on_card, {"inputs": toks.to(card)}, 48)
    assert fa.flash_launches_by_body[body] - before == cfg.num_layers
    want, _ = lm.prefill(params, {"inputs": toks}, 48)
    got, real = logits.cpu(), slice(0, cfg.vocab_size)
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        out = ServeEngine(lm, on_card, 48).generate(
            {"inputs": toks.to(card)}, 6)
        ref = ServeEngine(lm, params, 48).generate({"inputs": toks}, 6)
        assert torch.equal(out.cpu(), ref)
    else:
        cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                    activation_dtype="float32")
        exact, _ = LM(cfg32).prefill(tree_map(lambda t: t.float(), params),
                                     {"inputs": toks}, 48)
        exact = exact[:, real]

        def dist(x):
            return float((x[:, real] - exact).norm() / exact.norm())

        assert dist(got) <= 2 * dist(want), (dist(got), dist(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_whisper_generate_on_the_card(card, dtype):
    """Reduced whisper-base (2 encoder and 2 decoder layers, dh 16) on
    the card against the same model on the CPU.  Its prefill runs the
    flash kernel three times a layer pair (encoder, decoder self, cross),
    on the fma body in fp32 and the mma body in bf16.  fp32: logits
    within 1e-4 and greedy tokens equal.  bf16: the card's logits lie no
    farther, in norm, from an fp32 run of the same weights than twice the
    CPU's bf16 logits do."""
    cfg = dataclasses.replace(reduced_config("whisper-base"),
                              param_dtype=dtype, activation_dtype=dtype)
    lm = LM(cfg)
    params = lm.init(torch.Generator().manual_seed(0))
    on_card = tree_map(lambda t: t.to(card), params)
    rng = np.random.default_rng(4)
    batch = {"inputs": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, 20))),
        "frames": torch.from_numpy(rng.standard_normal(
            (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32))}
    gbatch = {k: t.to(card) for k, t in batch.items()}
    body = "fma" if dtype == "float32" else "mma"
    before = fa.flash_launches_by_body[body]
    logits, _ = lm.prefill(on_card, gbatch, 32)
    assert fa.flash_launches_by_body[body] - before == \
        cfg.encoder_layers + 2 * cfg.num_layers
    want, _ = lm.prefill(params, batch, 32)
    got, real = logits.cpu(), slice(0, cfg.vocab_size)
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        out = ServeEngine(lm, on_card, 32).generate(gbatch, 8)
        ref = ServeEngine(lm, params, 32).generate(batch, 8)
        assert torch.equal(out.cpu(), ref)
    else:
        cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                    activation_dtype="float32")
        exact, _ = LM(cfg32).prefill(tree_map(lambda t: t.float(), params),
                                     batch, 32)
        exact = exact[:, real]

        def dist(x):
            return float((x[:, real] - exact).norm() / exact.norm())

        assert dist(got) <= 2 * dist(want), (dist(got), dist(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_paligemma_generate_on_the_card(card, dtype):
    """Reduced paligemma-3b (8 vision tokens, 2 layers, heads of 16 over
    1 KV head) on the card against the same model on the CPU.  Its
    prefill runs the flash kernel once a layer with the prefix, on the
    fma body in fp32 and the mma body in bf16.  fp32: logits within 1e-4
    and greedy tokens equal.  bf16: the card's logits lie no farther, in
    norm, from an fp32 run of the same weights than twice the CPU's bf16
    logits do."""
    cfg = dataclasses.replace(reduced_config("paligemma-3b"),
                              param_dtype=dtype, activation_dtype=dtype)
    lm = LM(cfg)
    params = lm.init(torch.Generator().manual_seed(0))
    on_card = tree_map(lambda t: t.to(card), params)
    rng = np.random.default_rng(5)
    batch = {"inputs": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, 40))),
        "patches": torch.from_numpy(rng.standard_normal(
            (2, cfg.vision_tokens, cfg.vision_embed_dim)).astype(
                np.float32))}
    gbatch = {k: t.to(card) for k, t in batch.items()}
    max_len = cfg.vision_tokens + 40 + 8
    body = "fma" if dtype == "float32" else "mma"
    before = fa.flash_launches_by_body[body]
    logits, _ = lm.prefill(on_card, gbatch, max_len)
    assert fa.flash_launches_by_body[body] - before == cfg.num_layers
    want, _ = lm.prefill(params, batch, max_len)
    got, real = logits.cpu(), slice(0, cfg.vocab_size)
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        out = ServeEngine(lm, on_card, max_len).generate(gbatch, 8)
        ref = ServeEngine(lm, params, max_len).generate(batch, 8)
        assert torch.equal(out.cpu(), ref)
    else:
        cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                    activation_dtype="float32")
        exact, _ = LM(cfg32).prefill(tree_map(lambda t: t.float(), params),
                                     batch, max_len)
        exact = exact[:, real]

        def dist(x):
            return float((x[:, real] - exact).norm() / exact.norm())

        assert dist(got) <= 2 * dist(want), (dist(got), dist(want))


def test_full_width_whisper_layers_on_the_card_match_their_cpu_run(card):
    """One whisper-base encoder self-attention and one cross-attention at
    the published width (d 512, 8 heads of 64) over 1500 frames, the card
    in bf16 (the wgmma body, non-causal) against the CPU in fp32 from the
    same bf16 weights: ||Δ|| <= WHISPER_LAYER_REL·||cpu|| (chip_smoke.py
    phase 11(b)), which each run causal must fail."""
    cfg = get_config("whisper-base")
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                activation_dtype="float32")
    g = torch.Generator().manual_seed(0)
    p16 = tattn.attn_init(g, cfg, torch.bfloat16, cross=True)
    p32 = {k: v.float() for k, v in p16.items()}
    on16 = tree_map(lambda t: t.to(card), p16)
    frames = torch.randn((2, cfg.encoder_seq, cfg.d_model), generator=g)
    frames = rms_norm(frames, torch.ones(cfg.d_model)).to(
        torch.bfloat16).float()
    x = torch.randn((2, 192, cfg.d_model), generator=g)
    x = rms_norm(x, torch.ones(cfg.d_model)).to(torch.bfloat16).float()

    def rel(a, b):
        return float((a.cpu().float() - b).norm() / b.norm())

    before = fa.flash_launches_by_body["wgmma"]
    got = tattn.attn_forward(on16, frames.to(card, torch.bfloat16), cfg,
                             causal=False)
    want = tattn.attn_forward(p32, frames, cfg32, causal=False)
    assert rel(got, want) <= WHISPER_LAYER_REL
    assert rel(got, tattn.attn_forward(p32, frames, cfg32, causal=True)) > \
        WHISPER_LAYER_REL
    got = tattn.cross_attn_forward(
        on16, x.to(card, torch.bfloat16),
        _cross_kv(on16, frames.to(card, torch.bfloat16), cfg), cfg)
    assert fa.flash_launches_by_body["wgmma"] - before == 2
    kv32 = _cross_kv(p32, frames, cfg32)
    want = tattn.cross_attn_forward(p32, x, kv32, cfg32)
    assert rel(got, want) <= WHISPER_LAYER_REL
    with patched(tattn, "chunked_attention", causal_cross()):
        ctl = tattn.cross_attn_forward(p32, x, kv32, cfg32)
    assert rel(got, ctl) > WHISPER_LAYER_REL


def test_full_width_mla_layer_on_the_card_matches_its_cpu_run(card):
    """One minicpm3-4b MLA mixer at its published width (d 2560, 40 heads,
    rope 32 + nope 64, v 64) on 2 x 320 tokens, the card in bf16 against
    the CPU in fp32 from the same bf16 weights: ||Δ|| <= MLA_LAYER_REL·
    ||cpu|| (chip_smoke.py phase 10(b)), which the query heads split as
    [nope, rope] and the expansion without kv_norm must fail.  Then one
    decode step from each side's latent cache, card fp32 within 1e-4 of
    the CPU in norm."""
    cfg = get_config("minicpm3-4b")
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                activation_dtype="float32")
    g = torch.Generator().manual_seed(0)
    p16 = tattn.mla_init(g, cfg, torch.bfloat16)
    p32 = {k: v.float() for k, v in p16.items()}
    x = torch.randn((2, 321, cfg.d_model), generator=g)
    x = rms_norm(x, torch.ones(cfg.d_model)).to(torch.bfloat16).float()

    def rel(a, b):
        return float((a.cpu().float() - b).norm() / b.norm())

    want, (ckv, krope) = tattn.mla_forward(p32, x[:, :320], cfg32,
                                           return_kv=True)
    on16 = tree_map(lambda t: t.to(card), p16)
    got16 = tattn.mla_forward(on16, x[:, :320].to(card, torch.bfloat16),
                              cfg)
    assert rel(got16, want) <= MLA_LAYER_REL
    assert rel(got16, tattn.mla_forward(nope_first(p32, cfg), x[:, :320],
                                        cfg32)) > MLA_LAYER_REL
    with patched(tattn, "rms_norm", without_kv_norm(p32)):
        ctl = tattn.mla_forward(p32, x[:, :320], cfg32)
    assert rel(got16, ctl) > MLA_LAYER_REL
    # One fp32 decode step at position 320 from each side's latents.
    on32 = tree_map(lambda t: t.to(card), p32)
    cache = [torch.cat([t, torch.zeros_like(t[:, :1])], 1)
             for t in (ckv, krope)]
    gcache = [t.to(card) for t in cache]
    step, _, _ = tattn.mla_decode(p32, x[:, 320:], cfg32, *cache, 320)
    gstep, _, _ = tattn.mla_decode(on32, x[:, 320:].to(card), cfg32,
                                   *gcache, 320)
    assert rel(gstep, step) <= 1e-4
    assert rel(gcache[0], cache[0]) <= 1e-4 and \
        rel(gcache[1], cache[1]) <= 1e-4


def test_full_width_mamba_layer_on_the_card_matches_its_cpu_run(card):
    """One mamba2-1.3b mixer at its published width (d 2048, 64 heads of
    64, d_state 128, chunk 256) on 300 tokens (one chunk and a padded
    second), against the CPU in fp32 from the same bf16 weights.  Card
    bf16: ||Δ|| <= 2e-2·||cpu||, which the layer with conv_x's taps
    reversed must fail.  Card fp32: output, final state, conv tails and
    one decode step within 1e-4 of the CPU in norm, which the scan without
    its inter-chunk carry must fail."""
    cfg = get_config("mamba2-1.3b")
    g = torch.Generator().manual_seed(0)
    p16 = tssm.ssm_init(g, cfg, torch.bfloat16)
    p32 = {k: v.float() for k, v in p16.items()}
    x = torch.randn((2, 301, cfg.d_model), generator=g)
    x = rms_norm(x, torch.ones(cfg.d_model)).to(torch.bfloat16).float()

    def rel(a, b):
        return float((a.cpu().float() - b).norm() / b.norm())

    want, (h, tails) = tssm.ssm_forward(p32, x[:, :300], cfg,
                                        return_state=True)
    on16 = tree_map(lambda t: t.to(card), p16)
    on32 = tree_map(lambda t: t.to(card), p32)
    got16 = tssm.ssm_forward(on16, x[:, :300].to(card, torch.bfloat16), cfg)
    got, (gh, gtails) = tssm.ssm_forward(on32, x[:, :300].to(card), cfg,
                                         return_state=True)
    assert rel(got16, want) <= 2e-2
    assert rel(got, want) <= 1e-4 and rel(gh, h) <= 1e-4
    for a, b in zip(gtails, tails):
        assert rel(a, b) <= 1e-4
    flipped = dict(p32, conv_x=p32["conv_x"].flip(0))
    assert rel(got16, tssm.ssm_forward(flipped, x[:, :300], cfg)) > 2e-2
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tssm, "_ssd_chunk", dropped_carry(tssm._ssd_chunk))
        ctl = tssm.ssm_forward(p32, x[:, :300], cfg)
    assert rel(got, ctl) > 1e-4
    # One decode step from each side's state.
    cache = {"h": h, "conv_x": tails[0], "conv_b": tails[1],
             "conv_c": tails[2]}
    cache = {k: v.clone() for k, v in cache.items()}
    gcache = {k: v.clone() for k, v in zip(
        ("h", "conv_x", "conv_b", "conv_c"), (gh, *gtails))}
    step, _ = tssm.ssm_decode(p32, x[:, 300:], cfg, cache)
    gstep, _ = tssm.ssm_decode(on32, x[:, 300:].to(card), cfg, gcache)
    assert rel(gstep, step) <= 1e-4 and rel(gcache["h"], cache["h"]) <= 1e-4


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "capacity"])
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_apply_on_the_card_matches_its_cpu_run(card, top_k, exact):
    """``moe_apply`` on card tensors against the same call on the CPU, in
    fp32: equal routing, outputs and aux within 1e-5."""
    cfg = dataclasses.replace(
        reduced_config("llama4-scout-17b-a16e"),
        moe=dataclasses.replace(reduced_config(
            "llama4-scout-17b-a16e").moe, top_k=top_k))
    params = tmoe.moe_init(torch.Generator().manual_seed(top_k), cfg,
                           torch.float32)
    x = torch.randn((3, 50, cfg.d_model),
                    generator=torch.Generator().manual_seed(5))
    want, want_aux = tmoe.moe_apply(params, x, cfg, exact=exact)
    on_card = tree_map(lambda t: t.to(card), params)
    got, aux = tmoe.moe_apply(on_card, x.to(card), cfg, exact=exact)
    assert got.is_cuda
    want_i = tmoe._route(params, x.reshape(-1, cfg.d_model), cfg)[0]
    got_i = tmoe._route(on_card, x.to(card).reshape(-1, cfg.d_model),
                        cfg)[0]
    assert torch.equal(got_i.cpu(), want_i)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    for name in want_aux:
        torch.testing.assert_close(aux[name].cpu(), want_aux[name],
                                   rtol=1e-5, atol=1e-5)


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


# -- the flash-attention backward kernel ------------------------------------
# (b, sq, sk, kv heads, g, dh, dv, causal, prefix_len): every pair the
# forward serves ((64, 64), (128, 128), (96, 64), (256, 256)), pairs that
# only the mma body takes, a ragged last key tile (Sk not a multiple of
# the 64- or 32-row tiles), prefixes, GQA, Sq != Sk both ways, and a warp
# of padding rows only (Sq = 65: the second q tile holds one live row).
BWD_SHAPES = {
    "d64": (2, 200, 200, 2, 1, 64, 64, True, 0),
    "d128-gqa": (1, 190, 190, 2, 3, 128, 128, True, 0),
    "mla-96-64": (1, 150, 150, 3, 1, 96, 64, True, 0),
    "d256-prefix": (1, 140, 140, 1, 4, 256, 256, True, 100),
    "mma-256-128": (1, 100, 100, 1, 2, 256, 128, True, 0),
    "odd-20-13": (1, 45, 45, 2, 2, 20, 13, True, 3),
    "prefix-past-sk": (1, 70, 70, 2, 1, 64, 64, True, 90),
    "non-causal-sq-lt-sk": (2, 70, 200, 2, 2, 64, 64, False, 0),
    "causal-sq-gt-sk": (1, 130, 90, 1, 2, 32, 32, True, 0),
    "padding-rows": (1, 65, 65, 1, 1, 64, 64, True, 0),
}
# The kernel against its plain version, each of dq, dk, dv in norm:
# ||Δ|| <= BWD_REL·||plain||.  Both sum in fp32 and round P and dS to the
# inputs' dtype at the same points; they differ in sum order and in expf,
# so bf16 may round a P or dS the other way (chip_smoke.py phase 13's
# first H100 run read 1.6e-4-2.8e-4 in bf16 and 6.2e-7 in fp32).
BWD_REL = {torch.float32: 1e-5, torch.bfloat16: 5e-3}


def bwd_case(card, dtype, b, sq, sk, kvh, g, dh, dv, causal, prefix,
             seed=0):
    """Seeded q, k, v and dO on the card, and o from the forward kernel."""
    q, k, v = flash_inputs(card, dtype, b, sq, sk, kvh, g, dh, dv, seed)
    gen = torch.Generator(device=card).manual_seed(seed + 1)
    do = torch.randn((b, sq, kvh, g, dv), generator=gen,
                     device=card).to(dtype)
    o = fa.flash_attention(q, k, v, causal=causal, prefix_len=prefix)
    return q, k, v, o, do


def bwd_errors(got, want):
    return [float((a.float() - w.float()).norm() / w.float().norm())
            for a, w in zip(got, want)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", sorted(BWD_SHAPES))
def test_flash_bwd_kernel_matches_plain(card, shape, dtype):
    """The backward kernel against its plain version on card tensors, and
    a control (the mask's diagonal shifted by one, or the prefix ignored,
    or causal flipped) that must fail the same bound."""
    b, sq, sk, kvh, g, dh, dv, causal, prefix = BWD_SHAPES[shape]
    q, k, v, o, do = bwd_case(card, dtype, *BWD_SHAPES[shape])
    before = fa.flash_bwd_launches
    got = fa.flash_attention_bwd(q, k, v, o, do, causal=causal,
                                 prefix_len=prefix)
    torch.cuda.synchronize()
    assert fa.flash_bwd_launches == before + 1
    assert all(t.dtype == dtype and t.shape == w.shape
               for t, w in zip(got, (q, k, v)))
    want = fa.flash_attention_bwd_plain(q, k, v, o, do, causal=causal,
                                        prefix_len=prefix)
    errs = bwd_errors(got, want)
    assert max(errs) <= BWD_REL[dtype], errs
    if prefix:
        ctl = fa.flash_attention_bwd(q, k, v, o, do, causal=causal)
    else:
        ctl = fa.flash_attention_bwd(q, k, v, o, do, causal=not causal)
    assert max(bwd_errors(ctl, want)) > BWD_REL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_flash_bwd_kernel_is_deterministic(card, dtype):
    """No atomics: two runs give the same bits (GQA, so dK and dV sum over
    a group's heads)."""
    q, k, v, o, do = bwd_case(card, dtype, 2, 300, 300, 2, 4, 64, 64, True,
                              0, seed=5)
    a = fa.flash_attention_bwd(q, k, v, o, do)
    b = fa.flash_attention_bwd(q, k, v, o, do)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_flash_function_backward_runs_the_kernel(card):
    """``FlashAttention`` on card tensors: its forward is the forward
    kernel, its backward one backward launch with the kernel's gradients;
    with nothing requiring grad it records no graph."""
    q, k, v, o, do = bwd_case(card, torch.bfloat16, 1, 130, 130, 2, 2, 64,
                              64, True, 0, seed=7)
    out = fa.FlashAttention.apply(q, k, v, True, 0)
    assert out.grad_fn is None and torch.equal(out, o)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = fa.flash_bwd_launches
    out = fa.FlashAttention.apply(*leaves, True, 0)
    grads = torch.autograd.grad(out, leaves, do)
    assert fa.flash_bwd_launches == before + 1
    want = fa.flash_attention_bwd(q, k, v, o, do)
    assert all(torch.equal(x, y) for x, y in zip(grads, want))


def test_flash_bwd_wrapper_refuses_what_the_kernel_does_not_take(card):
    q, k, v, o, do = bwd_case(card, torch.bfloat16, 1, 16, 16, 2, 1, 64, 64,
                              True, 0)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_bwd(q, k, v, o, do.transpose(1, 2).contiguous()
                               .transpose(1, 2))
    with pytest.raises(ValueError, match="does not match"):
        fa.flash_attention_bwd(q, k, v, o.float(), do)
    with pytest.raises(ValueError, match="on"):
        fa.flash_attention_bwd(q, k, v, o, do.cpu())


def lm_loss_and_grads(lm, params, batch):
    from repro_torch.train.optimizer import leaves
    flat = leaves(params)
    for t in flat:
        t.requires_grad_(True)
    loss, _ = lm.loss(params, batch)
    return loss.detach(), torch.autograd.grad(loss, flat)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "minicpm3-4b",
                                  "whisper-base", "paligemma-3b"])
def test_reduced_lm_loss_backward_on_the_card(card, arch, dtype):
    """``LM.loss`` and every parameter's gradient, reduced model with remat
    on, card against CPU from the same weights: the card's attention runs
    the forward and backward kernels (one backward launch per attention
    call).  fp32: the loss within 1e-5 relative and each gradient within
    1e-4 in relative norm.  bf16 (the CPU run in fp32 from the same bf16
    weights): the loss within 2e-2 relative, and the stacked gradient
    within 5e-2 in relative norm, which the backward with its mask flipped
    (the control) must fail."""
    cfg = dataclasses.replace(reduced_config(arch), param_dtype=dtype,
                              activation_dtype=dtype, remat=True)
    lm = LM(cfg)
    params = lm.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (2, 41))
    batch = {"inputs": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])}
    from repro_torch.data.pipeline import add_modality_stubs
    batch = add_modality_stubs(batch, cfg)
    on_card = tree_map(lambda t: t.to(card), params)
    card_batch = {n: t.to(card) for n, t in batch.items()}
    # Attention calls: a self-attention per attention sub-layer, a cross
    # one more per attn_cross, one per encoder layer.
    calls = cfg.num_periods * sum(1 + (m == "attn_cross")
                                  for m, _ in cfg.layout if m != "mamba") \
        + cfg.encoder_layers
    before = fa.flash_bwd_launches
    loss, grads = lm_loss_and_grads(lm, on_card, card_batch)
    assert fa.flash_bwd_launches - before == calls
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                activation_dtype="float32")
    want, wgrads = lm_loss_and_grads(
        LM(cfg32), tree_map(lambda t: t.detach().float(), params), batch)
    flat = torch.cat([g.float().flatten().cpu() for g in grads])
    wflat = torch.cat([g.flatten() for g in wgrads])
    if dtype == "float32":
        assert abs(float(loss) - float(want)) <= 1e-5 * abs(float(want))
        for g, w in zip(grads, wgrads):
            assert float((g.cpu() - w).norm()) <= 1e-4 * float(w.norm()) \
                + 1e-7
        return
    assert abs(float(loss) - float(want)) <= 2e-2 * abs(float(want))
    rel = float((flat - wflat).norm() / wflat.norm())
    assert rel <= 5e-2, rel
    flipped = fa.flash_attention_bwd

    def wrong_mask(q, k, v, o, do, *, causal=True, prefix_len=0):
        return flipped(q, k, v, o, do, causal=not causal,
                       prefix_len=prefix_len)

    with patched(fa, "flash_attention_bwd", wrong_mask):
        _, cgrads = lm_loss_and_grads(lm, on_card, card_batch)
    cflat = torch.cat([g.float().flatten().cpu() for g in cgrads])
    assert float((cflat - wflat).norm() / wflat.norm()) > 5e-2
