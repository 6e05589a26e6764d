"""Power iteration / PageRank on a Serpens-resident matrix.

The paper's graph-analytics use case (Sec. 1: "graph processing ...
PageRank") as a *workload*: A streams from device memory once per
iteration and nothing returns to the host until convergence, except one
read of the loop's control word per
:data:`~repro_torch.kernels.ops.FUSED_CHUNK` iterations.

With ``fused`` (default ``"auto"``) each iteration's vector work — the
teleport/dangling-mass redistribution and L1 delta (pagerank) or the
Rayleigh quotient, residual, and normalize (power iteration) — runs as
the fused epilogue of the SpMV kernel, one pass over A per iteration, with
the state vector updated in place; see
:meth:`SerpensOperator.matvec_fused`.  Plans that cannot fuse run the
two-phase body, which reads its stopping measure on the host once per
iteration.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import obs
from repro_torch.kernels import ops
from repro_torch.kernels.serpens_spmv import FusedLoop, fused_epilogue
from repro_torch.solvers import precision
from repro_torch.solvers.cg import _no_mesh, _resolve_fused


@dataclasses.dataclass
class PowerResult:
    x: torch.Tensor         # final vector (PageRank: probability vector)
    iterations: int
    residual: float         # L1 delta (pagerank) / eigen-residual norm
    eigenvalue: float | None = None  # power_iteration only
    converged: bool = False
    fused: bool = False     # iterations ran with the in-kernel epilogue
    tol_effective: float = 0.0  # tol after the value-dtype floor clamp
    host_syncs: int = 0     # host reads of the loop's state during the solve


def _square(op):
    m, k = op.shape
    if m != k:
        raise ValueError(f"solver needs a square matrix, got {op.shape}")
    return m


@fused_epilogue("pagerank")
def _pagerank_epilogue(acc2, r2, mask2, consts):
    """One PageRank step fused against the fresh ``A·r`` accumulator.

    ``mask2`` is 1.0 on real rows, 0.0 on the accumulator's padding rows —
    the uniform teleport mass must not leak into padding (the unfused body
    never sees padded rows because matvec slices ``[:m]``).  ``consts`` is
    ``[[damping, n]]``.  The CUDA kernel runs this computation (``pr_*``).
    """
    damping, n = consts[0, 0], consts[0, 1]
    link = damping * acc2              # padded rows of acc2 are zero
    r_new = (link + (1.0 - torch.sum(link)) / n) * mask2
    delta = torch.sum(torch.abs(r_new - r2))
    return r_new, delta.reshape(1, 1)


def pagerank(op, damping: float = 0.85, tol: float = 1e-9,
             max_iters: int = 100, r0=None, backend: str | None = None,
             mesh=None, axis: str | None = None,
             fused="auto") -> PowerResult:
    """PageRank: r ← d·A·r + (1-d+dangling mass)/n, to an L1 tolerance.

    ``op`` is a :class:`~repro_torch.core.spmv.SerpensSpMV` whose columns
    are out-degree-normalized (column-substochastic; dangling columns may
    be all-zero — their mass is redistributed uniformly each step, keeping
    r a probability vector).  ``tol`` is clamped to the operator's
    value-dtype precision floor (bf16 streams; see
    :mod:`repro_torch.solvers.precision`).
    """
    _no_mesh(mesh, axis)
    n = _square(op)
    use_fused = _resolve_fused(op, fused)
    tol_eff, _ = precision.effective_tol(
        tol, getattr(op, "value_dtype", "float32"))
    r_init = (torch.full((n,), 1.0 / n, dtype=torch.float32,
                         device=op.device)
              if r0 is None else op._coerce(r0, "r0"))

    with obs.span("pagerank", cat="solver", n=n, damping=float(damping),
                  fused=use_fused) as sp:
        d0 = ops.trace_dispatch_count()
        solve = _pagerank_fused if use_fused else _pagerank_unfused
        r, delta, iters, syncs = solve(op, r_init, damping, tol_eff,
                                       max_iters, backend)
        sp.args.update(iterations=iters, residual=delta, host_syncs=syncs,
                       stream_dispatches=ops.trace_dispatch_count() - d0)
    return PowerResult(x=r, iterations=iters, residual=delta,
                       converged=delta <= tol_eff, fused=use_fused,
                       tol_effective=tol_eff, host_syncs=syncs)


def _pagerank_unfused(op, r, damping, stop, max_iters, backend):
    """The two-phase body: the SpMV kernel, then torch vector ops; the L1
    delta is read on the host once per iteration.  Returns ``(r, delta,
    iterations, host_syncs)``."""
    n = op.shape[0]
    delta, iters = math.inf, 0
    while delta > stop and iters < max_iters:
        link = damping * op.matvec(r, backend=backend)
        # teleport + dangling-node mass: whatever probability the
        # (sub)stochastic step lost comes back uniformly.
        r_new = link + (1.0 - torch.sum(link)) / n
        delta = float(torch.sum(torch.abs(r_new - r)))
        r, iters = r_new, iters + 1
    return r, delta, iters, iters


def _pagerank_fused(op, r_init, damping, stop, max_iters, backend):
    """The whole iteration as ONE pass over A: r in (R, LANES) layout,
    updated in place by :func:`_pagerank_epilogue`'s kernel; its flat
    view is the pass's x."""
    n = op.shape[0]
    r2 = op.to_acc_layout(r_init)
    mask2 = op.to_acc_layout(
        torch.ones(n, dtype=torch.float32, device=op.device))
    consts = torch.tensor([[damping, n]], dtype=torch.float32,
                          device=op.device)
    loop = FusedLoop(op.device, stop=stop, max_iters=max_iters,
                     scalars=(math.inf,))
    r = op.from_acc_layout(r2)
    extras = (r2, mask2, consts)

    def step():
        op.matvec_fused(r, _pagerank_epilogue, extras=extras,
                        backend=backend, loop=loop)

    iters, syncs = ops.run_fused_loop(step, loop)
    return r, float(loop.scalars[0]), iters, syncs


@fused_epilogue("power")
def _power_epilogue(av2, v2):
    """One power-iteration step fused against the fresh ``A·v``: Rayleigh
    quotient, eigen-residual, and the normalize — padded rows are zero in
    both operands, so every reduction is exact.  The CUDA kernel runs this
    computation (``pw_*``)."""
    lam = torch.sum(v2 * av2)          # Rayleigh quotient (v unit-norm)
    res = torch.sqrt(torch.sum((av2 - lam * v2) ** 2))
    nrm = torch.sqrt(torch.sum(av2 * av2))
    v_new = torch.where(nrm > 0, av2 / torch.clamp(nrm, min=1e-30), v2)
    return v_new, lam.reshape(1, 1), res.reshape(1, 1)


def power_iteration(op, tol: float = 1e-6, max_iters: int = 200,
                    v0=None, backend: str | None = None,
                    mesh=None, axis: str | None = None,
                    fused="auto") -> PowerResult:
    """Dominant eigenpair of a square A by normalized power iteration.

    Converges for matrices with a simple dominant eigenvalue; the residual
    is ``‖A·v − λ·v‖₂`` with v unit-norm.  ``tol`` is clamped to the
    operator's value-dtype precision floor (bf16 streams).
    """
    _no_mesh(mesh, axis)
    n = _square(op)
    use_fused = _resolve_fused(op, fused)
    tol_eff, _ = precision.effective_tol(
        tol, getattr(op, "value_dtype", "float32"))
    if v0 is None:
        v_init = (torch.ones(n, dtype=torch.float32, device=op.device)
                  / torch.sqrt(torch.tensor(float(n))).to(op.device))
    else:
        v_init = op._coerce(v0, "v0")
        v_init = v_init / torch.linalg.vector_norm(v_init)

    with obs.span("power-iteration", cat="solver", n=n,
                  fused=use_fused) as sp:
        d0 = ops.trace_dispatch_count()
        solve = _power_fused if use_fused else _power_unfused
        v, lam, res, iters, syncs = solve(op, v_init, tol_eff, max_iters,
                                          backend)
        sp.args.update(iterations=iters, residual=res, host_syncs=syncs,
                       stream_dispatches=ops.trace_dispatch_count() - d0)
    return PowerResult(x=v, iterations=iters, residual=res,
                       eigenvalue=float(lam), converged=res <= tol_eff,
                       fused=use_fused, tol_effective=tol_eff,
                       host_syncs=syncs)


def _power_unfused(op, v, stop, max_iters, backend):
    """The two-phase body: the SpMV kernel, then torch vector ops; λ and
    the residual are read on the host once per iteration.  Returns ``(v,
    λ, residual, iterations, host_syncs)``."""
    lam, res, iters = 0.0, math.inf, 0
    while res > stop and iters < max_iters:
        av = op.matvec(v, backend=backend)
        lam_t = torch.dot(v, av)             # Rayleigh quotient
        res_t = torch.linalg.vector_norm(av - lam_t * v)
        nrm = torch.linalg.vector_norm(av)
        v = torch.where(nrm > 0, av / torch.clamp(nrm, min=1e-30), v)
        lam, res = float(lam_t), float(res_t)
        iters += 1
    return v, lam, res, iters, iters


def _power_fused(op, v_init, stop, max_iters, backend):
    """The whole iteration as ONE pass over A: v in (R, LANES) layout,
    updated in place by :func:`_power_epilogue`'s kernel; its flat view
    is the pass's x."""
    v2 = op.to_acc_layout(v_init)
    loop = FusedLoop(op.device, stop=stop, max_iters=max_iters,
                     scalars=(0.0, math.inf))
    v = op.from_acc_layout(v2)

    def step():
        op.matvec_fused(v, _power_epilogue, extras=(v2,), backend=backend,
                        loop=loop)

    iters, syncs = ops.run_fused_loop(step, loop)
    lam, res = loop.scalars.tolist()
    return v, lam, res, iters, syncs
