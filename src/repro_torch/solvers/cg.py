"""Conjugate gradient on a Serpens-resident SPD matrix.

The scientific-solver workload (the paper's FEM/circuit matrices G2/G4/G5):
solve A·x = b with one pass over A per iteration.

With ``fused`` (default ``"auto"``) the iteration's vector algebra —
``alpha``/``beta`` dots, the three axpys — runs as the fused epilogue of
the SpMV kernel (:meth:`SerpensOperator.matvec_fused`), so each iteration
is ONE pass over A doing matrix *and* vector work; the state vectors stay
in the kernel's (R, LANES) accumulator layout and are updated in place.
The reference loops in a device-side ``lax.while_loop``; here the loop's
condition lives on the card too (:class:`FusedLoop`): the host enqueues
:data:`~repro_torch.kernels.ops.FUSED_CHUNK` iterations at a time and
reads the control word once per chunk, so iteration counts equal the
reference's and no iteration waits on the host.  Plans that cannot fuse
(multi-shard, aux-spill, balanced lanes) run the classic two-phase body,
which reads its stopping measure on the host once per iteration.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import obs
from repro_torch.kernels import ops
from repro_torch.kernels.serpens_spmv import FusedLoop, fused_epilogue
from repro_torch.solvers import precision

_MESH_SLICE = "the multi-GPU slice of the port"


@dataclasses.dataclass
class CGResult:
    x: torch.Tensor
    iterations: int
    residual: float          # ‖b − A·x‖₂ (estimate carried by the recursion)
    converged: bool
    fused: bool = False      # iterations ran with the in-kernel epilogue
    tol_effective: float = 0.0   # tol after the value-dtype floor clamp
    host_syncs: int = 0      # host reads of the loop's state during the solve


@fused_epilogue("cg")
def _cg_epilogue(ap2, sol2, r2, p2, rs11):
    """One CG iteration's vector work, fused against the fresh ``A·p``
    accumulator (all arrays in (R, LANES) layout; padded rows are zero in
    every operand, so the dots are exact).  The CUDA kernel runs this
    computation (``cg_*`` in ``csrc/serpens_spmv.cu``)."""
    rs = rs11[0, 0]
    denom = torch.sum(p2 * ap2)
    alpha = rs / torch.where(denom != 0, denom, 1e-30)
    sol_new = sol2 + alpha * p2
    r_new = r2 - alpha * ap2
    rs_new = torch.sum(r_new * r_new)
    beta = rs_new / torch.where(rs != 0, rs, 1e-30)
    p_new = r_new + beta * p2
    return sol_new, r_new, p_new, rs_new.reshape(1, 1)


def _no_mesh(mesh, axis) -> None:
    if mesh is not None or axis is not None:
        raise NotImplementedError(
            f"solving over a mesh waits for {_MESH_SLICE}")


def _resolve_fused(op, fused):
    if fused == "auto":
        return bool(getattr(op, "supports_fused_epilogue", False))
    if fused and not op.supports_fused_epilogue:
        raise ValueError(
            "fused=True but the operator cannot fuse (multi-shard, "
            "aux-spill, or balanced-lane plan); use fused='auto' to fall "
            "back automatically")
    return bool(fused)


def conjugate_gradient(op, b, x0=None, tol: float = 1e-6,
                       max_iters: int | None = None,
                       backend: str | None = None,
                       mesh=None, axis: str | None = None,
                       fused="auto") -> CGResult:
    """Solve ``A x = b`` for symmetric positive-definite A.

    Stops when ``‖r‖₂ <= tol * ‖b‖₂`` (relative residual) or after
    ``max_iters`` (default: n, CG's exact-arithmetic bound).  ``tol`` is
    clamped to the operator's value-dtype precision floor
    (:mod:`repro_torch.solvers.precision`) — a bf16 stream cannot resolve
    residuals below ~2^-6 of ‖b‖; the clamp warns and the result records
    ``tol_effective``.  The solve makes one pass over A for r₀ and one per
    iteration (``stream_dispatches`` of the solver span counts the
    latter).
    """
    _no_mesh(mesh, axis)
    m, k = op.shape
    if m != k:
        raise ValueError(f"CG needs a square (SPD) matrix, got {op.shape}")
    b = op._coerce(b, "b")
    if tuple(b.shape) != (m,):
        raise ValueError(f"b has shape {tuple(b.shape)}; expected ({m},)")
    x_init = (torch.zeros(m, dtype=torch.float32, device=op.device)
              if x0 is None else op._coerce(x0, "x0"))
    if max_iters is None:
        max_iters = m
    use_fused = _resolve_fused(op, fused)
    tol_eff, _ = precision.effective_tol(
        tol, getattr(op, "value_dtype", "float32"))
    b_norm = torch.linalg.vector_norm(b)
    stop = float(tol_eff * torch.clamp(b_norm, min=1e-30))

    r_init = b - op.matvec(x_init, backend=backend)
    rs_init = torch.dot(r_init, r_init)

    with obs.span("conjugate-gradient", cat="solver", n=m,
                  fused=use_fused) as sp:
        d0 = ops.trace_dispatch_count()
        solve = _solve_fused if use_fused else _solve_unfused
        x, rs, iters, syncs = solve(op, x_init, r_init, rs_init, stop,
                                    max_iters, backend)
        res = float(torch.sqrt(rs))
        sp.args.update(iterations=iters, residual=res, host_syncs=syncs,
                       stream_dispatches=ops.trace_dispatch_count() - d0)
    return CGResult(x=x, iterations=iters, residual=res,
                    converged=res <= stop, fused=use_fused,
                    tol_effective=tol_eff, host_syncs=syncs)


def _solve_unfused(op, x, r, rs, stop, max_iters, backend):
    """The two-phase body: the SpMV kernel, then torch vector ops; the
    stopping measure is read on the host once per iteration."""
    p, it = r, 0
    while float(torch.sqrt(rs)) > stop and it < max_iters:
        ap = op.matvec(p, backend=backend)
        denom = torch.dot(p, ap)
        alpha = rs / torch.where(denom != 0, denom, 1e-30)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = torch.dot(r, r)
        beta = rs_new / torch.where(rs != 0, rs, 1e-30)
        p = r + beta * p
        rs, it = rs_new, it + 1
    return x, rs, it, it + 1


def _solve_fused(op, x_init, r_init, rs_init, stop, max_iters, backend):
    """The whole iteration as ONE pass over A: state in (R, LANES)
    layout, updated in place by :func:`_cg_epilogue`'s kernel; p's flat
    view is the pass's x."""
    sol2, r2 = op.to_acc_layout(x_init), op.to_acc_layout(r_init)
    p2 = r2.clone()
    rs11 = rs_init.reshape(1, 1).clone()
    loop = FusedLoop(op.device, stop=stop, max_iters=max_iters,
                     first=torch.sqrt(rs_init))
    p = op.from_acc_layout(p2)
    extras = (sol2, r2, p2, rs11)

    def step():
        op.matvec_fused(p, _cg_epilogue, extras=extras, backend=backend,
                        loop=loop)

    iters, syncs = ops.run_fused_loop(step, loop)
    return op.from_acc_layout(sol2), rs11[0, 0], iters, syncs
