"""Iterative solvers over the Serpens operator.  All solvers accept
``fused="auto"`` (the fused SpMV-plus-epilogue kernel: one pass over A per
iteration, the loop's condition kept on the card) and clamp tolerances to
the operator's value-dtype precision floor
(:mod:`repro_torch.solvers.precision`).  With ``mesh=``/``axis=`` a solver
rebinds the operator to that ``DeviceMesh`` axis (``with_mesh``) and runs
every iteration one shard a rank, unfused."""
from repro_torch.solvers.power_iteration import (PowerResult, pagerank,
                                                 power_iteration)
from repro_torch.solvers.cg import CGResult, conjugate_gradient
from repro_torch.solvers.precision import (effective_tol, tolerance_floor,
                                           value_eps)

# Name → solver registry: what the serving pipeline dispatches
# ``submit_solve(mid, kind, ...)`` requests through.  Every solver takes
# the operator first; ``conjugate_gradient`` additionally requires ``b``.
SOLVERS = {
    "pagerank": pagerank,
    "power_iteration": power_iteration,
    "conjugate_gradient": conjugate_gradient,
    "cg": conjugate_gradient,
}


def solve(op, kind: str, **kwargs):
    """Run the named solver over ``op`` (see :data:`SOLVERS`)."""
    try:
        fn = SOLVERS[kind]
    except KeyError:
        raise ValueError(
            f"unknown solver {kind!r}; known: {sorted(SOLVERS)}") from None
    return fn(op, **kwargs)


__all__ = ["PowerResult", "pagerank", "power_iteration",
           "CGResult", "conjugate_gradient",
           "effective_tol", "tolerance_floor", "value_eps",
           "SOLVERS", "solve"]
