"""Tolerance policy for mixed-precision value streams.

The port's own copy of ``repro.solvers.precision`` (importing that module
would run the reference's ``solvers/__init__``, which imports jax).

A bf16 value stream perturbs the matrix once, at encode time:
``Â = A + E`` with ``|E| <= eps * |A|`` elementwise, ``eps = 2^-8``
(bf16 has 8 significand bits; accumulation stays fp32, so this is the
*only* precision loss — the reference's property suite
(``tests/test_precision.py``) asserts the resulting SpMV error bound
``|Âx − Ax| <= eps * (|A| @ |x|)`` holds exactly).

Consequently an iterative solver on a bf16 operator converges to the
*perturbed* system's answer: driving its stopping tolerance below the
stream's precision buys iterations, not accuracy.  The solvers therefore
clamp the requested tolerance to a per-dtype floor — a deliberately
simple heuristic (a small multiple of eps; the true attainable residual
also scales with conditioning, which we cannot know cheaply) — and
report the effective tolerance they actually used.
"""
from __future__ import annotations

import warnings

# Unit roundoff of each value stream dtype (2^-(significand bits + 1),
# round-to-nearest): fp32 keeps 23+1 bits, bf16 keeps 7+1.
_EPS = {"float32": 2.0 ** -24, "bfloat16": 2.0 ** -8}

# Relative-tolerance floor per dtype.  fp32 streams are bit-exact copies
# of the master values — no floor.  bf16: 4x the unit roundoff (~1/64)
# leaves headroom for the fp32 accumulation/recursion noise on top of
# the encode-time rounding.
_TOL_FLOOR = {"float32": 0.0, "bfloat16": 4 * _EPS["bfloat16"]}


def value_eps(value_dtype: str) -> float:
    """Unit roundoff of a value stream dtype."""
    return _EPS[value_dtype]


def tolerance_floor(value_dtype: str) -> float:
    """Smallest meaningful relative stopping tolerance for a solver
    running over a ``value_dtype`` stream."""
    return _TOL_FLOOR[value_dtype]


def effective_tol(tol: float, value_dtype: str, *,
                  what: str = "tol") -> tuple[float, bool]:
    """Clamp ``tol`` to the dtype floor; warn when the clamp bites.

    Returns ``(tol_effective, clamped)``.
    """
    floor = tolerance_floor(value_dtype)
    if tol >= floor:
        return float(tol), False
    warnings.warn(
        f"{what}={tol:g} is below the {value_dtype} stream precision "
        f"floor {floor:g}; clamping — re-encode the matrix at float32 "
        f"for tighter tolerances", stacklevel=3)
    return float(floor), True
