"""Synthetic sparse-matrix generators (the evaluation corpus).

The paper evaluates on SNAP/OGB/SuiteSparse matrices which are not available
offline; these generators produce *structural stand-ins* with matched size,
density, and degree skew.  ``paper_matrix`` builds a stand-in for each of the
twelve Table-2 matrices (optionally scaled down for CPU execution — the
analytic model in core/scheduler.py covers the full sizes).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.scheduler import PAPER_TABLE3


def coo_from_csr(indptr, indices, data):
    """CSR → COO triples without materializing a COO copy.

    Only the row ids are expanded (one ``np.repeat`` over the indptr
    deltas); ``cols``/``vals`` alias the caller's CSR buffers, so feeding
    ``format.encode`` / ``MatrixRegistry.put`` from CSR costs one extra
    int64 array rather than three.  Works for any object exposing
    scipy-style ``(indptr, indices, data)`` — no scipy dependency.
    """
    indptr = np.asarray(indptr, dtype=np.int64)
    if indptr.ndim != 1 or indptr.size < 1:
        raise ValueError("indptr must be a 1-D array of length nrows+1")
    counts = np.diff(indptr)
    if counts.size and counts.min() < 0:
        raise ValueError("indptr must be non-decreasing")
    rows = np.repeat(np.arange(indptr.size - 1, dtype=np.int64), counts)
    return rows, np.asarray(indices), np.asarray(data)


def coo_from_csc(indptr, indices, data):
    """CSC → COO triples; mirror of :func:`coo_from_csr` (cols expanded,
    ``rows``/``vals`` alias the CSC buffers)."""
    cols, rows, vals = coo_from_csr(indptr, indices, data)
    return rows, cols, vals


def dedupe(rows, cols, vals, shape):
    """Sum duplicates (COO canonicalization)."""
    m, k = shape
    key = rows.astype(np.int64) * k + cols
    uniq, inv = np.unique(key, return_inverse=True)
    v = np.zeros(len(uniq), np.float32)
    np.add.at(v, inv, vals)
    return (uniq // k).astype(np.int64), (uniq % k).astype(np.int64), v


def uniform_random(m, k, nnz, seed=0):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, k, nnz)
    vals = rng.normal(size=nnz).astype(np.float32)
    return dedupe(rows, cols, vals, (m, k))


def power_law_graph(n, nnz, seed=0, exponent=1.1):
    """Degree-skewed square matrix (social-graph-like, e.g. G1/G7/G11).

    The head is offset so the hottest vertex holds ~0.1-1% of all edges —
    matching real social graphs (hollywood: max degree 11k of 113M edges).
    A pure zipf(1.5) head would give one vertex 30%+ of the edges at small
    n, which over-states lane imbalance on scaled stand-ins.
    """
    rng = np.random.default_rng(seed)
    offset = max(10.0, n / 100.0)
    p = (np.arange(n, dtype=np.float64) + offset) ** (-exponent)
    p /= p.sum()
    rows = rng.choice(n, size=nnz, p=p)
    cols = rng.choice(n, size=nnz, p=p)
    perm = rng.permutation(n)  # shuffle so hot rows are spread
    vals = rng.normal(size=nnz).astype(np.float32)
    return dedupe(perm[rows], perm[cols], vals, (n, n))


def column_normalize(rows, cols, vals, n, eps=1e-12):
    """Out-degree normalization: |A[i,j]| / deg_out(j), column-substochastic.

    The form the pagerank solver expects (``repro_torch.solvers.pagerank``);
    dangling (all-zero) columns stay zero — the solver redistributes their
    mass uniformly each step.
    """
    colsum = np.bincount(cols, weights=np.abs(vals), minlength=n)
    return (np.abs(vals) / np.maximum(colsum[cols], eps)).astype(np.float32)


def banded(n, bandwidth, seed=0):
    """FEM-like banded matrix (e.g. G2/G4/G5 stand-ins)."""
    rng = np.random.default_rng(seed)
    offs = np.arange(-bandwidth, bandwidth + 1)
    rows = np.repeat(np.arange(n), len(offs))
    cols = rows + np.tile(offs, n)
    sel = (cols >= 0) & (cols < n)
    rows, cols = rows[sel], cols[sel]
    vals = rng.normal(size=len(rows)).astype(np.float32)
    return rows.astype(np.int64), cols.astype(np.int64), vals


def paper_matrix(gid: str, scale: float = 1.0, seed: int = 0):
    """Stand-in for a Table-2 matrix, optionally scaled (rows & nnz × scale).

    Returns (rows, cols, vals, shape, meta) with meta holding the full-size
    figures for the analytic model.
    """
    name, vertices, edges, *_ = PAPER_TABLE3[gid]
    n = max(256, int(vertices * scale))
    nnz = max(1024, int(edges * scale))
    social = {"G1", "G7", "G8", "G10", "G11", "G12"}
    if gid in social:
        r, c, v = power_law_graph(n, nnz, seed=seed)
    else:
        bw = max(1, nnz // (2 * n))
        r, c, v = banded(n, bw, seed=seed)
    meta = {"name": name, "full_vertices": vertices, "full_nnz": edges,
            "scale": scale}
    return r, c, v, (n, n), meta


def suitesparse_like_corpus(n_matrices=60, seed=0, max_nnz=300_000):
    """A corpus mimicking the SuiteSparse sweep of Fig. 3: sizes log-uniform,
    density spanning the paper's 8.75e-7..1 range (clipped to CPU-feasible)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_matrices):
        n = int(10 ** rng.uniform(2.0, 4.8))
        density = 10 ** rng.uniform(-4.0, -0.5)
        nnz = int(min(max(n * n * density, 1_000), max_nnz))
        kind = rng.choice(["uniform", "powerlaw", "banded"])
        if kind == "uniform":
            r, c, v = uniform_random(n, n, nnz, seed=seed + i)
        elif kind == "powerlaw":
            r, c, v = power_law_graph(n, nnz, seed=seed + i)
        else:
            r, c, v = banded(n, max(1, nnz // (2 * n)), seed=seed + i)
        out.append((f"ss{i:03d}_{kind}", r, c, v, (n, n)))
    return out
