"""Plain-torch COO oracles for the Serpens SpMV/SpMM kernels.

The ground truth every stream path is tested against: a COO scatter-add
in fp32, with no Serpens formatting involved.  Inputs are tensors on any
one device.
"""
from __future__ import annotations

import torch


def spmv_coo_ref(rows, cols, vals, x, m, alpha=1.0, beta=0.0, y=None):
    """y_out = alpha * A @ x + beta * y  with A given as COO triples."""
    acc = torch.zeros(m, dtype=torch.float32, device=x.device)
    acc.index_add_(0, rows.long(), vals.float() * x.float()[cols.long()])
    if y is None:
        y = torch.zeros_like(acc)
    return alpha * acc + beta * y.float()


def spmm_coo_ref(rows, cols, vals, x, m, alpha=1.0, beta=0.0, y=None):
    """Multi-vector oracle: x is (K, N), result (M, N)."""
    acc = torch.zeros((m, x.shape[1]), dtype=torch.float32, device=x.device)
    acc.index_add_(0, rows.long(),
                   vals.float()[:, None] * x.float()[cols.long()])
    if y is None:
        y = torch.zeros_like(acc)
    return alpha * acc + beta * y.float()


def spmv_dense_ref(a_dense, x, alpha=1.0, beta=0.0, y=None):
    """Dense oracle (for small tests)."""
    out = a_dense.float() @ x.float()
    if y is None:
        y = torch.zeros_like(out)
    return alpha * out + beta * y.float()
