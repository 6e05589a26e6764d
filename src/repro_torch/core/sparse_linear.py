"""SparseLinear — pruned-weight linear layers served via Serpens SpMV.

The paper motivates SpMV with "inference of sparse neural networks" (Sec. 1,
[14] Han et al.).  This module is that application: take a trained dense
linear layer, magnitude-prune it, convert the weight to the Serpens stream
format offline (the paper's preprocessing), and serve ``y = W @ x + b`` as a
general-purpose SpMV (batch==1 decode, the spmv kernel) or SpMM (batched
decode, the SpMM kernel, whatever the batch width) on the operator's device
— CUDA unless the caller asks for the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import format as sformat
from repro_torch.core.spmv import SerpensSpMV


def magnitude_prune(w: np.ndarray, density: float) -> np.ndarray:
    """Keep the top ``density`` fraction of |w|; zero the rest."""
    if not (0.0 < density <= 1.0):
        raise ValueError("density must be in (0, 1]")
    k = int(round(w.size * density))
    if k == 0:
        return np.zeros_like(w)
    thresh = np.partition(np.abs(w).ravel(), w.size - k)[w.size - k]
    return np.where(np.abs(w) >= thresh, w, 0.0).astype(w.dtype)


class SparseLinear:
    """y = W_sparse @ x + b with W in Serpens format on ``device``."""

    def __init__(self, w_sparse: np.ndarray, bias=None,
                 config: sformat.SerpensConfig | None = None,
                 backend: str = "auto", device=None):
        d_out, d_in = w_sparse.shape
        if config is None:
            # Segment width: whole input if it fits 16 bits, else paper W.
            config = sformat.SerpensConfig(
                segment_width=min(int(2 ** np.ceil(np.log2(max(d_in, 2)))),
                                  8192))
        rows, cols = np.nonzero(w_sparse)
        self.op = SerpensSpMV(rows, cols, w_sparse[rows, cols],
                              (d_out, d_in), config, backend, device)
        self.bias = None if bias is None else torch.as_tensor(
            bias, dtype=torch.float32, device=self.op.device)
        self.shape = (d_out, d_in)

    @classmethod
    def from_dense(cls, w: np.ndarray, density: float = 0.1, bias=None,
                   config=None, backend="auto",
                   device=None) -> "SparseLinear":
        return cls(magnitude_prune(np.asarray(w), density), bias, config,
                   backend, device)

    @property
    def density(self) -> float:
        return self.op.nnz / (self.shape[0] * self.shape[1])

    def __call__(self, x):
        """x: (d_in,) or (batch, d_in) → (d_out,) or (batch, d_out), fp32
        on the operator's device."""
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
        if x.ndim == 1:
            y = self.op.matvec(x)
        elif x.ndim == 2:
            y = self.op.matmat(x.T).T
        else:
            raise ValueError("x must be rank-1 or rank-2")
        if self.bias is not None:
            y = y + self.bias
        return y
