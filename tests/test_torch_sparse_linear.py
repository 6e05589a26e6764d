"""The port's ``SparseLinear`` against the reference's, on the CPU.

The weights are made with numpy from a seed and handed to both packages
as numpy arrays.  ``magnitude_prune`` is numpy in both, so it must agree
exactly.  ``SparseLinear`` runs rank-1 input through ``matvec`` (the spmv
kernel on a card) and rank-2 input through ``matmat`` (the SpMM kernel,
whatever the batch width), here on CPU tensors; it must match the
reference at rtol = atol = 1e-5 (fp32 sums in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparse_linear as JS
from repro_torch.core import format as TF
from repro_torch.core import sparse_linear as TS
from repro_torch.kernels import ops
from torch_port_util import reference_compiled_here  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def weights(d_out, d_in, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(d_out, d_in)).astype(np.float32),
            rng.normal(size=d_out).astype(np.float32))


@pytest.mark.parametrize("density", [0.01, 0.05, 0.25, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("shape", [(64, 128), (33, 17), (2816, 64)])
def test_magnitude_prune_equals_the_reference(shape, density):
    w, _ = weights(*shape, seed=0)
    got = TS.magnitude_prune(w, density)
    want = JS.magnitude_prune(w, density)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_magnitude_prune_ties_and_errors():
    w = np.array([[1.0, -1.0, 0.5], [1.0, 2.0, -2.0]], np.float32)
    for d in (0.1, 0.3, 0.5, 0.6):
        np.testing.assert_array_equal(TS.magnitude_prune(w, d),
                                      JS.magnitude_prune(w, d))
    for bad in (0.0, -0.5, 1.5):
        with pytest.raises(ValueError, match="density"):
            TS.magnitude_prune(w, bad)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("batch", [None, 1, 4, 16, 40])
@pytest.mark.parametrize("shape", [(48, 96), (96, 48), (200, 1100)])
def test_sparse_linear_matches_the_reference(shape, batch, bias):
    """Rank 1 (``batch=None``) and rank 2, including a batch wider than
    the service's 16-wide buckets, which still goes through one SpMM."""
    w, b = weights(*shape, seed=1)
    b = b if bias else None
    jsl = JS.SparseLinear.from_dense(w, density=0.3, bias=b)
    tsl = TS.SparseLinear.from_dense(w, density=0.3, bias=b, device="cpu")
    rng = np.random.default_rng(2)
    x = rng.normal(size=(shape[1],) if batch is None
                   else (batch, shape[1])).astype(np.float32)
    before = ops.trace_dispatch_count()
    got = tsl(x)
    assert ops.trace_dispatch_count() == before + 1   # one pass over W
    want = np.asarray(jsl(jnp.asarray(x)))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert got.device.type == "cpu" and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), (x @ TS.magnitude_prune(
        w, 0.3).T if batch else TS.magnitude_prune(w, 0.3) @ x)
        + (b if bias else 0.0), rtol=2e-4, atol=2e-4)
    assert tsl.density == jsl.density
    assert tsl.shape == jsl.shape


def test_segment_width_and_plan_follow_the_reference():
    for d_in in (2, 96, 1100, 9000, 20000):
        w, _ = weights(8, d_in, seed=3)
        jsl = JS.SparseLinear.from_dense(w, density=0.5)
        tsl = TS.SparseLinear.from_dense(w, density=0.5, device="cpu")
        assert tsl.op.config.segment_width == jsl.op.config.segment_width
        assert tsl.op.plan.idx.tobytes() == jsl.op.plan.idx.tobytes()


def test_tensor_input_and_explicit_config():
    w, b = weights(32, 64, seed=4)
    cfg = TF.SerpensConfig(segment_width=16, lanes=8, sublanes=4)
    tsl = TS.SparseLinear.from_dense(w, density=0.5, bias=torch.from_numpy(b),
                                     config=cfg, device="cpu")
    assert tsl.op.config == cfg
    assert tsl.bias.dtype == torch.float32
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(3, 64)).astype(np.float32))
    want = x.numpy() @ TS.magnitude_prune(w, 0.5).T + b
    np.testing.assert_allclose(tsl(x).numpy(), want, **TOL)
    np.testing.assert_allclose(tsl(x.double()).numpy(), want, **TOL)


def test_rejects_bad_rank_and_defaults_to_the_card():
    tsl = TS.SparseLinear.from_dense(np.eye(8, dtype=np.float32), 1.0,
                                     device="cpu")
    with pytest.raises(ValueError, match="rank"):
        tsl(np.zeros((2, 2, 8), np.float32))
    x = np.random.default_rng(6).normal(size=8).astype(np.float32)
    np.testing.assert_allclose(tsl(x).numpy(), x, **TOL)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TS.SparseLinear.from_dense(np.eye(8, dtype=np.float32), 1.0)
