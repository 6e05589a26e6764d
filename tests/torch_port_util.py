"""Shared helpers for the tests that hold the PyTorch port against the JAX
reference package (``tests/test_torch_*.py``)."""
import dataclasses

import numpy as np
import pytest

from repro_torch import convert


@pytest.fixture(scope="module", autouse=True)
def reference_compiled_here():
    """JAX's persistent compilation cache off for the importing test
    module, restored after it, so that the reference each test holds the
    port to is compiled by this process.  Where the environment names a
    cache directory, a call whose compile passes the cache's threshold (a
    second) is otherwise served whatever executable another process wrote
    under the same key, which need not compute as this process's own
    compile does."""
    import jax
    was = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    yield
    jax.config.update("jax_enable_compilation_cache", was)


def plan_fields(plan) -> dict:
    """The numpy fields of a reference (``repro``) plan, in the form
    :func:`repro_torch.convert.plan_from_arrays` takes.  A bf16 value
    stream travels as its ``uint16`` bit patterns."""
    def val_bits(v):
        return v if v.dtype == np.float32 else v.view(np.uint16)

    return {
        "shape": tuple(plan.shape),
        "config": dataclasses.asdict(plan.config),
        "spec": dataclasses.asdict(plan.spec),
        "block_m": plan.block_m,
        "block_k": plan.block_k,
        "row_perm": plan.row_perm,
        "shards": [{
            "shape": sm.shape, "nnz": sm.nnz,
            "num_segments": sm.num_segments, "idx": sm.idx,
            "val": val_bits(sm.val), "seg_ids": sm.seg_ids,
            "aux_rows": sm.aux_rows, "aux_cols": sm.aux_cols,
            "aux_vals": sm.aux_vals} for sm in plan.shards],
    }


def carry_plan(plan):
    """The reference plan rebuilt as a port plan (same stream bytes)."""
    return convert.plan_from_arrays(plan_fields(plan))


def assert_same_plan(ref, port) -> None:
    """Byte-identical streams: idx, value bits, seg_ids, aux, row_perm."""
    assert tuple(ref.shape) == tuple(port.shape)
    assert ref.num_shards == port.num_shards
    assert (ref.block_m, ref.block_k, ref.num_segments_local) == \
        (port.block_m, port.block_k, port.num_segments_local)
    ref_val = ref.val if ref.val.dtype == np.float32 \
        else ref.val.view(np.uint16)
    assert ref_val.dtype == port.val.dtype
    for name, a, b in (("idx", ref.idx, port.idx), ("val", ref_val,
                                                    port.val),
                       ("seg_ids", ref.seg_ids, port.seg_ids),
                       ("aux_rows", ref.aux_rows, port.aux_rows),
                       ("aux_cols", ref.aux_cols, port.aux_cols),
                       ("aux_vals", ref.aux_vals, port.aux_vals)):
        assert a.dtype == b.dtype, name
        assert a.tobytes() == b.tobytes(), name
    if ref.row_perm is None:
        assert port.row_perm is None
    else:
        assert np.array_equal(ref.row_perm, port.row_perm)
    for sa, sb in zip(ref.shards, port.shards):
        assert sa.nnz == sb.nnz and sa.num_segments == sb.num_segments


def random_coo(m, k, nnz, seed=0, hot_rows=0):
    """Seeded COO triples; ``hot_rows`` > 0 piles extra entries on a few
    rows so the spill and RAW-window paths have work."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, m, nnz)
    if hot_rows:
        rows[: nnz // 3] = rng.integers(0, hot_rows, nnz // 3)
    cols = rng.integers(0, k, nnz)
    vals = rng.normal(size=nnz).astype(np.float32)
    return rows, cols, vals
