"""The port's stream kernels' plain versions against the JAX reference.

The same seeded plan, encoded by the reference package and carried across
with ``repro_torch.convert.plan_from_arrays``, goes through the JAX
``spmv_pallas``/``spmm_pallas`` (interpret mode on the CPU) and
``spmv_stream_xla``, and through the port's ``spmv``/``spmm`` wrappers,
which on CPU tensors run the plain PyTorch versions.  Tolerance: rtol =
atol = 1e-5, because the fp32 scatter-adds sum in another order.  The
CUDA kernels themselves are held against the same plain versions on the
card (``test_torch_chip.py``, ``chip_smoke.py``).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import format as F
from repro.core import partition as P
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import serpens_spmv as jk
from repro_torch.core import format as TF
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import serpens_spmv as ks

from torch_port_util import assert_same_plan, carry_plan, random_coo
from torch_port_util import reference_compiled_here  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)   # fp32 sums in another order
SMALL = dict(segment_width=64, lanes=8, sublanes=4, raw_window=4)
CONFIGS = {
    "small": F.SerpensConfig(**SMALL),
    "tpc2": F.SerpensConfig(segment_width=128, lanes=16, sublanes=8,
                            tiles_per_chunk=2),
    "raw2": F.SerpensConfig(**dict(SMALL, raw_window=2)),
    "bf16": F.SerpensConfig(**SMALL, value_dtype="bfloat16"),
    "paper-bf16": F.SerpensConfig(value_dtype="bfloat16"),
}


def stream(name, m=90, k=300, nnz=1200, seed=1):
    cfg = CONFIGS[name]
    r, c, v = random_coo(m, k, nnz, seed=seed, hot_rows=3)
    jplan = P.make_plan(r, c, v, (m, k), cfg, P.PlanSpec())
    tplan = carry_plan(jplan)
    assert_same_plan(jplan, tplan)
    return (r, c, v), jplan, tplan


def torch_stream(tplan):
    idx, val, seg = ops.device_arrays(tplan.shards[0], "cpu")
    cfg = tplan.config
    geo = dict(num_rows_padded=tplan.out_rows_padded,
               segment_width=cfg.segment_width)
    return idx, val, seg, geo, cfg.tiles_per_chunk


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_spmv_plain_matches_pallas_and_xla(name):
    (r, c, v), jplan, tplan = stream(name)
    cfg, sm = jplan.config, jplan.shards[0]
    kp = jplan.num_segments_local * cfg.segment_width
    x = np.random.default_rng(2).normal(size=jplan.shape[1]) \
        .astype(np.float32)
    xp = np.pad(x, (0, kp - x.size))
    want_pallas = jk.spmv_pallas(
        jnp.asarray(sm.idx), jnp.asarray(sm.val),
        jnp.asarray(sm.seg_ids[::cfg.tiles_per_chunk]),
        jnp.asarray(xp).reshape(-1, cfg.segment_width),
        num_rows_padded=jplan.out_rows_padded,
        segment_width=cfg.segment_width,
        tiles_per_chunk=cfg.tiles_per_chunk, interpret=True)
    want_xla = jops.spmv_stream_xla(
        jnp.asarray(sm.idx), jnp.asarray(sm.val), jnp.asarray(sm.seg_ids),
        jnp.asarray(xp), num_rows_padded=jplan.out_rows_padded,
        segment_width=cfg.segment_width)
    idx, val, seg, geo, tpc = torch_stream(tplan)
    got = ks.spmv(idx, val, seg, torch.from_numpy(xp), tiles_per_chunk=tpc,
                  **geo)
    assert got.dtype == torch.float32 and got.shape == (geo[
        "num_rows_padded"],)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_pallas), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_xla), **TOL)


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("name", ["small", "tpc2", "bf16"])
def test_spmm_plain_matches_pallas_and_xla(name, n):
    (r, c, v), jplan, tplan = stream(name)
    cfg, sm = jplan.config, jplan.shards[0]
    kp = jplan.num_segments_local * cfg.segment_width
    x = np.random.default_rng(3).normal(size=(jplan.shape[1], n)) \
        .astype(np.float32)
    xp = np.pad(x, ((0, kp - x.shape[0]), (0, 0)))
    want_pallas = jk.spmm_pallas(
        jnp.asarray(sm.idx), jnp.asarray(sm.val),
        jnp.asarray(sm.seg_ids[::cfg.tiles_per_chunk]),
        jnp.asarray(xp).reshape(-1, cfg.segment_width, n),
        num_rows_padded=jplan.out_rows_padded,
        segment_width=cfg.segment_width,
        tiles_per_chunk=cfg.tiles_per_chunk, interpret=True)
    want_xla = jops.spmm_stream_xla(
        jnp.asarray(sm.idx), jnp.asarray(sm.val), jnp.asarray(sm.seg_ids),
        jnp.asarray(xp), num_rows_padded=jplan.out_rows_padded,
        segment_width=cfg.segment_width)
    idx, val, seg, geo, tpc = torch_stream(tplan)
    got = ks.spmm(idx, val, seg, torch.from_numpy(xp), tiles_per_chunk=tpc,
                  **geo)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_pallas), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_xla), **TOL)


def test_coo_oracles_match_reference():
    r, c, v = random_coo(70, 90, 500, seed=4)
    rng = np.random.default_rng(5)
    x, y = rng.normal(size=90).astype(np.float32), \
        rng.normal(size=70).astype(np.float32)
    xm = rng.normal(size=(90, 3)).astype(np.float32)
    ym = rng.normal(size=(70, 3)).astype(np.float32)
    t = torch.from_numpy
    j = jnp.asarray
    np.testing.assert_allclose(
        ref.spmv_coo_ref(t(r), t(c), t(v), t(x), 70, 1.5, -0.5, t(y)),
        jref.spmv_coo_ref(j(r), j(c), j(v), j(x), 70, 1.5, -0.5, j(y)),
        **TOL)
    np.testing.assert_allclose(
        ref.spmm_coo_ref(t(r), t(c), t(v), t(xm), 70, 0.5, 2.0, t(ym)),
        jref.spmm_coo_ref(j(r), j(c), j(v), j(xm), 70, 0.5, 2.0, j(ym)),
        **TOL)
    dense = np.zeros((70, 90), np.float32)
    np.add.at(dense, (r, c), v)
    np.testing.assert_allclose(
        ref.spmv_dense_ref(t(dense), t(x), 2.0, 1.0, t(y)),
        jref.spmv_dense_ref(j(dense), j(x), 2.0, 1.0, j(y)), **TOL)


def test_row_0xffff_decodes_unsigned():
    """A live word with row 0xFFFF is negative as int32 but not -1."""
    cfg = TF.SerpensConfig(**SMALL)
    m = cfg.lanes * 0x10000
    r = np.array([m - 1, 3], np.int64)
    c = np.array([5, 60], np.int64)
    v = np.array([2.0, -1.0], np.float32)
    sm = TF.encode(r, c, v, (m, 64), cfg)
    idx, val, seg = ops.device_arrays(sm, "cpu")
    x = torch.arange(64, dtype=torch.float32)
    got = ks.spmv(idx, val, seg, x, num_rows_padded=sm.padded_rows,
                  segment_width=64)
    want = ref.spmv_coo_ref(torch.from_numpy(r), torch.from_numpy(c),
                            torch.from_numpy(v), x, sm.padded_rows)
    torch.testing.assert_close(got, want)
    assert float(got[m - 1]) == 10.0


def test_wrapper_input_checks():
    _, _, tplan = stream("tpc2")
    idx, val, seg, geo, tpc = torch_stream(tplan)
    kp = tplan.num_segments_local * tplan.config.segment_width
    x = torch.zeros(kp)
    with pytest.raises(ValueError, match="tiles_per_chunk"):
        ks.spmv(idx[:-1], val[:-1], seg[:-1], x, tiles_per_chunk=tpc, **geo)
    with pytest.raises(ValueError, match="seg_ids shaped"):
        ks.spmv(idx, val, seg[:-2], x, tiles_per_chunk=tpc, **geo)
    with pytest.raises(ValueError, match="seg_ids shaped"):
        ks.spmm(idx, val, seg[::2], x[:, None], tiles_per_chunk=tpc, **geo)
    with pytest.raises(ValueError, match="1-D x"):
        ks.spmv(idx, val, seg, x[:, None], **geo)
    with pytest.raises(ValueError, match="int32"):
        ks.spmv(idx.long(), val, seg, x, **geo)


def test_plain_path_counts_no_launch():
    _, _, tplan = stream("small")
    idx, val, seg, geo, tpc = torch_stream(tplan)
    kp = tplan.num_segments_local * tplan.config.segment_width
    before = (ks.spmv_launches, ks.spmm_launches)
    ks.spmv(idx, val, seg, torch.ones(kp), **geo)
    ks.spmm(idx, val, seg, torch.ones(kp, 2), **geo)
    assert (ks.spmv_launches, ks.spmm_launches) == before


def test_resolve_backend_agrees_with_device():
    assert ops.resolve_backend("auto", "cpu") == "torch"
    assert ops.resolve_backend(None, "cuda") == "cuda"
    assert ops.resolve_backend("torch", "cpu") == "torch"
    with pytest.raises(ValueError, match="not a fallback"):
        ops.resolve_backend("torch", "cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.resolve_backend("cuda", "cpu")
    for jax_name in ("xla", "pallas"):
        with pytest.raises(ValueError, match="JAX backend"):
            ops.resolve_backend(jax_name, "cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        ops.resolve_backend("triton", "cpu")


def test_resolve_device_refuses_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.resolve_device("cuda")
    assert ops.resolve_device("cpu") == torch.device("cpu")


def test_run_stream_counts_dispatches_and_checks_backend():
    _, _, tplan = stream("bf16")
    idx, val, seg, geo, tpc = torch_stream(tplan)
    assert val.dtype == torch.bfloat16
    kp = tplan.num_segments_local * tplan.config.segment_width
    x = ops.pad_x(torch.ones(tplan.shape[1]), tplan.num_segments_local,
                  tplan.config.segment_width)
    assert x.shape == (kp,)
    before = ops.trace_dispatch_count()
    ops.run_stream(idx, val, seg, x, backend="torch", **geo)
    ops.run_stream(idx, val, seg, x[:, None], **geo)
    assert ops.trace_dispatch_count() == before + 2
    with pytest.raises(ValueError):
        ops.run_stream(idx, val, seg, x, backend="cuda", **geo)


def test_device_arrays_keep_bf16_bits():
    cfg = TF.SerpensConfig(**SMALL, value_dtype="bfloat16")
    sm = TF.encode(*random_coo(40, 70, 300, seed=8), (40, 70), cfg)
    _, val, _ = ops.device_arrays(sm, "cpu")
    assert val.dtype == torch.bfloat16
    np.testing.assert_array_equal(val.view(torch.int16).numpy()
                                  .view(np.uint16), sm.val)
    np.testing.assert_array_equal(val.float().numpy(),
                                  TF.values_f32(sm.val))


def test_carry_rejects_mismatched_value_dtype():
    _, jplan, _ = stream("bf16")
    from torch_port_util import plan_fields
    from repro_torch import convert
    fields = plan_fields(jplan)
    fields["shards"][0]["val"] = jplan.shards[0].val.astype(np.float32)
    with pytest.raises(ValueError, match="bfloat16 stream"):
        convert.plan_from_arrays(fields)
    fields = plan_fields(jplan)
    fields["config"] = dataclasses.asdict(
        dataclasses.replace(jplan.config, value_dtype="float32"))
    with pytest.raises(ValueError, match="float32 stream"):
        convert.plan_from_arrays(fields)
