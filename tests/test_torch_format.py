"""The port's host layer encodes byte-identical streams to the reference.

``repro_torch.core.{format,partition,parallel_encode}`` are the port's own
numpy copies of the reference encoder; bf16 value streams are ``uint16``
bit patterns rounded without ``ml_dtypes``.  Every case encodes the same
seeded triples through both packages and compares bytes.
"""
import dataclasses
import sys

import ml_dtypes
import numpy as np
import pytest

from repro.core import format as F
from repro.core import partition as P
from repro_torch.core import format as TF
from repro_torch.core import parallel_encode as TPE
from repro_torch.core import partition as TP

from torch_port_util import assert_same_plan, random_coo

SMALL = dict(segment_width=64, lanes=8, sublanes=4, raw_window=4)
CONFIGS = {
    "paper": F.PAPER_CONFIG,
    "optimized": F.OPTIMIZED_CONFIG,
    "tpc2": F.SerpensConfig(**SMALL, tiles_per_chunk=2),
    "bf16": F.SerpensConfig(**SMALL, value_dtype="bfloat16"),
    "bf16-optimized": dataclasses.replace(F.OPTIMIZED_CONFIG,
                                          value_dtype="bfloat16"),
    "small-spill": F.SerpensConfig(**dict(SMALL, raw_window=2),
                                   spill_hot_rows=True, lane_balance=1.1),
}
# Legal specs only: a "single" plan has exactly one shard.
SPECS = [("single", 1, "modulo"), ("single", 1, "balanced"),
         ("row", 3, "modulo"), ("row", 2, "balanced"),
         ("col", 2, "modulo"), ("col", 3, "balanced")]


def port_config(cfg):
    return TF.SerpensConfig(**dataclasses.asdict(cfg))


def both_plans(cfg, spec, m=300, k=9000, nnz=3000, seed=0, hot_rows=5):
    r, c, v = random_coo(m, k, nnz, seed=seed, hot_rows=hot_rows)
    ref = P.make_plan(r, c, v, (m, k), cfg, P.PlanSpec(*spec))
    port = TP.make_plan(r, c, v, (m, k), port_config(cfg),
                        TP.PlanSpec(*spec))
    return ref, port


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: f"{s[0]}{s[1]}-{s[2]}")
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_make_plan_byte_identical(name, spec):
    ref, port = both_plans(CONFIGS[name], spec)
    assert_same_plan(ref, port)


@pytest.mark.parametrize("name", ["paper", "bf16", "small-spill"])
def test_encode_and_reference_encoder_byte_identical(name):
    cfg = CONFIGS[name]
    r, c, v = random_coo(200, 700, 1500, seed=3, hot_rows=4)
    for enc_ref, enc_port in ((F.encode, TF.encode),
                              (F.encode_reference, TF.encode_reference)):
        a = enc_ref(r, c, v, (200, 700), cfg)
        b = enc_port(r, c, v, (200, 700), port_config(cfg))
        a_val = a.val if a.val.dtype == np.float32 else a.val.view(np.uint16)
        for x, y in ((a.idx, b.idx), (a_val, b.val), (a.seg_ids, b.seg_ids),
                     (a.aux_rows, b.aux_rows), (a.aux_vals, b.aux_vals)):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
        np.testing.assert_array_equal(F.decode_to_coo(a)[2],
                                      TF.decode_to_coo(b)[2])


def test_bf16_bits_match_ml_dtypes():
    rng = np.random.default_rng(0)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan,
                        1e-45, -1e-45, 1e-40, 1.17549435e-38,
                        3.4028235e38, -3.4028235e38, 1.0, 1.00390625,
                        1.01171875, 1.0078125, 65504.0], np.float32)
    mags = 10.0 ** rng.integers(-44, 38, 20000)
    x = np.concatenate([special, (rng.normal(size=20000) * mags)
                        .astype(np.float32),
                        rng.integers(0, 2**32, 20000, dtype=np.uint64)
                        .astype(np.uint32).view(np.float32)])
    with np.errstate(invalid="ignore"):       # NaN payloads among x
        want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(TF.bf16_bits(x), want)
    finite = np.isfinite(x)
    np.testing.assert_array_equal(
        TF.values_f32(want)[finite],
        want.view(ml_dtypes.bfloat16).astype(np.float32)[finite])
    assert TF.value_np_dtype("bfloat16") == np.uint16


def test_row_0xffff_boundary():
    """Lane-local row 0xFFFF packs to a negative int32 that is not the
    sentinel; both encoders keep it live and byte-identical."""
    cfg = F.SerpensConfig(**SMALL)
    m = cfg.lanes * 0x10000
    r = np.array([m - 1, m - 5, 0, 17], np.int64)
    c = np.array([3, 63, 5, 7], np.int64)
    v = np.array([1.5, -2.0, 3.0, 0.25], np.float32)
    a = F.encode(r, c, v, (m, 64), cfg)
    b = TF.encode(r, c, v, (m, 64), port_config(cfg))
    assert a.idx.tobytes() == b.idx.tobytes()
    live = b.idx[b.idx != -1]
    assert (live < 0).sum() == 2           # rows m-1 and m-5: row 0xFFFF
    got = sorted(zip(*(t.tolist() for t in TF.decode_to_coo(b))))
    assert got == sorted(zip(r.tolist(), c.tolist(), v.tolist()))


def test_delta_splice_byte_identical():
    cfg = CONFIGS["small-spill"]
    r, c, v = random_coo(300, 900, 2000, seed=5, hot_rows=3)
    dr, dc, dv = random_coo(300, 900, 60, seed=6)
    spec = ("row", 2, "modulo")
    ref_prep = F.prepare(r, c, v, (300, 900), cfg)
    port_prep = TF.prepare(r, c, v, (300, 900), port_config(cfg))
    ref_plan = P.plan_from_prepared(ref_prep, P.PlanSpec(*spec))
    port_plan = TP.plan_from_prepared(port_prep, TP.PlanSpec(*spec))
    for mode in ("add", "set", "delete"):
        rm = ref_prep.merge_delta(dr, dc, dv, mode=mode)
        pm = port_prep.merge_delta(dr, dc, dv, mode=mode)
        ref2, _, _ = P.plan_apply_delta(ref_plan, ref_prep, merge=rm)
        port2, _, _ = TP.plan_apply_delta(port_plan, port_prep, merge=pm)
        assert_same_plan(ref2, port2)


def test_parallel_encode_matches_serial():
    cfg = port_config(CONFIGS["bf16"])
    r, c, v = random_coo(400, 5000, 4000, seed=7, hot_rows=3)
    spec = TP.PlanSpec("row", 2)
    serial = TP.make_plan(r, c, v, (400, 5000), cfg, spec)
    with TPE.EncodePool(2, start_method="spawn") as pool:
        par = TP.make_plan(r, c, v, (400, 5000), cfg, spec, n_workers=2,
                           pool=pool)
    assert_same_plan(serial, par)


def test_fork_refused_once_torch_is_loaded():
    import torch  # noqa: F401
    assert "torch" in sys.modules
    assert not TPE._fork_cow_ok()
    assert TPE.default_start_method() == "spawn"


def test_check_invariants_waits_for_analysis():
    """The analysis package is ported: ``check_invariants`` proves a bf16
    stream against its source, and lists what a corrupted copy breaks
    (tests/test_torch_analysis.py holds the verifier to the reference)."""
    cfg = port_config(CONFIGS["bf16"])
    coo = random_coo(50, 80, 100)
    sm = TF.encode(*coo, (50, 80), cfg)
    TF.check_invariants(sm, source=coo)
    val = sm.val.copy()
    val[sm.idx == TF.SENTINEL] = 0x3F80          # bf16 1.0 in padding
    with pytest.raises(AssertionError, match="sentinel"):
        TF.check_invariants(dataclasses.replace(sm, val=val))
