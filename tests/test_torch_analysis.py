"""The port's static analysis (``repro_torch.analysis``) against the
reference's (``repro.analysis``), on the CPU.

* **Verifier parity.**  The two encoders give byte-identical streams
  (``tests/test_torch_format.py``), so on the same COO both verifiers must
  report the same findings — rule id, message, severity and (shard, tile,
  lane) location — on clean plans and on one mutated copy per rule, in
  fp32 and bf16 (the port's bf16 stream is its ``uint16`` bit patterns,
  the reference's an ``ml_dtypes`` array).  Exact equality, no tolerance.
* The verifier's own bf16 rounding is bit-equal to ``ml_dtypes``.
* ``check_invariants`` and ``MatrixRegistry.put(verify=...)``.
* **Linter.**  Every rule's true positives and negatives on synthetic
  sources under the port's scopes (``repro_torch/...``, ``torch`` where the
  reference names ``jax``); the port's tree lints clean, and each of its
  suppressions sits at a site the reference suppresses too.
* The CLI: ``lint``, ``--list-rules``, ``verify`` and ``verify --npz``.
"""
import dataclasses
import os

import ml_dtypes
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.analysis import verify as jverify
from repro.core import format as JF
from repro.core import partition as JP
from repro_torch.analysis import (Diagnostics, VerificationError,
                                  lint_paths, lint_source, verify_matrix,
                                  verify_plan)
from repro_torch.analysis import verify as tverify
from repro_torch.analysis.__main__ import _suite_cases, main
from repro_torch.analysis.rules import ALL_RULES
from repro_torch.core import format as TF
from repro_torch.core import partition as TP
from repro_torch.data import matrices as M

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(segment_width=128, lanes=8, sublanes=4)
CFG = dict(SMALL, raw_window=4)
SPILL = dict(SMALL, raw_window=2, spill_hot_rows=True, lane_balance=1.1)


def key(diags):
    """Everything a finding says, in order."""
    return [(d.rule, d.message, d.severity, d.shard, d.slot, d.lane)
            for d in diags.findings]


def configs(fields, dtype="float32"):
    """The same config in both packages."""
    return (JF.SerpensConfig(**fields, value_dtype=dtype),
            TF.SerpensConfig(**fields, value_dtype=dtype))


def plans(rows, cols, vals, shape, fields, dtype, spec):
    """(reference plan, port plan) of one COO, the same stream bytes."""
    jcfg, tcfg = configs(fields, dtype)
    jp = JP.make_plan(rows, cols, vals, shape, jcfg, JP.PlanSpec(*spec))
    tp = TP.make_plan(rows, cols, vals, shape, tcfg, TP.PlanSpec(*spec))
    return jp, tp


def matrices(rows, cols, vals, shape, fields, dtype):
    jcfg, tcfg = configs(fields, dtype)
    return (JF.encode(rows, cols, vals, shape, jcfg),
            TF.encode(rows, cols, vals, shape, tcfg))


def set_value(val, where, x: float):
    """Write the value ``x`` into a value stream at ``where``: rounded to
    bf16 by ``ml_dtypes`` in the reference's array, by the port's encoder
    in its ``uint16`` bits."""
    if val.dtype == np.uint16:
        val[where] = TF.bf16_bits(np.array([x], np.float32))[0]
    else:
        val[where] = x


def value_of(val, where) -> float:
    if val.dtype == np.uint16:
        return float(TF.values_f32(np.array([val[where]]))[0])
    return float(val[where])


def same_findings(jd, td, rule=None):
    assert key(td) == key(jd), (td.format(), jd.format())
    if rule is not None:
        assert rule in td.rules_fired(), td.format()
    return td


def uniform(m=200, k=300, nnz=2000, seed=0):
    return M.uniform_random(m, k, nnz, seed=seed)


def power(m=200, nnz=2000, seed=0):
    return M.power_law_graph(m, nnz, seed=seed)


# -- clean plans --------------------------------------------------------------
ZOO = list(_suite_cases())


@pytest.mark.parametrize("mode", ["full", "fast"])
@pytest.mark.parametrize("case", ZOO, ids=[c[0] for c in ZOO])
def test_zoo_plan_verifies_clean_as_in_the_reference(case, mode):
    """The CLI's plan zoo (fp32 and bf16; single, row and col; spill;
    balanced lanes; empty and duplicate entries): both verifiers find
    nothing, with the source COO as ground truth."""
    name, r, c, v, shape, tcfg, spec = case
    jcfg = JF.SerpensConfig(**dataclasses.asdict(tcfg))
    jspec = JP.PlanSpec(**dataclasses.asdict(spec))
    jp = JP.make_plan(r, c, v, shape, jcfg, jspec)
    tp = TP.make_plan(r, c, v, shape, tcfg, spec)
    td = same_findings(jverify.verify_plan(jp, r, c, v, mode=mode),
                       verify_plan(tp, r, c, v, mode=mode))
    assert td.ok and not td.findings


def test_fuzz_sweep_matches_the_reference():
    """Seeded random geometry × random COO, legal specs only ("single"
    means one shard), both dtypes."""
    rng = np.random.default_rng(42)
    for trial in range(16):
        m = int(rng.integers(20, 300))
        k = int(rng.integers(20, 300))
        nnz = int(rng.integers(0, 4 * max(m, k)))
        fields = dict(segment_width=int(rng.choice([32, 48, 128])),
                      lanes=int(rng.choice([4, 8])),
                      sublanes=int(rng.choice([2, 4])),
                      raw_window=int(rng.integers(1, 6)),
                      spill_hot_rows=bool(rng.integers(0, 2)),
                      lane_balance=float(rng.choice([0.0, 1.1])))
        part, nsh = [("single", 1), ("row", 2),
                     ("col", 3)][int(rng.integers(0, 3))]
        assign = ("modulo", "balanced")[int(rng.integers(0, 2))]
        dtype = ("float32", "bfloat16")[trial % 2]
        rows = rng.integers(0, m, nnz)
        cols = rng.integers(0, k, nnz)
        vals = rng.normal(size=nnz).astype(np.float32)
        jp, tp = plans(rows, cols, vals, (m, k), fields, dtype,
                       (part, nsh, assign))
        td = same_findings(jverify.verify_plan(jp, rows, cols, vals),
                           verify_plan(tp, rows, cols, vals))
        assert td.ok, f"trial {trial}: {td.format()}"


# -- mutations: one per rule, the same corruption in both packages -----------
def _first_live(idx):
    return tuple(int(x) for x in np.argwhere(idx != TF.SENTINEL)[0])


def m_seg_monotone(sm, src):
    seg = np.array(sm.seg_ids)
    seg[0], seg[-1] = seg[-1], seg[0]
    return dataclasses.replace(sm, seg_ids=seg), {}


def m_raw_window(sm, src):
    idx, val = np.array(sm.idx), np.array(sm.val)
    t, s, lane = (int(x) for x in np.argwhere(
        idx[:, :-1, :] != TF.SENTINEL)[0])
    idx[t, s + 1, lane] = idx[t, s, lane]
    set_value(val, (t, s + 1, lane), 1.0)
    return dataclasses.replace(sm, idx=idx, val=val), {}


def m_lane_capacity(sm, src):
    idx = np.array(sm.idx)
    where = _first_live(idx)
    cap = -(-sm.shape[0] // sm.config.lanes)
    idx[where] = np.int32(((cap + 5) << 16) | 3)
    return dataclasses.replace(sm, idx=idx), {}


def m_sentinel_value(sm, src):
    idx, val = np.array(sm.idx), np.array(sm.val)
    where = tuple(int(x) for x in np.argwhere(idx == TF.SENTINEL)[0])
    set_value(val, where, 7.0)
    return dataclasses.replace(sm, val=val), {}


def m_col_range(sm, src):
    idx = np.array(sm.idx)
    where = _first_live(idx)
    rr = int(idx[where]) >> 16 & 0xFFFF
    idx[where] = np.int32((rr << 16) | sm.config.segment_width)
    return dataclasses.replace(sm, idx=idx), {}


def m_nnz_account(sm, src):
    idx, val = np.array(sm.idx), np.array(sm.val)
    where = _first_live(idx)
    idx[where] = TF.SENTINEL
    set_value(val, where, 0.0)
    return dataclasses.replace(sm, idx=idx, val=val), {}


def m_spill_legal(sm, src):
    aux = np.array(sm.aux_rows)
    aux[0] = sm.shape[0] + 7
    return dataclasses.replace(sm, aux_rows=aux), {"mode": "fast"}


def m_round_trip(sm, src):
    val = np.array(sm.val)
    where = _first_live(np.asarray(sm.idx))
    set_value(val, where, value_of(val, where) * 2 + 1)
    return dataclasses.replace(sm, val=val), {"source": src}


def m_lane_ownership(sm, src):
    idx, val = np.array(sm.idx), np.array(sm.val)
    counts = (idx != TF.SENTINEL).sum(axis=(0, 1))
    a, b = int(np.argmax(counts)), int(np.argmin(counts))
    idx[:, :, [a, b]] = idx[:, :, [b, a]]
    val[:, :, [a, b]] = val[:, :, [b, a]]
    return dataclasses.replace(sm, idx=idx, val=val), {"source": src}


def m_byte_account(sm, src):
    val = np.asarray(sm.val)
    wide = (TF.values_f32(val) if val.dtype == np.uint16
            else val).astype(np.float64)
    return dataclasses.replace(sm, val=wide), {"mode": "fast"}


def m_shape_static(sm, src):
    return (dataclasses.replace(sm, seg_ids=np.array(sm.seg_ids[:-1])),
            {"mode": "fast"})


def m_row_perm(sm, src):
    return sm, {"row_perm": np.zeros(5, np.int64) + 10**9}


MATRIX_MUTATIONS = {
    # rule: (mutation, fixture (generator, config fields))
    "seg-monotone": (m_seg_monotone, (uniform, CFG)),
    "raw-window": (m_raw_window, (uniform, CFG)),
    "lane-capacity": (m_lane_capacity, (uniform, CFG)),
    "sentinel": (m_sentinel_value, (uniform, CFG)),
    "col-range": (m_col_range, (uniform, CFG)),
    "nnz-account": (m_nnz_account, (uniform, CFG)),
    "spill-legal": (m_spill_legal, (power, SPILL)),
    "round-trip": (m_round_trip, (uniform, CFG)),
    "lane-ownership": (m_lane_ownership, (power, CFG)),
    "byte-account": (m_byte_account, (uniform, CFG)),
    "shape-static": (m_shape_static, (uniform, CFG)),
    "row-perm": (m_row_perm, (uniform, CFG)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rule", sorted(MATRIX_MUTATIONS))
def test_matrix_mutation_fires_as_in_the_reference(rule, dtype):
    mutate, (gen, fields) = MATRIX_MUTATIONS[rule]
    coo = gen()
    shape = (200, 300) if gen is uniform else (200, 200)
    jsm, tsm = matrices(*coo, shape, fields, dtype)
    jbad, jkw = mutate(jsm, coo)
    tbad, tkw = mutate(tsm, coo)
    same_findings(jverify.verify_matrix(jbad, **jkw),
                  verify_matrix(tbad, **tkw), rule)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sentinel_reserved_row_as_in_the_reference(dtype):
    """At segment_width 65536 a live row 0xFFFF aliases the null word."""
    fields = dict(segment_width=1 << 16, lanes=4, sublanes=4, raw_window=2)
    jsm, tsm = matrices(*uniform(40, 200, 300), (40, 200), fields, dtype)
    out = []
    for sm in (jsm, tsm):
        idx = np.array(sm.idx)
        idx[_first_live(idx)] = np.uint32((0xFFFF << 16) | 5).astype(
            np.int32)
        out.append(dataclasses.replace(sm, idx=idx))
    same_findings(jverify.verify_matrix(out[0], mode="fast"),
                  verify_matrix(out[1], mode="fast"), "sentinel")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spill_mutations_as_in_the_reference(dtype):
    """Aux entries under a config without spill (spill-legal), and one hot
    row encoded without spill audited as if it had promised it
    (spill-cap)."""
    jsm, tsm = matrices(*uniform(), (200, 300), CFG, dtype)
    found = []
    for sm, mod in ((jsm, jverify), (tsm, tverify)):
        bad = dataclasses.replace(sm, aux_rows=np.array([1], np.int32),
                                  aux_cols=np.array([1], np.int32),
                                  aux_vals=np.array([1.0], np.float32))
        bad.nnz += 1
        found.append(mod.verify_matrix(bad, mode="fast"))
    same_findings(*found, "spill-legal")
    rows, cols = np.zeros(60, np.int64), np.arange(60, dtype=np.int64)
    vals = np.ones(60, np.float32)
    fields = dict(SMALL, raw_window=2)
    found = []
    for sm, mod in zip(matrices(rows, cols, vals, (16, 128), fields, dtype),
                       (jverify, tverify)):
        lying = dataclasses.replace(
            sm, config=dataclasses.replace(sm.config, spill_hot_rows=True))
        found.append(mod.verify_matrix(lying))
    same_findings(*found, "spill-cap")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunk_misalignment_as_in_the_reference(dtype):
    fields = dict(CFG, tiles_per_chunk=2)
    found = []
    for sm, mod in zip(matrices(*uniform(), (200, 300), fields, dtype),
                       (jverify, tverify)):
        bad = dataclasses.replace(sm, idx=np.array(sm.idx[:-1]),
                                  val=np.array(sm.val[:-1]),
                                  seg_ids=np.array(sm.seg_ids[:-1]))
        found.append(mod.verify_matrix(bad, mode="fast"))
    same_findings(*found, "shape-static")


def p_row_perm_not_injective(plan):
    perm = np.array(plan.row_perm)
    perm[1] = perm[0]
    plan.row_perm = perm


def p_row_perm_on_modulo(plan):
    plan.row_perm = np.arange(plan.shape[0], dtype=np.int64)


def p_row_perm_cross_block(plan):
    perm = np.array(plan.row_perm)
    in_b0 = np.flatnonzero(perm < plan.block_m)[0]
    in_b1 = np.flatnonzero(perm >= plan.block_m)[0]
    perm[[in_b0, in_b1]] = perm[[in_b1, in_b0]]
    plan.row_perm = perm


def p_wrong_block(plan):
    plan.block_m += plan.config.lanes


def p_corrupt_stack(plan):
    stacked = np.array(plan.idx)
    stacked[0, 0, 0, 0] ^= np.int32(1)
    plan.idx = stacked


def p_stack_tail_value(plan):
    """A nonzero value in the padding after the shorter shard's stream."""
    s = int(np.argmin([sm.num_tiles for sm in plan.shards]))
    tk = int(plan.shards[s].num_tiles)
    assert tk < plan.idx.shape[1], "fixture needs a padded shard"
    val = np.array(plan.val)
    set_value(val, (s, tk, 0, 0), 3.0)
    plan.val = val


PLAN_MUTATIONS = {
    "row-perm not injective": (p_row_perm_not_injective, "row-perm",
                               ("single", 1, "balanced")),
    "row-perm on modulo": (p_row_perm_on_modulo, "row-perm", ("row", 2)),
    "row-perm cross block": (p_row_perm_cross_block, "row-perm",
                             ("row", 2, "balanced")),
    "wrong block": (p_wrong_block, "shard-coverage", ("row", 2)),
    "corrupt stack": (p_corrupt_stack, "stack-consistent", ("row", 2)),
    "stack tail value": (p_stack_tail_value, "stack-consistent",
                         ("row", 2)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(PLAN_MUTATIONS))
def test_plan_mutation_fires_as_in_the_reference(name, dtype):
    mutate, rule, spec = PLAN_MUTATIONS[name]
    rows, cols, vals = power(240, 2400, seed=2)
    jp, tp = plans(rows, cols, vals, (240, 240), SPILL, dtype, spec)
    for plan in (jp, tp):
        mutate(plan)
    same_findings(jverify.verify_plan(jp, rows, cols, vals),
                  verify_plan(tp, rows, cols, vals), rule)


def test_bf16_plans_fail_the_reference_only_as_uint16():
    """Why the port has its own verifier: the reference's byte-account
    rule refuses the port's bf16 container, and the port's accepts it."""
    rows, cols, vals = power(240, 2400, seed=2)
    _, tp = plans(rows, cols, vals, (240, 240), SPILL, "bfloat16",
                  ("single", 1))
    assert "byte-account" in jverify.verify_plan(tp, mode="fast") \
        .rules_fired()
    assert verify_plan(tp, rows, cols, vals, mode="full").ok


# -- the verifier's bf16 rounding -------------------------------------------
def test_bf16_rounding_is_bit_equal_to_ml_dtypes():
    """Over seeded random bit patterns plus ties (odd and even kept
    halves), subnormals, the largest finite values, ±0, ±inf and NaNs
    with payloads."""
    rng = np.random.default_rng(7)
    bits = [rng.integers(0, 1 << 32, 200_000, dtype=np.uint64)
            .astype(np.uint32)]
    kept = rng.integers(0, 1 << 16, 4096, dtype=np.uint64).astype(np.uint32)
    bits.append((kept << 16) | np.uint32(0x8000))          # exact ties
    bits.append((kept << 16) | np.uint32(0x7FFF))
    bits.append((kept << 16) | np.uint32(0x8001))
    bits.append(rng.integers(0, 1 << 23, 4096, dtype=np.uint64)
                .astype(np.uint32))                          # subnormals
    bits.append(np.array([0, 0x80000000, 0x7F800000, 0xFF800000,
                          0x7F7FFFFF, 0xFF7FFFFF, 0x7F7F8000, 0x7F7F7FFF,
                          0x7FC00000, 0xFFC00000, 0x7F800001, 0xFFFFFFFF,
                          0x7FA00000, 0x00008000, 0x00018000, 0x80008000],
                         np.uint32))
    x = np.concatenate(bits).view(np.float32)
    with np.errstate(invalid="ignore"):
        want = x.astype(ml_dtypes.bfloat16).astype(np.float32)
        ref = jverify._quantize(x, np.dtype(ml_dtypes.bfloat16))
    got = tverify._quantize(x, "bfloat16")
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


# -- properties: random encodes, legal specs only -----------------------------
FIELDS = st.fixed_dictionaries(dict(
    segment_width=st.sampled_from([16, 64, 256]),
    lanes=st.sampled_from([2, 4, 8]),
    sublanes=st.sampled_from([2, 4]),
    raw_window=st.integers(1, 4),
    tiles_per_chunk=st.sampled_from([1, 2]),
    spill_hot_rows=st.booleans(),
    lane_balance=st.sampled_from([0.0, 1.2])))
# "single" plans have exactly one shard; row and col take 1-3.
SPECS = st.one_of(
    st.tuples(st.just("single"), st.just(1),
              st.sampled_from(["modulo", "balanced"])),
    st.tuples(st.sampled_from(["row", "col"]), st.integers(1, 3),
              st.sampled_from(["modulo", "balanced"])))
COOS = st.builds(
    lambda m, k, nnz, seed: (m, k, *_coo(m, k, nnz, seed)),
    m=st.integers(1, 60), k=st.integers(1, 80),
    nnz=st.integers(0, 250), seed=st.integers(0, 2**31))


def _coo(m, k, nnz, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, m, nnz), rng.integers(0, k, nnz),
            rng.normal(size=nnz).astype(np.float32))


@settings(max_examples=60, deadline=None)
@given(coo=COOS, fields=FIELDS, spec=SPECS,
       dtype=st.sampled_from(["float32", "bfloat16"]))
def test_every_plan_verifies_clean_in_both_packages(coo, fields, spec,
                                                    dtype):
    m, k, rows, cols, vals = coo
    jp, tp = plans(rows, cols, vals, (m, k), fields, dtype, spec)
    td = same_findings(jverify.verify_plan(jp, rows, cols, vals),
                       verify_plan(tp, rows, cols, vals))
    assert td.ok, td.format()


@settings(max_examples=40, deadline=None)
@given(coo=COOS, fields=FIELDS, dtype=st.sampled_from(["float32",
                                                       "bfloat16"]),
       slot=st.integers(0, 2**31))
def test_single_slot_corruption_is_caught_as_in_the_reference(
        coo, fields, dtype, slot):
    """Flipping one live slot's column low bit: only the round-trip proof
    can see it, in both packages alike."""
    m, k, rows, cols, vals = coo
    found = []
    for sm, mod in zip(matrices(rows, cols, vals, (m, k), fields, dtype),
                       (jverify, tverify)):
        live = np.argwhere(np.asarray(sm.idx) != TF.SENTINEL)
        if live.size == 0:
            return
        t, s, lane = (int(x) for x in live[slot % len(live)])
        idx = np.array(sm.idx)
        idx[t, s, lane] ^= np.int32(1)
        found.append(mod.verify_matrix(dataclasses.replace(sm, idx=idx),
                                       source=(rows, cols, vals)))
    assert not same_findings(*found).ok


# -- check_invariants ---------------------------------------------------------
def _spill_matrix():
    rows, cols, vals = power()
    sm = TF.encode(rows, cols, vals, (200, 200), TF.SerpensConfig(**SPILL))
    assert sm.n_aux > 0, "fixture needs actual spills"
    return rows, cols, vals, sm


def test_check_invariants_passes_clean_matrices():
    rows, cols, vals, sm = _spill_matrix()
    TF.check_invariants(sm)
    TF.check_invariants(sm, source=(rows, cols, vals))
    bf = TF.encode(rows, cols, vals, (200, 200),
                   TF.SerpensConfig(**SPILL, value_dtype="bfloat16"))
    TF.check_invariants(bf, source=(rows, cols, vals))


@pytest.mark.parametrize("rule", ["seg-monotone", "spill-legal",
                                  "row-perm", "round-trip"])
def test_check_invariants_raises_assertion_error(rule):
    rows, cols, vals, sm = _spill_matrix()
    kw = {}
    if rule == "seg-monotone":
        sm, _ = m_seg_monotone(sm, None)
    elif rule == "spill-legal":
        sm, _ = m_spill_legal(sm, None)
    elif rule == "row-perm":
        kw["row_perm"] = np.zeros(5, np.int64) + 10**9
    else:
        sm, _ = m_round_trip(sm, None)
        kw["source"] = (rows, cols, vals)
    with pytest.raises(AssertionError, match=rule):
        TF.check_invariants(sm, **kw)


# -- the registry's verify gate ----------------------------------------------
def registry(**kw):
    from repro_torch.core.registry import MatrixRegistry
    return MatrixRegistry(device="cpu", **kw)


def test_clean_puts_pass_both_modes():
    from repro_torch import obs
    rows, cols, vals = power(120, 900, seed=3)
    reg = registry(verify="full")
    obs.clear()
    obs.enable()
    try:
        assert reg.put(rows, cols, vals, (120, 120), num_shards=2,
                       partition="row")
        assert reg.put(rows, cols, vals, (120, 120), verify="fast",
                       lane_assign="balanced",
                       config=TF.SerpensConfig(**SPILL))
        assert reg.put(rows, cols, vals, (120, 120), verify="full",
                       value_dtype="bfloat16",
                       config=TF.SerpensConfig(**SPILL))
        mid = reg.put(rows, cols, vals, (120, 120), verify="fast",
                      value_dtype="bfloat16", blocking=False)
        reg.get(mid)
    finally:
        obs.disable()
        reg.close()
    spans = [args for buf in obs.TRACER.buffers()
             for ph, name, cat, _, _, args, _ in buf.events
             if ph == "X" and name == "verify"]
    assert [a["mode"] for a in spans] == ["full", "fast", "full", "fast"]
    assert all(a["findings"] == 0 for a in spans)


def _corrupting(monkeypatch):
    """Make every encode's plan swap its first and last seg ids."""
    import repro_torch.core.registry as R
    orig = R.penc.prepare_and_plan

    def corrupting(*args, **kw):
        prep, plan = orig(*args, **kw)
        seg = np.array(plan.shards[0].seg_ids)
        if seg.size > 1:
            seg[0], seg[-1] = seg[-1], seg[0]
        plan.shards[0].seg_ids = seg
        plan.seg_ids = seg[None]
        return prep, plan

    monkeypatch.setattr(R.penc, "prepare_and_plan", corrupting)


def test_bad_plan_rejected(monkeypatch):
    _corrupting(monkeypatch)
    rows, cols, vals = M.uniform_random(64, 600, 800, seed=4)
    reg = registry(config=TF.SerpensConfig(**CFG))
    with pytest.raises(VerificationError, match="seg-monotone"):
        reg.put(rows, cols, vals, (64, 600), verify="fast")
    assert len(reg) == 0
    # verify="off" lets the same corrupted plan through (debug gate).
    assert reg.put(rows, cols, vals, (64, 600), verify="off")


def test_bad_background_put_surfaces_on_ready_and_get(monkeypatch):
    _corrupting(monkeypatch)
    rows, cols, vals = M.uniform_random(64, 600, 800, seed=4)
    reg = registry(config=TF.SerpensConfig(**CFG), verify="full")
    try:
        mid = reg.put(rows, cols, vals, (64, 600), blocking=False)
        with pytest.raises(RuntimeError, match="failed") as err:
            reg.get(mid)
        assert isinstance(err.value.__cause__, VerificationError)
        assert "seg-monotone" in str(err.value.__cause__)
        with pytest.raises(RuntimeError) as err:
            reg.ready(mid)
        assert isinstance(err.value.__cause__, VerificationError)
    finally:
        reg.close()


def test_invalid_mode_rejected():
    reg = registry()
    rows, cols, vals = M.uniform_random(8, 8, 10, seed=5)
    with pytest.raises(ValueError, match="verify"):
        reg.put(rows, cols, vals, (8, 8), verify="paranoid")
    with pytest.raises(ValueError, match="verify"):
        registry(verify="sometimes")


def test_retune_reencode_is_not_gated(monkeypatch):
    """As in the reference, ``retune`` re-encodes from the prepared sort
    without the gate: only puts are verified."""
    from repro_torch.core import autotune as TA
    from repro_torch.core import features as TFE
    import repro_torch.core.registry as R
    calls = []
    orig = R.verify_gate

    def counting(plan, rows, cols, vals, verify):
        calls.append(verify)
        return orig(plan, rows, cols, vals, verify)

    monkeypatch.setattr(R, "verify_gate", counting)
    rows, cols, vals = power(64, 900, seed=6)
    cfg = TF.SerpensConfig()
    reg = registry(verify="full", config=cfg)
    mid = reg.put(rows, cols, vals, (64, 64), spec="auto")
    assert calls == ["full"]
    d = reg.tune_decision(mid)
    other = next(k for k in d.ranked if k != d.candidate.key)
    feats = TFE.compute_features(rows, cols, (64, 64), cfg)
    for cand in TA.default_candidates(feats, "torch"):
        rate = {d.candidate.key: 1e3, other: 1e7}.get(cand.key)
        for _ in range(4 if rate else 0):
            reg.tuner.observe(d.bucket, cand, slots_per_s=rate,
                              requests_per_s=rate)
    assert reg.retune(mid)
    assert reg.tune_decision(mid).candidate.key == other
    assert calls == ["full"]


# -- linter ------------------------------------------------------------------
def lint_str(src, path="src/repro_torch/serve/thing.py"):
    return lint_source(src, path, ALL_RULES)


def rules_of(diags):
    return {d.rule for d in diags}


def test_worker_import_true_positives():
    src = ("import numpy\nimport torch\nfrom repro_torch import obs\n"
           "import jax\n")
    diags, _ = lint_str(src, path="src/repro_torch/core/format.py")
    hits = [d for d in diags if d.rule == "worker-import"]
    assert {d.line for d in hits} == {2, 3}
    diags, _ = lint_str("import torch.nn as nn\n",
                        path="src/repro_torch/core/parallel_encode.py")
    assert rules_of(diags) == {"worker-import"}
    diags, _ = lint_str("from torch import profiler\n",
                        path="src/repro_torch/obs/profile.py")
    assert rules_of(diags) == {"worker-import"}


def test_worker_import_negatives():
    src = "def f():\n    import torch\n    return torch\n"
    diags, _ = lint_str(src, path="src/repro_torch/core/format.py")
    assert not diags.findings
    diags, _ = lint_str("import torch\n",
                        path="src/repro_torch/kernels/serpens_spmv.py")
    assert not diags.findings
    # repro_torch.obs may import itself; the reference's tree is not the
    # port's scope.
    diags, _ = lint_str("from repro_torch.obs import trace\n",
                        path="src/repro_torch/obs/export.py")
    assert not diags.findings
    diags, _ = lint_str("import torch\n", path="src/repro/core/format.py")
    assert not diags.findings


@pytest.mark.parametrize("call", ["self.op.matvec(x)", "op.matmat(x)",
                                  "torch.cuda.synchronize()",
                                  "end.synchronize()",
                                  "ops.device_arrays(sm, dev)",
                                  "ops.run_stream(i, v, s, x)",
                                  "cpart.plan_from_prepared(p, s)"])
def test_lock_blocking_call_true_positive(call):
    src = ("class S:\n"
           "    def f(self, x):\n"
           "        with self._lock:\n"
           f"            y = {call}\n"
           "        return y\n")
    diags, _ = lint_str(src)
    hits = [d for d in diags if d.rule == "lock-blocking-call"]
    assert hits and hits[0].line == 4


def test_lock_blocking_call_negatives():
    src = ("class S:\n"
           "    def f(self, x):\n"
           "        with self._lock:\n"
           "            op = self.op\n"
           "        torch.cuda.synchronize()\n"
           "        return op.matvec(x)\n"
           "    def g(self):\n"
           "        with self._result_cv:\n"
           "            self._result_cv.wait(1.0)\n")
    diags, _ = lint_str(src)
    assert "lock-blocking-call" not in rules_of(diags)
    src = ("class S:\n"
           "    def f(self, ev):\n"
           "        with self._lock:\n"
           "            ev.wait()\n")
    diags, _ = lint_str(src)
    assert "lock-blocking-call" in rules_of(diags)


def test_stat_lock():
    src = ("import threading\n"
           "class S:\n"
           "    def __init__(self):\n"
           "        self._lock = threading.Lock()\n"
           "    def f(self):\n"
           "        self._m_requests.inc()\n"
           "        self.stats.hits += 1\n"
           "    def g(self):\n"
           "        with self._lock:\n"
           "            self._m_requests.inc()\n"
           "            self.stats.hits += 1\n")
    diags, _ = lint_str(src)
    hits = [d for d in diags if d.rule == "stat-lock"]
    assert [d.line for d in hits] == [6, 7]
    diags, _ = lint_str("class S:\n    def f(self):\n"
                        "        self._m_requests.inc()\n")
    assert "stat-lock" not in rules_of(diags)


def test_span_context():
    src = ("def f():\n"
           "    obs.span('encode')\n"
           "    with obs.span('verify') as sp:\n"
           "        pass\n"
           "    stack.enter_context(obs.span('late'))\n")
    diags, _ = lint_str(src)
    hits = [d for d in diags if d.rule == "span-context"]
    assert [d.line for d in hits] == [2]


def test_bare_assert():
    diags, _ = lint_str("def f(x):\n    assert x > 0\n    return x\n")
    hits = [d for d in diags if d.rule == "bare-assert"]
    assert hits and hits[0].line == 2


def test_frozen_mutation():
    src = ("def f(prep, sm, plan):\n"
           "    prep.rows[0] = 1\n"
           "    sm.val = None\n"
           "    plan.idx[0] += 1\n")
    diags, _ = lint_str(src)
    assert len([d for d in diags if d.rule == "frozen-mutation"]) == 3
    src = ("def f(rows, entry, sm):\n"
           "    rows[0] = 1\n"
           "    entry.prepared = None\n"
           "    sm.num_segments = 4\n"
           "    x = sm.idx[0]\n")
    diags, _ = lint_str(src)
    assert "frozen-mutation" not in rules_of(diags)


def test_unbounded_queue_in_the_ports_serving_tier():
    src = ("import queue\n"
           "from collections import deque\n"
           "def f(self):\n"
           "    a = queue.Queue()\n"
           "    b = deque()\n"
           "    c = deque([1, 2])\n"
           "    d = queue.SimpleQueue()\n"
           "    item = self._inflight_queue.get()\n"
           "    e = queue.Queue(maxsize=2)\n"
           "    g = deque(maxlen=16)\n"
           "    ok = self.work_q.get(timeout=0.5)\n"
           "    cfg = self.options.get('x')\n"
           "    return a, b, c, d, e, g, item, ok, cfg\n")
    diags, _ = lint_str(src)
    hits = [d for d in diags if d.rule == "unbounded-queue"]
    assert {d.line for d in hits} == {4, 5, 6, 7, 8}
    # Out of scope: the reference's serving tier, and the port's others.
    for path in ("src/repro/serve/thing.py",
                 "src/repro_torch/analysis/scratch.py"):
        diags, _ = lint_str(src, path=path)
        assert "unbounded-queue" not in rules_of(diags)


def test_suppressions_and_syntax_errors():
    src = ("from collections import deque\n"
           "q = deque()  # repro-lint: disable=unbounded-queue\n"
           "def f(x):\n"
           "    assert x  # repro-lint: disable=bare-assert\n"
           "    assert x  # repro-lint: disable=all\n"
           "    assert x\n")
    diags, suppressed = lint_str(src)
    assert suppressed == 3
    assert [(d.rule, d.line) for d in diags] == [("bare-assert", 6)]
    diags, _ = lint_str("def f(:\n")
    assert rules_of(diags) == {"syntax"}


def test_ports_tree_lints_clean():
    diags, suppressed, nfiles = lint_paths(
        [os.path.join(ROOT, "src", "repro_torch")])
    assert nfiles > 50
    assert not diags.findings, diags.format()
    assert suppressed > 0


def test_every_suppression_is_one_the_reference_carries():
    """Each ``# repro-lint: disable`` in the port sits on a line the
    reference's counterpart file carries with the same suppression."""
    port_root = os.path.join(ROOT, "src", "repro_torch")
    seen = 0
    for base, _, files in os.walk(port_root):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(base, f)
            rel = os.path.relpath(path, port_root)
            with open(path, encoding="utf-8") as fh:
                lines = [ln.strip() for ln in fh
                         if "# repro-lint: disable=" in ln]
            if not lines or rel.startswith("analysis"):
                continue
            with open(os.path.join(ROOT, "src", "repro", rel),
                      encoding="utf-8") as fh:
                ref = {ln.strip() for ln in fh}
            for ln in lines:
                assert ln.replace("repro_torch", "repro") in ref, (rel, ln)
                seen += 1
    assert seen >= 10


# -- the CLI ------------------------------------------------------------------
def test_lint_cli(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text("def f(x):\n    assert x\n")
    assert main(["lint", str(bad)]) == 1
    assert "bare-assert" in capsys.readouterr().out
    good = tmp_path / "good.py"
    good.write_text("def f(x):\n    return x\n")
    assert main(["lint", str(good)]) == 0
    assert main(["lint", "--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in ALL_RULES:
        assert rule.name in out


def test_lint_cli_default_root_is_the_port(monkeypatch, capsys):
    monkeypatch.chdir(ROOT)
    assert main(["lint"]) == 0
    out = capsys.readouterr().out
    assert "repro-lint: OK — 0 finding(s)" in out


def test_verify_cli(tmp_path, capsys):
    rows, cols, vals = M.uniform_random(50, 60, 400, seed=9)
    npz = tmp_path / "m.npz"
    np.savez(npz, rows=rows, cols=cols, vals=vals, shape=np.array([50, 60]))
    assert main(["verify", "--npz", str(npz)]) == 0
    assert "OK" in capsys.readouterr().out
    assert main(["verify", "--mode", "fast"]) == 0
    out = capsys.readouterr().out
    assert f"{len(ZOO)} plan(s) verified (mode=fast), 0 failed" in out


def test_diagnostics_raise_lists_every_error():
    d = Diagnostics()
    d.add("seg-monotone", "a", slot=3)
    d.add("sentinel", "b", slot=4, lane=1)
    with pytest.raises(VerificationError, match="2 stream verification"):
        raise VerificationError(d)
    with pytest.raises(AssertionError, match="sentinel"):
        d.raise_if_error()
