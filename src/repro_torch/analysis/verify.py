"""Encoder-independent verifier for Serpens streams and channel-shard plans.

``core.format.encode`` and its checker used to share helper code, so a bug
in the shared arithmetic was invisible.  This module re-derives every
invariant the hardware schedule and the kernels rely on *from first
principles* — its own packing/segment/lane arithmetic, no imports from the
encoder beyond the dataclass types it inspects — and reports findings as a
structured :class:`~repro_torch.analysis.diagnostics.Diagnostics` instead of
first-failure asserts.

Rules (id → what it proves):

================  ============================================================
``shape-static``  Array shapes/dtypes agree, tile count is chunk-aligned,
                  seg ids lie in ``[0, num_segments)``.
``seg-monotone``  ``seg_ids`` is non-decreasing (each x segment staged once).
``lane-capacity`` Live lane-local rows fit the shard's accumulator
                  (``< ceil(M_local / lanes)`` and the 16-bit row field).
``sentinel``      Padding slots carry value 0; at ``segment_width == 65536``
                  no live slot uses the reserved row 0xFFFF (would alias the
                  packed -1 null sentinel).
``col-range``     Live segment-local columns ``< segment_width`` and decoded
                  global columns ``< K_local``.
``raw-window``    No duplicate lane-local row within ``raw_window``
                  consecutive slots of one lane inside a segment run
                  (full mode only).
``nnz-account``   live slots + aux entries == declared nnz.
``spill-legal``   Aux arrays well-formed and in range; empty when spill is
                  disabled.
``spill-cap``     Hot-row / lane-balance spill caps respected: per
                  (segment, lane) bucket no row keeps more than
                  ``max(1, (kept + spilled) // raw_window)`` entries, and no
                  lane exceeds the lane-balance depth cap (full mode only).
``round-trip``    Decoded (row, col, value) multiset equals the source COO,
                  values quantized to the stream dtype (full mode, needs the
                  source triples).
``lane-ownership``  Per-(segment, lane) live counts of stream + aux match
                  the histogram the source triples imply under
                  ``row % lanes`` (needs the source triples).
``row-perm``      ``lane_assign="balanced"`` plans carry a valid injective
                  row permutation, block-local for row partitions; modulo
                  plans carry none.
``byte-account``  Value-stream dtype matches the config (8 B fp32 / 6 B bf16
                  slots), aux dtypes are int32/fp32, and ``stream_bytes``
                  equals the recomputed byte total.
``shard-coverage``  Plan geometry (block_m lane-aligned, block_k whole
                  segments) matches an independent re-derivation from the
                  spec, and every shard's local shape agrees.
``stack-consistent``  The plan's stacked arrays equal each shard's stream
                  plus legal tail padding (sentinel idx, zero val, repeated
                  last seg id).
================  ============================================================

``mode="fast"`` runs only the O(slots) single-pass structural rules (skips
``raw-window``, ``spill-cap`` and the source-comparison rules) — cheap
enough to gate every ``registry.put`` (see ``put(verify=...)``).

This is the PyTorch port's own copy of the reference verifier, rule for
rule, with the same rule ids and findings.  numpy has no bfloat16 and the
port carries no ``ml_dtypes``, so a bf16 value stream is its ``uint16``
bit patterns: ``byte-account`` expects ``uint16`` values under
``value_dtype="bfloat16"``, the value rules read the bits as fp32
(``bits << 16``, exact), and ``round-trip`` rounds the source values to
bf16 with this module's own round-to-nearest-even.  No rule is skipped for
a missing package.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.analysis.diagnostics import Diagnostics

# Re-derived packing constants (deliberately NOT imported from
# repro_torch.core.format: the point is an independent statement of the
# contract).  The same holds for the bf16 rounding in _quantize.
_SENTINEL = -1
_ROW_BITS = 16
_HALF_MASK = (1 << _ROW_BITS) - 1          # 0xFFFF

VERIFY_MODES = ("full", "fast", "off")

# Rules skipped in "fast" mode (multi-pass scans / sorts).
FULL_ONLY_RULES = ("raw-window", "spill-cap", "round-trip", "lane-ownership")

VERIFIER_RULES = (
    "shape-static", "seg-monotone", "lane-capacity", "sentinel",
    "col-range", "raw-window", "nnz-account", "spill-legal", "spill-cap",
    "round-trip", "lane-ownership", "row-perm", "byte-account",
    "shard-coverage", "stack-consistent",
)


class VerificationError(ValueError):
    """Raised by gates (``registry.put(verify=...)``) on error findings."""

    def __init__(self, diags: Diagnostics):
        self.diags = diags
        super().__init__(
            f"{len(diags.errors)} stream verification error(s):\n"
            + Diagnostics(diags.errors).format(limit=20))


def _seg_of(cols: np.ndarray, width: int) -> np.ndarray:
    return np.asarray(cols, np.int64) // int(width)


def _bf16_round(vals: np.ndarray) -> np.ndarray:
    """fp32 → the nearest bf16, ties to even, as fp32 (round-to-nearest-even
    on the bit pattern: add 0x7FFF plus the kept half's lowest bit, clear
    the low 16 bits; overflow rounds to ±inf).  NaN becomes the quiet NaN
    0x7FC0 with its sign kept, as ``ml_dtypes`` rounds it."""
    u = np.ascontiguousarray(vals, dtype=np.float32).view(np.uint32)
    r = (u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    nan = (u & np.uint32(0x7FFFFFFF)) > np.uint32(0x7F800000)
    r[nan] = (u[nan] & np.uint32(0x80000000)) | np.uint32(0x7FC00000)
    return r.view(np.float32)


def _quantize(vals: np.ndarray, value_dtype: str) -> np.ndarray:
    """Value as it survives the stream: rounded to the stream dtype, then
    widened back to fp32 bit patterns for comparison."""
    if value_dtype == "bfloat16":
        return _bf16_round(vals)
    return np.asarray(vals).astype(np.float32)


def _as_f32(val: np.ndarray, bf16_bits: bool) -> np.ndarray:
    """Stream values as fp32: bf16 bit patterns widen exactly by ``<< 16``."""
    if bf16_bits:
        return (val.astype(np.uint32) << 16).view(np.float32)
    return val.astype(np.float32)


def _first(mask_2d: np.ndarray, sublanes: int) -> Tuple[int, int, int]:
    """(tile, sublane, lane) of the first True in a [tiles*sub, lanes] mask."""
    f, lane = np.argwhere(mask_2d)[0]
    return int(f) // sublanes, int(f) % sublanes, int(lane)


def _value_dtype_for(value_dtype: str) -> Optional[np.dtype]:
    """The numpy dtype of a value stream: fp32, or ``uint16`` bf16 bits."""
    if value_dtype == "float32":
        return np.dtype(np.float32)
    if value_dtype == "bfloat16":
        return np.dtype(np.uint16)
    return None


def verify_matrix(sm, *, mode: str = "full",
                  source: Optional[Sequence[np.ndarray]] = None,
                  row_perm: Optional[np.ndarray] = None,
                  shard: Optional[int] = None,
                  diags: Optional[Diagnostics] = None) -> Diagnostics:
    """Verify one :class:`~repro_torch.core.format.SerpensMatrix`.

    ``source`` optionally supplies the *local-coordinate* COO triples
    ``(rows, cols, vals)`` the stream claims to encode, enabling the
    ``round-trip`` and ``lane-ownership`` rules.  ``row_perm`` optionally
    supplies the balanced-lane permutation the stream's (virtual) rows
    were encoded through, checked for range and injectivity.  ``shard``
    tags findings when called per shard of a plan.
    """
    d = diags if diags is not None else Diagnostics()
    if row_perm is not None:
        perm = np.asarray(row_perm, np.int64)
        span = -(-int(sm.shape[0]) // int(sm.config.lanes)) \
            * int(sm.config.lanes)
        if perm.ndim != 1:
            d.add("row-perm", f"row_perm must be 1-D, got shape "
                  f"{perm.shape}", shard=shard)
        elif perm.size and (perm.min() < 0 or perm.max() >= span):
            d.add("row-perm", f"row_perm values span [{int(perm.min())}, "
                  f"{int(perm.max())}] outside [0, {span})", shard=shard)
        elif np.unique(perm).size != perm.size:
            d.add("row-perm", "row_perm is not injective", shard=shard)
    if mode not in ("full", "fast"):
        raise ValueError(f"mode must be 'full' or 'fast', got {mode!r}")
    cfg = sm.config
    width, lanes = int(cfg.segment_width), int(cfg.lanes)
    sub, t_raw = int(cfg.sublanes), int(cfg.raw_window)
    m_local, k_local = int(sm.shape[0]), int(sm.shape[1])

    idx = np.asarray(sm.idx)
    val = np.asarray(sm.val)
    seg_ids = np.asarray(sm.seg_ids)

    # ---- shape-static: everything below indexes these arrays, so bail if
    # the basic geometry is off.
    structural_ok = True
    if idx.ndim != 3 or idx.shape[1:] != (sub, lanes):
        d.add("shape-static", f"idx shaped {idx.shape}, expected "
              f"[tiles, {sub}, {lanes}]", shard=shard)
        structural_ok = False
    if val.shape != idx.shape:
        d.add("shape-static", f"val shaped {val.shape} != idx {idx.shape}",
              shard=shard)
        structural_ok = False
    ntiles = int(idx.shape[0]) if idx.ndim == 3 else 0
    if seg_ids.shape != (ntiles,):
        d.add("shape-static", f"seg_ids shaped {seg_ids.shape}, expected "
              f"({ntiles},)", shard=shard)
        structural_ok = False
    if idx.dtype != np.int32:
        d.add("shape-static", f"idx dtype {idx.dtype}, expected int32",
              shard=shard)
    if ntiles % max(1, int(cfg.tiles_per_chunk)):
        d.add("shape-static", f"{ntiles} tiles not a multiple of "
              f"tiles_per_chunk={cfg.tiles_per_chunk}", shard=shard)
    if not structural_ok:
        return d
    if seg_ids.size:
        lo, hi = int(seg_ids.min()), int(seg_ids.max())
        if lo < 0 or hi >= int(sm.num_segments):
            d.add("shape-static", f"seg ids span [{lo}, {hi}] outside "
                  f"[0, {sm.num_segments})", shard=shard,
                  slot=int(np.argmax(seg_ids == (lo if lo < 0 else hi))))

    # ---- seg-monotone
    if seg_ids.size > 1:
        drops = np.flatnonzero(np.diff(seg_ids.astype(np.int64)) < 0)
        if drops.size:
            t = int(drops[0])
            d.add("seg-monotone",
                  f"seg_ids decreases at tile {t} "
                  f"({int(seg_ids[t])} -> {int(seg_ids[t + 1])})"
                  + (f" (+{drops.size - 1} more)" if drops.size > 1 else ""),
                  shard=shard, slot=t)

    # Stay in int32: the packed word, its two halves and every fast-mode
    # comparison fit, and the fast path is budgeted against the encode
    # (benchmarks/verify_overhead.py) — int64 upcasts double its traffic.
    flat = idx.reshape(-1, lanes)
    live = flat != _SENTINEL
    rr = (flat >> _ROW_BITS) & np.int32(_HALF_MASK)
    cc = flat & np.int32(_HALF_MASK)
    seg_flat = (np.repeat(seg_ids.astype(np.int64), sub)
                if seg_ids.size else np.zeros(0, np.int64))

    def _flag(rule: str, mask: np.ndarray, what: str) -> None:
        n = int(np.count_nonzero(mask))
        if n:
            t, s, lane = _first(mask, sub)
            d.add(rule, f"{what} at tile {t} sublane {s} lane {lane}"
                  + (f" (+{n - 1} more)" if n > 1 else ""),
                  shard=shard, slot=t, lane=lane)

    # ---- lane-capacity: decoded lane-local row must address a real
    # accumulator slot of this shard.
    cap = -(-m_local // lanes)
    _flag("lane-capacity", live & (rr >= cap),
          f"lane-local row >= ceil(M_local/lanes)={cap}")

    # ---- sentinel
    if width >= 1 << _ROW_BITS:
        _flag("sentinel", live & (rr == _HALF_MASK),
              "live slot uses row 0xFFFF, reserved for the null sentinel "
              "at segment_width=65536")
    vflat = val.reshape(-1, lanes)
    bits = val.dtype == np.uint16 and cfg.value_dtype == "bfloat16"
    # A bf16 value is zero when its bits are 0x0000 or 0x8000 (-0.0).
    nonzero = (vflat & np.uint16(0x7FFF)) != 0 if bits else vflat != 0
    _flag("sentinel", (~live) & nonzero,
          "padding slot carries a non-zero value")

    # ---- col-range
    _flag("col-range", live & (cc >= width),
          f"segment-local col >= segment_width={width}")
    if seg_flat.size:
        # cc >= k_local - seg*width  <=>  decoded col >= K_local, but the
        # threshold is per tile-row (tiny) so no [slots] int64 temp.
        thr = np.clip(k_local - seg_flat * width,
                      -(1 << 31), (1 << 31) - 1).astype(np.int32)
        _flag("col-range", live & (cc >= thr[:, None]),
              f"decoded col >= K_local={k_local}")

    # ---- nnz-account
    kept = int(np.count_nonzero(live))
    n_aux = int(sm.n_aux)
    if kept + n_aux != int(sm.nnz):
        d.add("nnz-account",
              f"{kept} live slots + {n_aux} aux entries != nnz={sm.nnz}",
              shard=shard)

    # ---- spill-legal
    aux_r = np.asarray(sm.aux_rows)
    aux_c = np.asarray(sm.aux_cols)
    aux_v = np.asarray(sm.aux_vals)
    spill_enabled = bool(cfg.spill_hot_rows) or cfg.lane_balance > 0
    if not (aux_r.shape == aux_c.shape == aux_v.shape) or aux_r.ndim != 1:
        d.add("spill-legal", "aux rows/cols/vals shapes disagree "
              f"({aux_r.shape}/{aux_c.shape}/{aux_v.shape})", shard=shard)
        aux_r = aux_c = np.zeros(0, np.int64)
        aux_v = np.zeros(0, np.float32)
    elif n_aux:
        if not spill_enabled:
            d.add("spill-legal", f"{n_aux} aux entries but spill is "
                  "disabled in the config", shard=shard)
        bad_r = (aux_r < 0) | (aux_r >= m_local)
        bad_c = (aux_c < 0) | (aux_c >= k_local)
        if bad_r.any():
            i = int(np.argmax(bad_r))
            d.add("spill-legal", f"aux row {int(aux_r[i])} outside "
                  f"[0, {m_local}) at aux[{i}]", shard=shard, slot=i)
        if bad_c.any():
            i = int(np.argmax(bad_c))
            d.add("spill-legal", f"aux col {int(aux_c[i])} outside "
                  f"[0, {k_local}) at aux[{i}]", shard=shard, slot=i)

    # ---- byte-account
    want_dtype = _value_dtype_for(cfg.value_dtype)
    if want_dtype is not None and val.dtype != want_dtype:
        d.add("byte-account", f"val dtype {val.dtype} != config "
              f"value_dtype {cfg.value_dtype}", shard=shard)
    if n_aux and aux_v.dtype != np.float32:
        d.add("byte-account", f"aux_vals dtype {aux_v.dtype}, expected "
              "float32 (aux side-stream is always fp32)", shard=shard)
    vb = 4 if cfg.value_dtype == "float32" else 2
    expect_bytes = int(idx.size) * (4 + vb) + 12 * n_aux
    if int(sm.stream_bytes) != expect_bytes:
        d.add("byte-account", f"stream_bytes={sm.stream_bytes} != "
              f"recomputed {expect_bytes} "
              f"({4 + vb} B/slot x {idx.size} + 12 B x {n_aux})",
              shard=shard)

    if mode == "fast":
        return d

    # ---- raw-window (full): shifted whole-array comparison per offset,
    # masked to same-segment runs — the hazard the accumulate pipeline has.
    nrows = flat.shape[0]
    for off in range(1, min(t_raw, nrows)):
        clash = (live[:-off] & live[off:]
                 & (rr[:-off] == rr[off:])
                 & (seg_flat[:-off] == seg_flat[off:])[:, None])
        n = int(np.count_nonzero(clash))
        if n:
            f, lane = np.argwhere(clash)[0]
            d.add("raw-window",
                  f"lane {int(lane)} repeats lane-local row "
                  f"{int(rr[f, lane])} within {off} < raw_window={t_raw} "
                  f"slots (tile {int(f) // sub})"
                  + (f" (+{n - 1} more)" if n > 1 else ""),
                  shard=shard, slot=int(f) // sub, lane=int(lane))

    # ---- spill-cap (full): sound upper bounds — the encoder's caps use the
    # pre-spill population, which from the stream alone is (kept + spilled).
    if spill_enabled and seg_flat.size:
        lane_ix = np.broadcast_to(np.arange(lanes), flat.shape)
        k_seg = np.broadcast_to(seg_flat[:, None], flat.shape)[live]
        k_lane = lane_ix[live]
        k_row = rr[live]
        a_seg = _seg_of(aux_c, width) if aux_r.size else np.zeros(0, np.int64)
        a_lane = (np.asarray(aux_r, np.int64) % lanes if aux_r.size
                  else np.zeros(0, np.int64))
        nseg = max(int(sm.num_segments), 1)
        kb = k_seg * lanes + k_lane                     # kept bucket ids
        ab = a_seg * lanes + a_lane
        nb = int(max(nseg * lanes,
                     kb.max() + 1 if kb.size else 0,
                     ab.max() + 1 if ab.size else 0))
        pop = (np.bincount(kb, minlength=nb)
               + np.bincount(ab, minlength=nb))
        if cfg.spill_hot_rows and k_row.size:
            cap2 = np.maximum(1, pop // t_raw)
            rkey = kb * np.int64(-(-m_local // lanes) + 1) + k_row
            uniq, counts = np.unique(rkey, return_counts=True)
            over = counts > cap2[(uniq // np.int64(-(-m_local // lanes) + 1))]
            if over.any():
                i = int(np.argmax(over))
                b = int(uniq[i] // np.int64(-(-m_local // lanes) + 1))
                d.add("spill-cap",
                      f"row {int(uniq[i] % np.int64(-(-m_local // lanes) + 1))}"
                      f" keeps {int(counts[i])} entries in bucket "
                      f"(seg {b // lanes}, lane {b % lanes}) > hot-row cap "
                      f"{int(cap2[b])}", shard=shard, lane=b % lanes)
        if cfg.lane_balance > 0 and nb == nseg * lanes:
            seg_pop = pop.reshape(nseg, lanes).sum(axis=1)
            lane_cap = np.ceil(cfg.lane_balance
                               * np.maximum(1, seg_pop // lanes))
            kept_depth = np.bincount(kb, minlength=nseg * lanes
                                     ).reshape(nseg, lanes)
            over = kept_depth > lane_cap[:, None]
            if over.any():
                s, lane = map(int, np.argwhere(over)[0])
                d.add("spill-cap",
                      f"lane {lane} keeps {int(kept_depth[s, lane])} slots "
                      f"in segment {s} > lane-balance cap "
                      f"{int(lane_cap[s])}", shard=shard, lane=lane)

    if source is None:
        return d

    # ---- source-comparison rules -------------------------------------
    src_r = np.asarray(source[0], np.int64)
    src_c = np.asarray(source[1], np.int64)
    src_v = np.asarray(source[2], np.float32)

    # Independent decode of the stream (local coordinates).
    lane_ix = np.broadcast_to(np.arange(lanes), flat.shape)
    dec_r = (rr.astype(np.int64) * lanes + lane_ix)[live]
    dec_c = (seg_flat[:, None] * width + cc)[live] if seg_flat.size else \
        np.zeros(0, np.int64)
    dec_v = _as_f32(vflat[live], bits)
    dec_lane = lane_ix[live]
    if aux_r.size:
        dec_r = np.concatenate([dec_r, np.asarray(aux_r, np.int64)])
        dec_c = np.concatenate([dec_c, np.asarray(aux_c, np.int64)])
        dec_v = np.concatenate([dec_v, np.asarray(aux_v, np.float32)])
        dec_lane = np.concatenate([dec_lane,
                                   np.asarray(aux_r, np.int64) % lanes])

    # lane-ownership: the per-(segment, lane) population must match what
    # row % lanes implies for the source — catches wrong-lane placement
    # with a sharper location than round-trip.
    nseg = max(int(sm.num_segments), 1)
    hb = _seg_of(dec_c, width) * lanes + dec_lane
    src_lane = src_r % lanes
    src_seg = _seg_of(src_c, width)
    if src_seg.size and int(src_seg.max()) < nseg:
        wb = src_seg * lanes + src_lane
        nb = int(max(nseg * lanes, hb.max() + 1 if hb.size else 0,
                     wb.max() + 1 if wb.size else 0))
        have = np.bincount(hb, minlength=nb)
        want = np.bincount(wb, minlength=nb)
        diff = np.flatnonzero(have != want)
        if diff.size:
            b = int(diff[0])
            d.add("lane-ownership",
                  f"(segment {b // lanes}, lane {b % lanes}) holds "
                  f"{int(have[b])} entries, source implies {int(want[b])}"
                  + (f" (+{diff.size - 1} more buckets)"
                     if diff.size > 1 else ""),
                  shard=shard, lane=b % lanes)

    # round-trip: exact multiset equality on (row, col, value) with values
    # quantized to the stream dtype on both sides (the one rounding the
    # format is allowed; aux entries stay fp32 but quantizing both sides
    # makes the comparison well-defined under duplicates).
    if dec_r.size != src_r.size:
        d.add("round-trip", f"stream decodes {dec_r.size} entries, source "
              f"has {src_r.size}", shard=shard)
    else:
        def _key(r, c, v):
            arr = np.stack([r, c,
                            _quantize(v, cfg.value_dtype).view(np.int32)
                            .astype(np.int64)])
            return arr[:, np.lexsort(arr[::-1])]

        a = _key(dec_r, dec_c, dec_v)
        b = _key(src_r, src_c, src_v)
        neq = np.flatnonzero((a != b).any(axis=0))
        if neq.size:
            i = int(neq[0])
            d.add("round-trip",
                  f"decoded multiset diverges from source at sorted rank "
                  f"{i}: stream (r={a[0, i]}, c={a[1, i]}) vs source "
                  f"(r={b[0, i]}, c={b[1, i]}) "
                  f"({neq.size} rank(s) differ)", shard=shard)
    return d


def _expected_geometry(shape, cfg, spec) -> Tuple[int, int]:
    """Independent restatement of the plan-geometry contract: row blocks
    lane-aligned so accumulators concatenate; col blocks whole segments so
    packed words survive the split."""
    m, k = int(shape[0]), int(shape[1])
    if spec.partition == "row":
        bm = -(-(-(-m // spec.num_shards)) // cfg.lanes) * cfg.lanes
        return bm, k
    if spec.partition == "col":
        segs = max(1, -(-k // cfg.segment_width))
        return m, -(-segs // spec.num_shards) * cfg.segment_width
    return m, k


def verify_plan(plan, rows=None, cols=None, vals=None, *,
                mode: str = "full") -> Diagnostics:
    """Verify a :class:`~repro_torch.core.partition.ChannelShardPlan`.

    Checks plan-level geometry (``shard-coverage``), the balanced-lane
    permutation (``row-perm``), stacked-array/shard agreement
    (``stack-consistent``), and every shard stream via
    :func:`verify_matrix`.  Pass the global source triples to enable the
    ``round-trip`` / ``lane-ownership`` rules per shard.
    """
    d = Diagnostics()
    if mode == "off":
        return d
    cfg, spec = plan.config, plan.spec
    lanes = int(cfg.lanes)
    m, k = int(plan.shape[0]), int(plan.shape[1])
    n = plan.num_shards

    # ---- shard-coverage: geometry re-derived from the spec.
    want_bm, want_bk = _expected_geometry((m, k), cfg, spec)
    if spec.partition == "row" and int(plan.block_m) != want_bm:
        d.add("shard-coverage", f"block_m={plan.block_m} != lane-aligned "
              f"ceil(M/num_shards)={want_bm}")
    if spec.partition == "col" and int(plan.block_k) != want_bk:
        d.add("shard-coverage", f"block_k={plan.block_k} != segment-aligned "
              f"ceil-split of K={want_bk}")
    if n != int(spec.num_shards):
        d.add("shard-coverage",
              f"plan has {n} shards, spec says {spec.num_shards}")
    for s_i, sm in enumerate(plan.shards):
        want_shape = ((int(plan.block_m), k) if spec.partition == "row"
                      else (int(sm.shape[0]), int(plan.block_k))
                      if spec.partition == "col" else sm.shape)
        if tuple(sm.shape) != tuple(want_shape):
            d.add("shard-coverage", f"shard shape {tuple(sm.shape)} != "
                  f"expected {tuple(want_shape)}", shard=s_i)
        if int(sm.num_segments) != int(plan.num_segments_local):
            d.add("shard-coverage", f"shard has {sm.num_segments} segments, "
                  f"plan says {plan.num_segments_local}", shard=s_i)

    # ---- row-perm
    perm = plan.row_perm
    if spec.lane_assign == "balanced":
        if perm is None:
            d.add("row-perm", "balanced plan carries no row_perm")
    elif perm is not None:
        d.add("row-perm", "modulo plan carries a row_perm (executor would "
              "gather through a permutation the stream was not encoded in)")
    if perm is not None:
        perm = np.asarray(perm, np.int64)
        span = int(plan.virtual_rows)
        if perm.shape != (m,):
            d.add("row-perm", f"row_perm shaped {perm.shape}, expected "
                  f"({m},)")
        else:
            if perm.size and (perm.min() < 0 or perm.max() >= span):
                d.add("row-perm", f"row_perm values span "
                      f"[{int(perm.min())}, {int(perm.max())}] outside "
                      f"[0, {span})")
            elif np.unique(perm).size != perm.size:
                dup = np.bincount(perm, minlength=span)
                v = int(np.argmax(dup > 1))
                d.add("row-perm", f"row_perm is not injective (virtual row "
                      f"{v} assigned {int(dup[v])} times)")
            elif spec.partition == "row" and int(plan.block_m) > 0:
                blk = np.arange(m, dtype=np.int64) // int(plan.block_m)
                off = np.flatnonzero(perm // int(plan.block_m) != blk)
                if off.size:
                    r = int(off[0])
                    d.add("row-perm", f"row {r} permuted across shard "
                          f"blocks (virtual {int(perm[r])}, block_m="
                          f"{plan.block_m})", shard=int(blk[r]))

    # ---- stack-consistent
    val_bits = (np.asarray(plan.val).dtype == np.uint16
                and cfg.value_dtype == "bfloat16")
    if plan.idx.shape[:1] != (n,) or plan.idx.shape[0] != len(plan.shards):
        d.add("stack-consistent", f"stacked idx leading dim "
              f"{plan.idx.shape[0]} != {n} shards")
    else:
        for s_i, sm in enumerate(plan.shards):
            tk = int(sm.num_tiles)
            if plan.idx.shape[1] < tk or plan.idx[s_i].shape[1:] != \
                    sm.idx.shape[1:]:
                d.add("stack-consistent", f"stacked idx {plan.idx[s_i].shape}"
                      f" cannot hold shard stream {sm.idx.shape}",
                      shard=s_i)
                continue
            if not (np.array_equal(plan.idx[s_i, :tk], sm.idx)
                    and np.array_equal(plan.seg_ids[s_i, :tk], sm.seg_ids)
                    and np.array_equal(
                        np.asarray(plan.val[s_i, :tk]).view(np.uint8),
                        np.asarray(sm.val).view(np.uint8))):
                d.add("stack-consistent", "stacked stream differs from the "
                      "shard's own arrays", shard=s_i)
            tail = plan.idx[s_i, tk:]
            if tail.size and not ((tail == _SENTINEL).all() and
                                  np.all(_as_f32(plan.val[s_i, tk:],
                                                 val_bits) == 0.0)):
                d.add("stack-consistent", "stack tail padding is not "
                      "(sentinel idx, zero val)", shard=s_i,
                      slot=tk)
            seg_tail = plan.seg_ids[s_i, tk:]
            if seg_tail.size and sm.seg_ids.size and not np.all(
                    seg_tail == sm.seg_ids[-1]):
                d.add("stack-consistent", "stack tail seg ids != shard's "
                      "last seg id", shard=s_i, slot=tk)
            na = int(sm.n_aux)
            if plan.aux_rows.shape[1] < na or not (
                    np.array_equal(plan.aux_rows[s_i, :na], sm.aux_rows)
                    and np.array_equal(plan.aux_cols[s_i, :na], sm.aux_cols)
                    and np.array_equal(plan.aux_vals[s_i, :na], sm.aux_vals)
                    and np.all(plan.aux_vals[s_i, na:] == 0.0)):
                d.add("stack-consistent", "stacked aux stream differs from "
                      "the shard's (or tail not zero-padded)", shard=s_i)

    # ---- byte-account at plan level
    vb = 4 if cfg.value_dtype == "float32" else 2
    expect = int(plan.idx.size) * (4 + vb) + 12 * int(plan.n_aux)
    if int(plan.stream_bytes) != expect:
        d.add("byte-account", f"plan stream_bytes={plan.stream_bytes} != "
              f"recomputed {expect}")

    # ---- decompose the source per shard (ownership is part of the spec).
    per_shard_src = [None] * n
    if rows is not None:
        src_r = np.asarray(rows, np.int64)
        src_c = np.asarray(cols, np.int64)
        src_v = np.asarray(vals, np.float32)
        vrows = src_r if perm is None or perm.shape != (m,) else perm[src_r]
        if int(src_r.size) != int(plan.nnz):
            d.add("nnz-account", f"plan nnz={plan.nnz} != source "
                  f"{src_r.size} entries")
        if spec.partition == "row":
            own = vrows // max(int(plan.block_m), 1)
            lr, lc = vrows - own * int(plan.block_m), src_c
        elif spec.partition == "col":
            own = src_c // max(int(plan.block_k), 1)
            lr, lc = vrows, src_c - own * int(plan.block_k)
        else:
            own = np.zeros(src_r.shape, np.int64)
            lr, lc = vrows, src_c
        bad = np.flatnonzero((own < 0) | (own >= n))
        if bad.size:
            i = int(bad[0])
            d.add("shard-coverage", f"source entry {i} (row {src_r[i]}, "
                  f"col {src_c[i]}) maps to shard {int(own[i])} outside "
                  f"[0, {n})")
        else:
            for s_i in range(n):
                sel = own == s_i
                per_shard_src[s_i] = (lr[sel], lc[sel], src_v[sel])

    for s_i, sm in enumerate(plan.shards):
        verify_matrix(sm, mode=mode, source=per_shard_src[s_i],
                      shard=s_i, diags=d)
    return d
