"""Serpens sparse-matrix preprocessing — the paper's accelerator-efficient format.

The paper (Sec. 3.2-3.4) preprocesses a COO matrix into a stream of fixed-width
channel words so that *all* off-chip access is sequential and *all* random access
(x-gather, y-accumulate) is confined to on-chip memory:

  1. **Segment partition**: columns are split into segments of ``W`` (paper:
     W = 8192); the x-segment is staged on chip while its non-zeros stream past.
  2. **PE row interleave**: row ``r`` belongs to PE ``r mod NUM_PE`` so
     accumulator banks are disjoint.  TPU adaptation: *lane-stationary rows* —
     row ``r`` is owned by VPU lane ``r mod LANES`` and its on-chip accumulator
     address is ``r // LANES``.
  3. **Index coalescing**: indices are segment-/lane-local, so a (row, col)
     pair packs into one 32-bit word → 8 B per non-zero (fp32 value + index),
     exactly the paper's 64-bit channel element.
  4. **Non-zero reordering ("coloring")**: the accumulator has a ``T``-slot
     read-after-write hazard window.  Within each lane, non-zeros are reordered
     so no two elements with the same destination row appear within ``T``
     consecutive slots; null elements (sentinel index) pad the gaps.  This is
     the paper's Fig. 2 (d) generalized to the (SUBLANES, LANES) VPU tile.

The output is a :class:`SerpensMatrix`: three dense arrays —
``idx[T, 8, 128]`` (int32, packed), ``val[T, 8, 128]`` (fp32, or bf16 bit
patterns as ``uint16``) and ``seg_ids[T]`` (int32: which x-segment each tile
needs).  Tiles are sorted by segment.

This module is the PyTorch port's own numpy copy of the reference encoder.
It produces byte-identical ``idx``/``seg_ids``/aux arrays, and its bf16
value bits equal those ``ml_dtypes`` gives, so both packages run the same
stream.

Two encoders produce that stream:

* :func:`encode` — the production pipeline.  Fully vectorized: one global
  counting sort buckets non-zeros by (segment, lane), and the RAW-window
  reordering uses the *closed form* of the most-frequent-first cooldown
  schedule (see :func:`_encode_stream`) instead of a per-element Python
  heap, so a whole matrix encodes in a handful of numpy passes.
* :func:`encode_reference` — the original per-lane greedy heapq scheduler,
  kept as the executable specification.  ``encode`` must round-trip to the
  same COO multiset, satisfy :func:`check_invariants`, and pad no worse;
  ``tests/test_format_properties.py`` property-tests that equivalence.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np

SENTINEL = np.int32(-1)  # null element (paper: padded null non-zeros)
ROW_BITS = 16
COL_MASK = (1 << ROW_BITS) - 1

# Value-stream precisions.  The packed slot is the int32 index word plus one
# value: fp32 values give the paper's 8 B slot; bf16 values cut it to 6 B
# (~25-30% stream-byte reduction at equal nnz), with all *accumulation*
# staying fp32 in the kernels (values are rounded exactly once, at stream
# materialization).  The aux spill side-stream always stays fp32 COO
# (12 B/entry) — it is tiny and hot by construction.
VALUE_DTYPES = ("float32", "bfloat16")


def value_np_dtype(value_dtype: str) -> np.dtype:
    """The numpy dtype of a value stream.

    numpy has no bfloat16, so a bf16 stream is held as its ``uint16`` bit
    patterns (:func:`bf16_bits`); it becomes ``torch.bfloat16`` by a
    ``.view`` at device transfer.  No ``ml_dtypes`` is needed.
    """
    if value_dtype == "float32":
        return np.dtype(np.float32)
    if value_dtype == "bfloat16":
        return np.dtype(np.uint16)
    raise ValueError(
        f"value_dtype must be one of {VALUE_DTYPES}, got {value_dtype!r}")


def bf16_bits(a) -> np.ndarray:
    """fp32 → bf16 bit patterns (``uint16``), round-to-nearest-even.

    The same rounding ``ml_dtypes.bfloat16`` applies: add ``0x7FFF`` plus
    the kept half's lowest bit, then drop the low 16 bits (overflow rounds
    to ±inf).  NaN maps to the quiet NaN ``0x7FC0`` with its sign kept.
    """
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    rounded = ((u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1)))
               >> 16).astype(np.uint16)
    nan = np.isnan(u.view(np.float32))
    if nan.any():
        rounded[nan] = ((u[nan] >> 16) & np.uint32(0x8000)) | 0x7FC0
    return rounded


def stream_values(vals, dtype: np.dtype) -> np.ndarray:
    """fp32 values in a value stream's numpy dtype (rounded once)."""
    if dtype == np.uint16:
        return bf16_bits(vals)
    return np.asarray(vals, dtype=np.float32)


def values_f32(val: np.ndarray) -> np.ndarray:
    """A value stream (fp32, or bf16 bit patterns) as fp32 — exact."""
    if val.dtype == np.uint16:
        return (val.astype(np.uint32) << 16).view(np.float32)
    return val.astype(np.float32)


def value_nbytes(value_dtype: str) -> int:
    """Bytes per stream value (4 for fp32, 2 for bf16)."""
    return 4 if value_dtype == "float32" else 2


@dataclasses.dataclass(frozen=True)
class SerpensConfig:
    """Geometry of the Serpens stream.

    Attributes:
      segment_width: W — columns per x segment (paper default 8192). Must be
        ≤ 65536 so a column offset fits in 16 bits.
      lanes: number of accumulator banks (FPGA: #PEs; TPU: VPU lanes). Row
        ``r`` is owned by lane ``r % lanes``.
      sublanes: slots per lane per tile (TPU: VPU sublanes = 8).
      raw_window: T — no duplicate destination row within any T consecutive
        slots of one lane (paper: T = DSP accumulate latency = 2; the TPU
        tile-conflict-freedom requirement is T = sublanes).
      tiles_per_chunk: how many (sublanes × lanes) tiles form one grid step of
        the kernel (larger ⇒ fewer grid steps, more per-segment padding).
      value_dtype: precision of the packed value stream — ``"float32"``
        (the paper's 8 B slot) or ``"bfloat16"`` (6 B slot, fp32
        accumulation in the kernels; see :data:`VALUE_DTYPES`).
    """

    segment_width: int = 8192
    lanes: int = 128
    sublanes: int = 8
    raw_window: int = 8
    tiles_per_chunk: int = 1
    value_dtype: str = "float32"
    # Beyond-paper (§Perf C3): cap any row's entries per (segment, lane) at
    # ~n_lane/raw_window and divert the excess to a small auxiliary COO
    # that the epilogue scatter-adds.  Kills the hot-row padding blowup on
    # power-law graphs (the paper's own G1/G7 weak spot).
    spill_hot_rows: bool = False
    # Beyond-paper (§Perf C4): additionally cap each lane's depth at
    # ``lane_balance`` × the segment's mean lane depth, spilling overflow —
    # bounds padding from cross-lane imbalance.  0 disables.
    lane_balance: float = 0.0

    def __post_init__(self):
        if not (0 < self.segment_width <= 1 << 16):
            raise ValueError("segment_width must be in (0, 65536]")
        if self.lanes < 1:
            raise ValueError("lanes must be >= 1")
        if self.sublanes < 1:
            raise ValueError("sublanes must be >= 1")
        if self.raw_window < 1:
            raise ValueError("raw_window must be >= 1")
        if self.tiles_per_chunk < 1:
            raise ValueError("tiles_per_chunk must be >= 1")
        if self.lane_balance < 0:
            raise ValueError("lane_balance must be >= 0")
        if self.value_dtype not in VALUE_DTYPES:
            raise ValueError(
                f"value_dtype must be one of {VALUE_DTYPES}, "
                f"got {self.value_dtype!r}")

    @property
    def np_value_dtype(self) -> np.dtype:
        """Numpy dtype of the value stream arrays."""
        return value_np_dtype(self.value_dtype)

    @property
    def value_bytes(self) -> int:
        """Bytes per stream value (4 for fp32, 2 for bf16)."""
        return value_nbytes(self.value_dtype)


# Paper-faithful geometry (Sec. 3.2-3.4): W=8192, RAW window = one tile.
PAPER_CONFIG = SerpensConfig()
# Beyond-paper preset (§Perf C1-C4): relaxed RAW window (TPU scatter has no
# 8-deep hazard), hot-row spill, lane-depth balancing at 1.1× mean.
OPTIMIZED_CONFIG = SerpensConfig(raw_window=2, spill_hot_rows=True,
                                 lane_balance=1.1)


def seg_of(cols, segment_width: int):
    """Segment id of each column (shift when the width is a power of 2).

    The one definition of the stream's column→segment map — shared by
    ``prepare``/``_key_arrays``/``_encode_stream`` here and the parallel
    encode front-end (:mod:`repro_torch.core.parallel_encode`), whose sort keys
    must stay bit-identical to the serial ones.
    """
    w = segment_width
    return cols >> w.bit_length() - 1 if not w & (w - 1) else cols // w


def lane_split(rows, lanes: int):
    """(lane, lane-local row) of each row — the row→accumulator map."""
    if not lanes & (lanes - 1):
        return rows & (lanes - 1), rows >> lanes.bit_length() - 1
    return rows % lanes, rows // lanes


def _member_of_sorted(sorted_ids: np.ndarray, keys: np.ndarray,
                      id_space: int) -> np.ndarray:
    """Per-key membership in a sorted id array.

    One boolean-LUT gather when the id space is small enough to
    materialize, else a clamped binary search — the shared idiom of the
    delta-merge paths (`merge_delta`, ``partition.plan_apply_delta``).
    """
    if 0 < id_space < 1 << 22:
        lut = np.zeros(id_space, np.bool_)
        lut[sorted_ids] = True
        return lut[keys]
    ids = sorted_ids.astype(keys.dtype, copy=False)
    pos = np.minimum(np.searchsorted(ids, keys), ids.size - 1)
    return ids[pos] == keys


def _empty_i32() -> np.ndarray:
    return np.zeros((0,), np.int32)


def _empty_f32() -> np.ndarray:
    return np.zeros((0,), np.float32)


@dataclasses.dataclass
class SerpensMatrix:
    """A sparse matrix in the Serpens stream format (host-side container)."""

    shape: tuple[int, int]  # (M, K)
    nnz: int
    config: SerpensConfig
    # Stream arrays (numpy on host; moved to device by kernels/ops.py):
    idx: np.ndarray  # int32 [num_tiles, sublanes, lanes]: (row_local<<16)|col_local
    val: np.ndarray  # config.np_value_dtype [num_tiles, sublanes, lanes]
    seg_ids: np.ndarray  # int32 [num_tiles] — x segment id per tile (ascending)
    num_segments: int
    # Hot-row spill side-stream (empty unless config.spill_hot_rows):
    aux_rows: np.ndarray = dataclasses.field(default_factory=_empty_i32)
    aux_cols: np.ndarray = dataclasses.field(default_factory=_empty_i32)
    aux_vals: np.ndarray = dataclasses.field(default_factory=_empty_f32)

    @property
    def num_tiles(self) -> int:
        return self.idx.shape[0]

    @property
    def padded_rows(self) -> int:
        m = self.shape[0]
        return -(-m // self.config.lanes) * self.config.lanes

    @property
    def padded_cols(self) -> int:
        return self.num_segments * self.config.segment_width

    @property
    def n_aux(self) -> int:
        return 0 if self.aux_rows is None else int(self.aux_rows.size)

    @property
    def stream_bytes(self) -> int:
        """Off-chip bytes for one pass over A: 4 B index + one value per
        stream slot (incl. padding) — 8 B/slot at fp32, 6 B/slot at bf16 —
        + 12 B per spilled aux entry (fp32 COO row/col/val)."""
        per_slot = 4 + self.config.value_bytes
        return int(self.idx.size) * per_slot + 12 * self.n_aux

    @property
    def padding_ratio(self) -> float:
        """Fraction of stream slots that are null padding."""
        total = self.idx.size
        kept = self.nnz - self.n_aux
        return float(total - kept) / max(total, 1)


def _validate_coo(rows, cols, vals, shape, cfg: SerpensConfig):
    """Canonicalize + range-check COO triples (shared by both encoders)."""
    m, k = shape
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float32)
    if rows.shape != cols.shape or rows.shape != vals.shape:
        raise ValueError("rows/cols/vals must have identical shapes")
    if rows.size and (rows.min() < 0 or rows.max() >= m):
        raise ValueError("row index out of range")
    if cols.size and (cols.min() < 0 or cols.max() >= k):
        raise ValueError("col index out of range")
    return rows, cols, vals


def row_capacity(cfg: SerpensConfig) -> int:
    """Max lane-local rows one encoded stream can address.

    The packed stream word is ``(lane-local row << 16) | segment-local
    col`` and the int32 padding sentinel is ``-1`` = ``(0xFFFF << 16) |
    0xFFFF``.  A live element can only alias it when *both* halves
    saturate, so lane-local row 0xFFFF is legal whenever
    ``segment_width < 65536`` (the column half then never reaches
    0xFFFF); only at the full 65536-wide segment must row 0xFFFF be
    reserved for the sentinel.
    """
    if cfg.segment_width < 1 << ROW_BITS:
        return 1 << ROW_BITS
    return (1 << ROW_BITS) - 1


def _check_row_capacity(m: int, cfg: SerpensConfig) -> None:
    """The lane-local row index of one encoded stream must fit in ROW_BITS
    bits without a live element aliasing the SENTINEL packed word (see
    :func:`row_capacity`).  Checked per encoded *shard* shape: a
    row-partitioned plan of a taller matrix is fine as long as each block
    fits.
    """
    row_cap = row_capacity(cfg)
    if -(-m // cfg.lanes) > row_cap:
        reserved = ("; lane-local row 0xFFFF is reserved for the null "
                    "sentinel at segment_width=65536"
                    if cfg.segment_width >= 1 << ROW_BITS else "")
        raise ValueError(
            f"M={m} exceeds Serpens row capacity {cfg.lanes * row_cap} "
            f"(lane-local row index must fit in {ROW_BITS} bits"
            f"{reserved}; row-partition into smaller blocks to go taller)")


@dataclasses.dataclass
class PreparedCOO:
    """Validated triples plus the one global bucket sort.

    ``order`` lists entries by (segment, lane, lane-local row) with ties in
    input order.  The sort is the only super-linear step of the encode
    pipeline and it is geometry-reusable: ``partition.make_plan`` derives
    every channel-shard order from it (col/single partitions: as-is; row
    partition: one stable pass over the shard key — the lane and the
    *relative* lane-local row order are invariant under lane-aligned row
    offsets), and ``MatrixRegistry`` keeps it per entry so repartitioning a
    cached matrix to a new mesh never re-validates or re-sorts from scratch.
    """

    shape: tuple[int, int]
    config: SerpensConfig
    rows: np.ndarray   # int64, validated
    cols: np.ndarray   # int64, validated
    vals: np.ndarray   # float32
    order: np.ndarray  # stable argsort by (segment, lane, lane-local row)
    # Precomputed per-entry bucket key and packed stream word (int32 when
    # the geometry fits).  Reused verbatim by single- and col-partition
    # encodes (lane, lane-local row and segment-local col are invariant
    # there); row partitions rebuild them shard-locally.
    bucket_key: np.ndarray | None = None
    packed: np.ndarray | None = None
    # Lazily-computed structural features (repro_torch.core.features
    # .MatrixFeatures) — the auto-tuner's input.  Cached here so
    # repartitions of the same matrix never recount; merge_delta builds a
    # fresh PreparedCOO, so a delta naturally invalidates the cache.
    features: object = None

    @property
    def nnz(self) -> int:
        return int(self.rows.size)

    @property
    def nbytes(self) -> int:
        """Host bytes held by the resident prepared arrays (triples + sort
        + cached bucket/packed words) — what the registry's byte budget
        charges for keeping an entry repartitionable/updatable."""
        total = (self.rows.nbytes + self.cols.nbytes + self.vals.nbytes
                 + self.order.nbytes)
        if self.bucket_key is not None:
            total += self.bucket_key.nbytes
        if self.packed is not None:
            total += self.packed.nbytes
        return int(total)

    def merge_delta(self, rows, cols, vals=None, *,
                    mode: str = "add") -> "DeltaMerge":
        """Merge a (small) COO delta into the cached bucket sort.

        Returns a :class:`DeltaMerge` whose ``prepared`` is bit-identical
        to ``prepare()`` run cold on the post-delta triples (kept entries
        in their original input order, then the delta entries), built
        without re-sorting the untouched entries: the delta is sorted on
        its own (O(d log d) over d = delta + displaced entries), spliced
        into the cached order with a linear positional merge, and only the
        touched (segment, lane) buckets are marked for re-encode.

        Modes:
          * ``"add"``    — append the delta triples as new COO entries
            (duplicates sum, standard COO semantics).
          * ``"set"``    — remove every existing entry at each delta
            ``(row, col)`` pair, then insert the delta entry (explicit
            zeros stay; use ``"delete"`` to remove).
          * ``"delete"`` — remove every existing entry at each delta pair
            (``vals`` may be omitted; pairs not present are no-ops).
        """
        if mode not in ("add", "set", "delete"):
            raise ValueError(f"mode must be add|set|delete, got {mode!r}")
        cfg = self.config
        m, k = self.shape
        if vals is None:
            if mode != "delete":
                raise ValueError("vals is required unless mode='delete'")
            vals = np.zeros(np.asarray(rows).shape, np.float32)
        d_rows, d_cols, d_vals = _validate_coo(rows, cols, vals,
                                               (m, k), cfg)
        w, lanes = cfg.segment_width, cfg.lanes
        row_span = -(-m // lanes)

        def bucket_of(r, c):
            sg = c >> w.bit_length() - 1 if not w & (w - 1) else c // w
            ln = r & (lanes - 1) if not lanes & (lanes - 1) else r % lanes
            return sg * np.int64(lanes) + ln

        # Entries displaced by set/delete: every cached entry whose
        # (row, col) pair appears in the delta.
        if mode == "add" or d_rows.size == 0 or self.nnz == 0:
            remove = np.zeros(self.nnz, np.bool_)
        else:
            pair_old = self.rows * np.int64(k) + self.cols
            pair_del = np.unique(d_rows * np.int64(k) + d_cols)
            remove = _member_of_sorted(pair_del, pair_old, m * k)
        n_removed = int(np.count_nonzero(remove))

        none = slice(0, 0)
        add_r = d_rows[none] if mode == "delete" else d_rows
        add_c = d_cols[none] if mode == "delete" else d_cols
        add_v = d_vals[none] if mode == "delete" else d_vals
        n_added = int(add_r.size)

        t_rows = np.concatenate([add_r, self.rows[remove]])
        t_cols = np.concatenate([add_c, self.cols[remove]])
        touched_buckets = np.unique(bucket_of(t_rows, t_cols))
        if touched_buckets.size == 0:          # no-op delta
            return DeltaMerge(prepared=self, touched_rows=t_rows,
                              touched_cols=t_cols,
                              touched_buckets=touched_buckets,
                              touched_segments=touched_buckets,
                              n_added=0, n_removed=0)

        keep = None if n_removed == 0 else ~remove
        n_kept = self.nnz - n_removed

        def gather(a, tail):                 # avoid the O(nnz) boolean
            return np.concatenate(           # gather when nothing is
                [a if keep is None else a[keep], tail])  # removed

        new_rows = gather(self.rows, add_r)
        new_cols = gather(self.cols, add_c)
        new_vals = gather(self.vals, add_v).astype(np.float32)
        n_new = n_kept + n_added

        # Bucket of every cached entry in sorted order (the cached int32
        # key when present — no per-entry div/mod rebuild).
        bk_all = self.bucket_key
        if bk_all is None:
            bk_all = bucket_of(self.rows, self.cols)
        bk_o = bk_all[self.order]
        nbk = max(1, -(-k // w)) * lanes
        in_touched = _member_of_sorted(touched_buckets, bk_o, nbk)
        # Split the cached order into untouched buckets (reused verbatim
        # — removals only ever hit touched buckets) and touched buckets
        # (re-sorted together with the added entries — ties keep cached
        # entries first, in cached order, exactly like a cold stable sort
        # over the merged input).
        u_seq = self.order[~in_touched]
        bk_u = bk_o[~in_touched]
        t_old = self.order[in_touched]
        if keep is not None:
            t_old = t_old[keep[t_old]]
            newpos = np.cumsum(keep, dtype=np.int64) - 1
            u_seq = newpos[u_seq]
            t_old = newpos[t_old]
        cand = np.concatenate([t_old, n_kept + np.arange(n_added,
                                                         dtype=np.int64)])
        r_cand, c_cand = new_rows[cand], new_cols[cand]
        bk_cand = bucket_of(r_cand, c_cand)
        key_cand = bk_cand * np.int64(row_span) + r_cand // lanes
        perm = np.argsort(key_cand, kind="stable")
        touched_seq = cand[perm]
        # Bucket key ranges are disjoint intervals of the sort key and the
        # two sequences share no bucket, so bucket-level insertion
        # positions reconstruct the global sort with no O(nnz) re-sort.
        ins = np.searchsorted(bk_u, bk_cand[perm].astype(bk_u.dtype,
                                                         copy=False))
        order = np.empty(n_new, np.int64)
        t_dst = ins + np.arange(touched_seq.size, dtype=np.int64)
        u_dst = np.ones(n_new, np.bool_)
        u_dst[t_dst] = False
        order[t_dst] = touched_seq
        order[u_dst] = u_seq

        bk = pk = None
        if self.bucket_key is not None:
            bk = gather(self.bucket_key,
                        bucket_of(add_r, add_c).astype(np.int32))
        if self.packed is not None:
            cl = add_c & (w - 1) if not w & (w - 1) else add_c % w
            add_pk = (np.left_shift((add_r // lanes).astype(np.int32),
                                    ROW_BITS) | cl.astype(np.int32))
            pk = gather(self.packed, add_pk)
        prep = PreparedCOO(shape=self.shape, config=cfg, rows=new_rows,
                           cols=new_cols, vals=new_vals, order=order,
                           bucket_key=bk, packed=pk)
        return DeltaMerge(prepared=prep, touched_rows=t_rows,
                          touched_cols=t_cols,
                          touched_buckets=touched_buckets,
                          touched_segments=np.unique(
                              touched_buckets // lanes),
                          n_added=n_added, n_removed=n_removed)


@dataclasses.dataclass
class DeltaMerge:
    """Result of :meth:`PreparedCOO.merge_delta`.

    ``touched_rows``/``touched_cols`` are the coordinates whose
    (segment, lane) buckets changed — the union of added and displaced
    entries — kept so any partition geometry can derive its own touched
    (shard, segment) set (``partition.plan_apply_delta``).
    """

    prepared: PreparedCOO
    touched_rows: np.ndarray      # int64, |added| + |removed|
    touched_cols: np.ndarray
    touched_buckets: np.ndarray   # sorted unique seg * lanes + lane
    touched_segments: np.ndarray  # sorted unique global segment ids
    n_added: int
    n_removed: int

    @property
    def is_noop(self) -> bool:
        return self.n_added == 0 and self.n_removed == 0


def _key_arrays(rows, cols, shape, config: SerpensConfig):
    """The int32 fast-path bucket arrays of :func:`prepare`.

    Returns ``(bucket_key, packed, rr)`` — per-entry (segment, lane)
    bucket key, packed stream word and lane-local row, all int32 — or
    ``(None, None, None)`` when the geometry overflows the int32 key
    space (prepare's int64/lexsort fallbacks).  ``packed`` alone is None
    when a single-shard stream could not address this many rows (taller
    matrices, row-partition only, rebuild it shard-locally).  Shared by
    :func:`prepare` and the parallel encode front-end
    (:mod:`repro_torch.core.parallel_encode`), which must produce bit-identical
    arrays.
    """
    m, k = int(shape[0]), int(shape[1])
    w, lanes = config.segment_width, config.lanes
    row_span = -(-m // lanes)                  # lane-local rows per lane
    nbk = max(1, -(-k // w)) * lanes           # distinct bucket keys
    if nbk * row_span >= (1 << 31):
        return None, None, None
    seg = seg_of(cols, w)
    ln32, rr32 = lane_split(rows.astype(np.int32), lanes)
    bk = seg.astype(np.int32) * np.int32(lanes) + ln32
    pk = None
    if row_span <= row_capacity(config):
        cl64 = cols & (w - 1) if not w & (w - 1) else cols % w
        pk = np.left_shift(rr32, ROW_BITS) | cl64.astype(np.int32)
    return bk, pk, rr32


def sort_order(rows, cols, shape, config: SerpensConfig):
    """Stable (segment, lane, lane-local row) order of validated triples.

    The sort step of :func:`prepare`, shared with the balanced
    lane-assignment path (:mod:`repro_torch.core.partition` re-sorts virtually
    remapped rows without re-validating).  Returns ``(order, bucket_key,
    packed)``; the cached key arrays are None outside the int32 fast path.

    The key is packed into the narrowest integer numpy's radix sort
    handles fast — int32 covers every realistic geometry; int64 is the
    fallback for enormous segment counts.
    """
    m, k = int(shape[0]), int(shape[1])
    w, lanes = config.segment_width, config.lanes
    row_span = -(-m // lanes)                  # lane-local rows per lane
    nbk = max(1, -(-k // w)) * lanes           # distinct bucket keys
    bk, pk, rr32 = _key_arrays(rows, cols, (m, k), config)
    if bk is not None:
        key = bk * np.int32(row_span) + rr32
    elif nbk * row_span < (1 << 62):
        seg = seg_of(cols, w)
        key = (seg * lanes + rows % lanes) * row_span + rows // lanes
    else:                                      # astronomically tall/wide
        seg = seg_of(cols, w)
        return (np.lexsort((rows // lanes, seg * lanes + rows % lanes)),
                None, None)
    return np.argsort(key, kind="stable"), bk, pk


def prepare(rows, cols, vals, shape,
            config: SerpensConfig = SerpensConfig()) -> PreparedCOO:
    """Validate COO triples and run the global bucket sort once."""
    rows, cols, vals = _validate_coo(rows, cols, vals, shape, config)
    m, k = int(shape[0]), int(shape[1])
    order, bk, pk = sort_order(rows, cols, (m, k), config)
    return PreparedCOO(shape=(m, k), config=config,
                       rows=rows, cols=cols, vals=vals, order=order,
                       bucket_key=bk, packed=pk)


def encode(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    shape: tuple[int, int],
    config: SerpensConfig = SerpensConfig(),
) -> SerpensMatrix:
    """Convert a COO matrix into the Serpens stream format (vectorized).

    Duplicate (row, col) entries are allowed and are summed (standard COO
    semantics); they stay separate stream elements, kept ``raw_window`` slots
    apart by the coloring pass.

    Semantics match :func:`encode_reference` (the executable spec): identical
    recovered COO multiset, identical spill selection, and stream padding no
    worse — but built in a handful of numpy passes instead of a per-element
    Python heap loop.
    """
    return encode_prepared(prepare(rows, cols, vals, shape, config))


def encode_prepared(prep: PreparedCOO) -> SerpensMatrix:
    """Encode an already-validated/sorted :class:`PreparedCOO`."""
    shard = np.zeros(prep.nnz, np.int64)
    return _encode_stream(prep.order, shard, prep.rows, prep.cols, prep.vals,
                          1, prep.shape, prep.config,
                          bk_a=prep.bucket_key, pk_a=prep.packed)[0]


def _group_starts(key_sorted: np.ndarray):
    """(starts, sizes) of equal-key runs in a sorted key array (non-empty)."""
    n = key_sorted.size
    flag = np.empty(n, np.bool_)
    flag[0] = True
    np.not_equal(key_sorted[1:], key_sorted[:-1], out=flag[1:])
    starts = np.flatnonzero(flag)
    sizes = np.diff(np.append(starts, n))
    return starts, sizes


def _encode_stream(order, shard, rows_loc, cols_loc, vals, n_shards: int,
                   shape_local: tuple[int, int], config: SerpensConfig,
                   bk_a=None, pk_a=None) -> list[SerpensMatrix]:
    """The vectorized bucket pipeline shared by :func:`encode` and
    ``partition.make_plan`` — returns one :class:`SerpensMatrix` per shard.

    ``order`` must list entry indices by (shard, segment, lane, lane-local
    row) with ties in input order (see :func:`prepare`);
    ``rows_loc``/``cols_loc`` are shard-local coordinates.  Everything
    downstream of the caller's sort is counting-sort bookkeeping over
    (segment, lane) buckets, a *group-level* sort (distinct (bucket, row)
    pairs — far fewer than nnz), closed-form slot assignment, and two
    scatter writes: O(nnz) numpy passes with no per-element Python.

    The RAW-window reordering uses the closed form of the greedy
    most-frequent-first cooldown schedule.  Per (segment, lane) bucket with
    ``n`` kept entries, max destination-row multiplicity ``c``, ``k`` rows at
    that multiplicity and window ``T``, the optimal schedule length is
    ``max(n, (c-1)*T + k)`` — the bound the per-element greedy achieves.  It
    is realized directly: the ``k`` hottest rows sit at offsets ``0..k-1`` of
    ``c-1`` frames plus a tail (frame ``f`` of width ``k + free_f`` with
    ``free_f = max(T-k, ⌊R/(c-1)⌋ (+1 for the first R mod (c-1) frames))``
    for ``R`` remaining entries), and the remaining rows — multiplicity
    descending — fill the frames' free slots level-major.  Same-row
    occurrences then always land ≥ T slots apart: consecutive frames at equal
    offset are ``width ≥ T`` apart, and descending-multiplicity order aligns
    every row that could wrap past the last frame back to frame 0.
    """
    cfg = config
    m_l, k_l = shape_local
    _check_row_capacity(m_l, cfg)
    w, lanes, T = cfg.segment_width, cfg.lanes, cfg.raw_window
    sub = cfg.sublanes
    spc = sub * cfg.tiles_per_chunk
    num_segments = max(1, -(-k_l // w))

    vdt = cfg.np_value_dtype

    def null_stream():
        idx = np.full((cfg.tiles_per_chunk, sub, lanes), SENTINEL,
                      dtype=np.int32)
        return (idx, np.zeros(idx.shape, vdt),
                np.zeros((cfg.tiles_per_chunk,), np.int32))

    shard = np.asarray(shard, np.int64)
    nnz_shard = np.bincount(shard, minlength=n_shards) if shard.size else \
        np.zeros(n_shards, np.int64)
    n_all = int(order.size)
    if n_all == 0:
        out = []
        for _ in range(n_shards):
            idx, val, seg_ids = null_stream()
            out.append(SerpensMatrix(
                shape=shape_local, nnz=0, config=cfg, idx=idx, val=val,
                seg_ids=seg_ids, num_segments=num_segments))
        return out

    rows_loc = np.asarray(rows_loc, np.int64)
    cols_loc = np.asarray(cols_loc, np.int64)
    vals = np.asarray(vals, np.float32)

    # Bucket/slot arithmetic runs in int32 whenever the bounds allow (the
    # pipeline is memory-bound; half-width passes are ~2× cheaper) and falls
    # back to int64 for huge geometries.  The slot bound L ≤ n·(T+1) covers
    # every intermediate of the closed-form schedule.
    nboxes = num_segments * lanes * n_shards
    small = (nboxes < (1 << 31) and m_l < (1 << 31)
             and (n_all + 1) * (T + 1) < (1 << 31))
    I = np.int32 if small else np.int64

    # Per-entry geometry in input order (cheap dtype), gathered once.  The
    # packed stream word is built pre-sort so only three gathers are needed;
    # the lane-local row is recovered from it by shift (sign extension is
    # bijective, so equality tests work unmasked).  ``prepare`` hands both
    # arrays in when its geometry matches (single/col partitions).
    if pk_a is None:
        rsrc = rows_loc if I is np.int64 else rows_loc.astype(I)
        cl_a = (cols_loc & (w - 1) if not w & (w - 1)
                else cols_loc % w)
        pk_a = (np.left_shift((rsrc // lanes).astype(np.int32), ROW_BITS)
                | cl_a.astype(np.int32))
    if bk_a is None:
        rsrc = rows_loc if I is np.int64 else rows_loc.astype(I)
        ln_a = (rsrc & (lanes - 1) if not lanes & (lanes - 1)
                else rsrc % lanes)
        sg_a = (cols_loc >> w.bit_length() - 1 if not w & (w - 1)
                else cols_loc // w).astype(I)
        if n_shards == 1:
            bk_a = sg_a * I(lanes) + ln_a.astype(I)
        else:
            bk_a = ((shard.astype(I) * I(num_segments) + sg_a) * I(lanes)
                    + ln_a.astype(I))
    pk = pk_a[order]             # (rr << 16) | col_local, the stream word
    vv = vals[order]
    bk = bk_a[order]
    rr = pk >> ROW_BITS          # sign-extended lane-local row (bijective)

    # ---- spill passes (selection must match encode_reference) -----------
    keep = None
    if cfg.lane_balance:
        # Cap each lane's depth at lane_balance × the segment's mean lane
        # depth, keeping the earliest entries in *input* order — which needs
        # the input-order rank within each bucket, one extra stable pass.
        sgk = bk // I(lanes)
        s_starts, s_sizes = _group_starts(sgk)
        cap = np.ceil(cfg.lane_balance
                      * np.maximum(1, s_sizes // lanes)).astype(I)
        oB = np.argsort(bk_a, kind="stable")
        sB, zB = _group_starts(bk_a[oB])
        pos_in = np.empty(n_all, I)
        pos_in[oB] = np.arange(n_all, dtype=I) - np.repeat(
            sB.astype(I), zB)
        keep = pos_in[order] < np.repeat(cap, s_sizes)
    if cfg.spill_hot_rows:
        # Cap per-row occupancy at ~n_lane/T (earliest occurrences kept) so
        # the schedule length stays ≈ n_lane; excess goes to the aux COO.
        # The caller's order makes (bucket, row) runs contiguous with
        # occurrences in input order.
        if keep is None:
            keep = np.ones(n_all, np.bool_)
        rowflag = np.empty(n_all, np.bool_)
        rowflag[0] = True
        np.not_equal(bk[1:], bk[:-1], out=rowflag[1:])
        rowflag[1:] |= rr[1:] != rr[:-1]
        b_starts, b_sizes = _group_starts(bk)
        nkept_b = np.add.reduceat(keep, b_starts)
        cap2 = np.maximum(1, nkept_b // T)
        ex_cum = np.cumsum(keep, dtype=I) - keep     # exclusive kept-count
        rg_starts = np.flatnonzero(rowflag)
        rg_sizes = np.diff(np.append(rg_starts, n_all))
        occ_kept = ex_cum - np.repeat(ex_cum[rg_starts], rg_sizes)
        keep &= occ_kept < np.repeat(cap2.astype(I), b_sizes)

    if keep is not None and not keep.all():
        spm = ~keep
        spm_orig = order[spm]                    # original entry indices
        aux_sh = shard[spm_orig]
        aux_r_all = rows_loc[spm_orig].astype(np.int32)
        aux_c_all = cols_loc[spm_orig].astype(np.int32)
        aux_v_all = vals[spm_orig]
        kidx = np.flatnonzero(keep)
        bk, rr, pk, vv = (a[kidx] for a in (bk, rr, pk, vv))
    else:
        aux_sh = np.zeros((0,), np.int64)
        aux_r_all = _empty_i32()
        aux_c_all = _empty_i32()
        aux_v_all = _empty_f32()
    nk = int(bk.size)
    aux_bounds = np.searchsorted(aux_sh, np.arange(n_shards + 1))
    if nk == 0:  # every occupied bucket keeps ≥ 1 entry; defensive only
        out = []
        for d in range(n_shards):
            idx, val, seg_ids = null_stream()
            alo, ahi = aux_bounds[d], aux_bounds[d + 1]
            out.append(SerpensMatrix(
                shape=shape_local, nnz=int(nnz_shard[d]), config=cfg,
                idx=idx, val=val, seg_ids=seg_ids, num_segments=num_segments,
                aux_rows=aux_r_all[alo:ahi], aux_cols=aux_c_all[alo:ahi],
                aux_vals=aux_v_all[alo:ahi]))
        return out

    # ---- closed-form RAW-window schedule over kept entries ---------------
    # Group level: one element per distinct (bucket, row) pair.
    rowflag = np.empty(nk, np.bool_)
    rowflag[0] = True
    np.not_equal(bk[1:], bk[:-1], out=rowflag[1:])
    bflag_tail = rowflag[1:].copy()              # bucket-change flags
    rowflag[1:] |= rr[1:] != rr[:-1]
    rg_starts = np.flatnonzero(rowflag)          # (G,) group -> entry start
    G = rg_starts.size
    g_mult = np.diff(np.append(rg_starts, nk)).astype(I)
    gb_flag = np.empty(G, np.bool_)              # bucket change, group level
    gb_flag[0] = True
    if G > 1:
        gb_flag[1:] = bflag_tail[rg_starts[1:] - 1]
    g_bid = np.cumsum(gb_flag) - 1               # dense bucket id per group
    B_gstarts = np.flatnonzero(gb_flag)          # bucket -> first group
    # Per-bucket schedule constants (all B-sized, B = #occupied buckets).
    cmax_b = np.maximum.reduceat(g_mult, B_gstarts)
    is_hot_g = g_mult == cmax_b[g_bid]
    kh_b = np.add.reduceat(is_hot_g, B_gstarts).astype(I)
    nb_b = np.add.reduceat(g_mult, B_gstarts)
    ent_bstart_b = rg_starts[B_gstarts].astype(I)  # bucket -> entry start
    Fs_b = np.maximum(cmax_b - 1, 1)
    rem_b = nb_b - kh_b * cmax_b
    base_b = rem_b // Fs_b
    extra_b = rem_b - base_b * Fs_b
    c0_b = np.maximum(T - kh_b, base_b)          # free slots, narrow frames
    c1_b = np.maximum(T - kh_b, base_b + 1)      # ... first `extra` frames
    A_b = kh_b + c0_b                            # frame_start slope
    D_b = c1_b - c0_b                            # +1 while f < extra

    if int(cmax_b.max()) == 1:
        # Every destination row distinct in every bucket: the identity
        # schedule is hazard-free (the reference's fast path, bucket-wide).
        slot = np.arange(nk, dtype=I) - np.repeat(ent_bstart_b, nb_b)
    else:
        # Groups reorder to (bucket, multiplicity desc, row); entries keep
        # following their group with occurrences in order, so a G-sized sort
        # replaces any per-entry sort, and slots are computed in the
        # *current* entry order via each group's final-position constants.
        g_row = rr[rg_starts] & COL_MASK         # bijective per row: any
        if G * np.int64(nk + 2) < (np.int64(1) << 46):  # fixed order works
            gkey = ((g_bid * np.int64(nk + 2) + (nk + 1 - g_mult))
                    << ROW_BITS) | g_row
            g_order = np.argsort(gkey)           # keys unique: kind is free
        else:                                    # giant inputs: 3-key radix
            g_order = np.lexsort((g_row, -g_mult, g_bid))
        sz = g_mult[g_order]
        new_starts = (np.cumsum(sz, dtype=I) - sz)
        # Final entry-start and bucket-rank of each ORIGINAL group.
        start_fin_g = np.empty(G, I)
        start_fin_g[g_order] = new_starts
        pos_fin_g = np.empty(G, I)
        pos_fin_g[g_order] = np.arange(G, dtype=I)
        rank_g = pos_fin_g - B_gstarts.astype(I)[g_bid]
        hot_g = rank_g < kh_b[g_bid]
        # Level-major fill index base for non-hot groups (hot groups unused).
        qg = (start_fin_g - ent_bstart_b[g_bid]
              - (kh_b * cmax_b)[g_bid])
        # Expand per-bucket constants to groups once (G-sized gathers), and
        # merge the additive terms: hot entries add their row rank, the
        # rest add kh (+ fill level, below).
        A_g = A_b[g_bid]
        D_g = D_b[g_bid]
        extra_g = extra_b[g_bid]
        Fs_g = Fs_b[g_bid]
        band0_g = Fs_g * c0_b[g_bid]
        off_g = np.where(hot_g, rank_g, kh_b[g_bid])
        # Per-entry expansion: entries follow their group contiguously, so
        # every "gather by group index" is a plain np.repeat — much cheaper
        # than indexed loads at this size.
        j = np.arange(nk, dtype=I) - np.repeat(rg_starts.astype(I), g_mult)
        hot_e = np.repeat(hot_g, g_mult)
        extra_e = np.repeat(extra_g, g_mult)
        q = np.maximum(np.repeat(qg, g_mult) + j, 0)  # hot entries carry
        Fs_e = np.repeat(Fs_g, g_mult)           # garbage q; masked below
        d0 = q // Fs_e
        lvl = d0
        frm = q - d0 * Fs_e
        over = np.flatnonzero(q >= np.repeat(band0_g, g_mult))
        if over.size:                            # ragged top band: rare,
            geo = np.searchsorted(rg_starts, over, side="right") - 1
            qx = q[over] - band0_g[geo]          # computed on the subset
            exo = np.maximum(extra_g[geo], 1)
            lvl[over] = c0_b[g_bid][geo] + qx // exo
            frm[over] = qx - (qx // exo) * exo
        f_or_j = np.where(hot_e, j, frm)
        slot = (np.repeat(A_g, g_mult) * f_or_j
                + np.repeat(D_g, g_mult) * np.minimum(f_or_j, extra_e)
                + np.repeat(off_g, g_mult) + np.where(hot_e, 0, lvl))

    # ---- materialize: per-(shard, segment) depths, two scatter writes ----
    # Segment grouping derived at bucket level (entry order is unchanged).
    ubk = bk[ent_bstart_b]                       # bucket keys, B-sized
    useg = ubk // I(lanes)                       # (shard·S + seg) per bucket
    sb_flag = np.empty(useg.size, np.bool_)
    sb_flag[0] = True
    np.not_equal(useg[1:], useg[:-1], out=sb_flag[1:])
    S_bfirst = np.flatnonzero(sb_flag)           # segment -> first bucket
    ent_sstart = ent_bstart_b[S_bfirst]          # segment -> entry start
    S_sizes = np.diff(np.append(ent_sstart, nk))
    depth = np.maximum.reduceat(slot, ent_sstart).astype(np.int64) + 1
    depth = np.maximum(spc, -(-depth // spc) * spc)  # chunk-aligned
    total = int(depth.sum())
    I2 = np.int32 if total * lanes < (1 << 31) else np.int64
    gbase = (np.cumsum(depth) - depth).astype(I2)
    grow = np.repeat(gbase, S_sizes) + slot.astype(I2)
    idx_flat = np.full((total * lanes,), SENTINEL, np.int32)
    # Values are rounded to the stream dtype exactly once, here — the
    # master triples stay fp32 (PreparedCOO), so incremental re-encodes
    # round identically to a cold encode (bf16(v) is deterministic and
    # bf16(bf16(v)) == bf16(v)).
    val_flat = np.zeros((total * lanes,), vdt)
    ln = (bk & (lanes - 1) if not lanes & (lanes - 1)
          else bk % lanes).astype(I2)
    flat_pos = grow * I2(lanes) + ln
    idx_flat[flat_pos] = pk
    val_flat[flat_pos] = stream_values(vv, vdt)
    idx_flat = idx_flat.reshape(total, lanes)
    val_flat = val_flat.reshape(total, lanes)

    uniq = useg[S_bfirst].astype(np.int64)
    g_shard = uniq // num_segments
    g_seg = (uniq % num_segments).astype(np.int32)
    shard_rows = np.zeros(n_shards + 1, np.int64)
    np.add.at(shard_rows, g_shard + 1, depth)
    row_bounds = np.cumsum(shard_rows)
    g_bounds = np.searchsorted(g_shard, np.arange(n_shards + 1))

    out = []
    for d in range(n_shards):
        lo, hi = row_bounds[d], row_bounds[d + 1]
        if hi == lo:
            idx, val, seg_ids = null_stream()
        else:
            glo, ghi = g_bounds[d], g_bounds[d + 1]
            idx = idx_flat[lo:hi].reshape(-1, sub, lanes)
            val = val_flat[lo:hi].reshape(-1, sub, lanes)
            seg_ids = np.repeat(g_seg[glo:ghi], depth[glo:ghi] // sub)
        alo, ahi = aux_bounds[d], aux_bounds[d + 1]
        out.append(SerpensMatrix(
            shape=shape_local, nnz=int(nnz_shard[d]), config=cfg,
            idx=idx, val=val, seg_ids=seg_ids, num_segments=num_segments,
            aux_rows=aux_r_all[alo:ahi], aux_cols=aux_c_all[alo:ahi],
            aux_vals=aux_v_all[alo:ahi]))
    return out


def splice_encoded(old: SerpensMatrix, mini: SerpensMatrix | None,
                   touched_segments, nnz_new: int) -> SerpensMatrix:
    """Splice re-encoded segment blocks into an existing stream.

    ``mini`` must encode *exactly* the post-delta entries of
    ``touched_segments`` (same shape/config — the output of
    :func:`_encode_stream` over those entries; ``None`` when every touched
    segment emptied out).  Because the stream is the concatenation of
    per-segment tile blocks — each self-contained (depth, spill caps and
    RAW schedule all derive from that segment's entries alone) and
    chunk-aligned — replacing the touched blocks and keeping the rest
    byte-for-byte yields the same stream a cold encode of the post-delta
    matrix would produce.  Cost: O(touched blocks) slicing + one
    concatenate, never a global re-encode.
    """
    cfg = old.config
    touched = np.unique(np.asarray(touched_segments, np.int64))
    if touched.size == 0:
        return old
    sub, lanes = cfg.sublanes, cfg.lanes

    def blocks(sm):
        """Tile/aux arrays with the null-chunk placeholder stripped."""
        if sm is None or sm.nnz - sm.n_aux <= 0:
            return (np.zeros((0, sub, lanes), np.int32),
                    np.zeros((0, sub, lanes), cfg.np_value_dtype),
                    np.zeros((0,), np.int32),
                    _empty_i32(), _empty_i32(), _empty_f32(),
                    np.zeros((0,), np.int64))
        aseg = (sm.aux_cols.astype(np.int64) // cfg.segment_width
                if sm.n_aux else np.zeros((0,), np.int64))
        return (sm.idx, sm.val, sm.seg_ids,
                sm.aux_rows, sm.aux_cols, sm.aux_vals, aseg)

    oidx, oval, oseg, oar, oac, oav, oaseg = blocks(old)
    midx, mval, mseg, mar, mac, mav, maseg = blocks(mini)

    tile_p: list[tuple] = []       # (idx, val, seg_ids) pieces, in order
    aux_p: list[tuple] = []
    prev = prev_a = 0
    for s in touched.tolist():
        lo, hi = np.searchsorted(oseg, [s, s + 1])
        mlo, mhi = np.searchsorted(mseg, [s, s + 1])
        tile_p.append((oidx[prev:lo], oval[prev:lo], oseg[prev:lo]))
        tile_p.append((midx[mlo:mhi], mval[mlo:mhi], mseg[mlo:mhi]))
        prev = hi
        alo, ahi = np.searchsorted(oaseg, [s, s + 1])
        malo, mahi = np.searchsorted(maseg, [s, s + 1])
        aux_p.append((oar[prev_a:alo], oac[prev_a:alo], oav[prev_a:alo]))
        aux_p.append((mar[malo:mahi], mac[malo:mahi], mav[malo:mahi]))
        prev_a = ahi
    tile_p.append((oidx[prev:], oval[prev:], oseg[prev:]))
    aux_p.append((oar[prev_a:], oac[prev_a:], oav[prev_a:]))

    idx = np.concatenate([p[0] for p in tile_p])
    val = np.concatenate([p[1] for p in tile_p])
    seg_ids = np.concatenate([p[2] for p in tile_p])
    if idx.shape[0] == 0:          # stream emptied: keep shapes static
        idx = np.full((cfg.tiles_per_chunk, sub, lanes), SENTINEL,
                      np.int32)
        val = np.zeros(idx.shape, cfg.np_value_dtype)
        seg_ids = np.zeros((cfg.tiles_per_chunk,), np.int32)
    return SerpensMatrix(
        shape=old.shape, nnz=int(nnz_new), config=cfg,
        idx=idx, val=val, seg_ids=seg_ids, num_segments=old.num_segments,
        aux_rows=np.concatenate([p[0] for p in aux_p]),
        aux_cols=np.concatenate([p[1] for p in aux_p]),
        aux_vals=np.concatenate([p[2] for p in aux_p]))


def _schedule_lane(rows, cols, vals, window):
    """Reorder one lane's non-zeros so no row repeats within ``window`` slots.

    Greedy most-frequent-first with cooldown (the classic task-scheduler
    algorithm that the paper's 'coloring + reordering' reduces to for a single
    lane).  ``rows`` are lane-local (already divided by LANES).  Returns
    parallel lists (slot_rows, slot_cols, slot_vals); padded slots hold
    (SENTINEL, 0, 0.0).
    """
    n = len(rows)
    if n == 0:
        return [], [], []
    # Fast path: every destination row distinct ⇒ any order is hazard-free.
    if len(np.unique(rows)) == n:
        return list(rows), list(cols), list(vals)
    order = np.argsort(rows, kind="stable")
    rows_s, cols_s, vals_s = rows[order], cols[order], vals[order]
    uniq, starts = np.unique(rows_s, return_index=True)
    bounds = list(starts) + [n]
    buckets = {}
    for i, r in enumerate(uniq):
        lo, hi = bounds[i], bounds[i + 1]
        buckets[int(r)] = [(float(vals_s[j]), int(cols_s[j]))
                           for j in range(lo, hi)]

    heap = [(-len(v), r) for r, v in buckets.items()]
    heapq.heapify(heap)
    cooldown: list[tuple[int, int, int]] = []  # (ready_slot, -remaining, row)
    out_rows: list[int] = []
    out_cols: list[int] = []
    out_vals: list[float] = []
    t = 0
    while heap or cooldown:
        while cooldown and cooldown[0][0] <= t:
            _, negrem, r = heapq.heappop(cooldown)
            heapq.heappush(heap, (negrem, r))
        if heap:
            negrem, r = heapq.heappop(heap)
            v, c = buckets[r].pop(0)
            out_rows.append(r)
            out_cols.append(c)
            out_vals.append(v)
            if -negrem > 1:
                heapq.heappush(cooldown, (t + window, negrem + 1, r))
        else:
            out_rows.append(int(SENTINEL))
            out_cols.append(0)
            out_vals.append(0.0)
        t += 1
    return out_rows, out_cols, out_vals


def encode_reference(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    shape: tuple[int, int],
    config: SerpensConfig = SerpensConfig(),
) -> SerpensMatrix:
    """Per-lane greedy heapq encoder — the executable spec for :func:`encode`.

    O(num_segments × lanes) Python loop around a per-element heap; kept as
    the equivalence arbiter (round-trip multiset, invariants, padding) for
    the vectorized pipeline, and as the baseline of
    ``benchmarks/encode_throughput.py``.
    """
    m, k = shape
    rows, cols, vals = _validate_coo(rows, cols, vals, shape, config)
    _check_row_capacity(m, config)
    cfg = config

    w = cfg.segment_width
    num_segments = max(1, -(-k // w))
    slots_per_lane_chunk = cfg.sublanes * cfg.tiles_per_chunk

    seg_of = cols // w
    lane_of = rows % cfg.lanes

    tile_idx_parts: list[np.ndarray] = []
    tile_val_parts: list[np.ndarray] = []
    seg_id_parts: list[int] = []

    # Pre-sort once by segment for cheap per-segment slicing.
    seg_order = np.argsort(seg_of, kind="stable")
    seg_sorted = seg_of[seg_order]
    seg_bounds = np.searchsorted(seg_sorted, np.arange(num_segments + 1))

    aux_r: list[np.ndarray] = []
    aux_c: list[np.ndarray] = []
    aux_v: list[np.ndarray] = []

    for s in range(num_segments):
        lo, hi = seg_bounds[s], seg_bounds[s + 1]
        if lo == hi:
            continue
        sel = seg_order[lo:hi]
        r_s, v_s, l_s = rows[sel], vals[sel], lane_of[sel]
        c_local = cols[sel] - s * w  # segment-local column (index coalescing)
        # Per-lane scheduling (coloring + reordering).
        lane_sched: list[tuple[list, list, list]] = []
        depth = 0
        lane_sort = np.argsort(l_s, kind="stable")
        l_sorted = l_s[lane_sort]
        lane_bounds = np.searchsorted(l_sorted, np.arange(cfg.lanes + 1))
        mean_depth = max(1, (hi - lo) // cfg.lanes)
        lane_cap = (int(np.ceil(cfg.lane_balance * mean_depth))
                    if cfg.lane_balance else None)
        for lane in range(cfg.lanes):
            llo, lhi = lane_bounds[lane], lane_bounds[lane + 1]
            pick = lane_sort[llo:lhi]
            if lane_cap is not None and len(pick) > lane_cap:
                spill = pick[lane_cap:]
                aux_r.append(r_s[spill].astype(np.int32))
                aux_c.append((c_local[spill] + s * w).astype(np.int32))
                aux_v.append(v_s[spill])
                pick = pick[:lane_cap]
            if cfg.spill_hot_rows and len(pick):
                # Cap per-row occupancy at ~n/window so the schedule length
                # stays ≈ n; divert the excess to the aux COO side-stream.
                lane_rows = r_s[pick]
                cap = max(1, len(pick) // cfg.raw_window)
                order_in = np.argsort(lane_rows, kind="stable")
                rr = lane_rows[order_in]
                occ = np.arange(len(rr)) - np.searchsorted(rr, rr,
                                                           side="left")
                keep_sorted = occ < cap
                keep = np.empty(len(pick), bool)
                keep[order_in] = keep_sorted
                if not keep.all():
                    spill = pick[~keep]
                    aux_r.append(r_s[spill].astype(np.int32))
                    aux_c.append((c_local[spill] + s * w).astype(np.int32))
                    aux_v.append(v_s[spill])
                    pick = pick[keep]
            sched = _schedule_lane(
                (r_s[pick] // cfg.lanes).astype(np.int64),
                c_local[pick], v_s[pick], cfg.raw_window)
            lane_sched.append(sched)
            depth = max(depth, len(sched[0]))
        # Pad every lane to the chunk-aligned common depth.
        depth = max(slots_per_lane_chunk,
                    -(-depth // slots_per_lane_chunk) * slots_per_lane_chunk)
        idx_mat = np.full((depth, cfg.lanes), SENTINEL, dtype=np.int32)
        val_mat = np.zeros((depth, cfg.lanes), dtype=cfg.np_value_dtype)
        for lane in range(cfg.lanes):
            lr, lc, lv = lane_sched[lane]
            if not lr:
                continue
            lr_arr = np.asarray(lr, dtype=np.int64)
            lc_arr = np.asarray(lc, dtype=np.int64)
            live = lr_arr != SENTINEL
            packed = np.where(live, (lr_arr << ROW_BITS) | lc_arr,
                              np.int64(-1))
            idx_mat[: len(lr), lane] = packed.astype(np.int32)
            val_mat[: len(lr), lane] = stream_values(lv, val_mat.dtype)
        tile_idx_parts.append(idx_mat.reshape(-1, cfg.sublanes, cfg.lanes))
        tile_val_parts.append(val_mat.reshape(-1, cfg.sublanes, cfg.lanes))
        seg_id_parts.extend([s] * (depth // cfg.sublanes))

    if tile_idx_parts:
        idx = np.concatenate(tile_idx_parts, axis=0)
        val = np.concatenate(tile_val_parts, axis=0)
        seg_ids = np.asarray(seg_id_parts, dtype=np.int32)
    else:  # all-zero matrix: one null chunk keeps shapes static
        idx = np.full((cfg.tiles_per_chunk, cfg.sublanes, cfg.lanes), SENTINEL,
                      dtype=np.int32)
        val = np.zeros(idx.shape, dtype=cfg.np_value_dtype)
        seg_ids = np.zeros((cfg.tiles_per_chunk,), dtype=np.int32)

    # Chunk alignment: the kernel grid steps over whole chunks.
    rem = idx.shape[0] % cfg.tiles_per_chunk
    if rem:
        pad = cfg.tiles_per_chunk - rem
        idx = np.concatenate(
            [idx, np.full((pad,) + idx.shape[1:], SENTINEL, dtype=np.int32)])
        val = np.concatenate([val, np.zeros((pad,) + val.shape[1:],
                                            val.dtype)])
        seg_ids = np.concatenate(
            [seg_ids, np.full((pad,), seg_ids[-1], dtype=np.int32)])

    return SerpensMatrix(
        shape=(m, k), nnz=int(vals.size), config=cfg,
        idx=idx, val=val, seg_ids=seg_ids, num_segments=num_segments,
        aux_rows=np.concatenate(aux_r) if aux_r else _empty_i32(),
        aux_cols=np.concatenate(aux_c) if aux_c else _empty_i32(),
        aux_vals=(np.concatenate(aux_v).astype(np.float32) if aux_v
                  else _empty_f32()))


def decode_to_coo(sm: SerpensMatrix):
    """Inverse transform (for testing): recover COO triples from the stream."""
    cfg = sm.config
    idx = sm.idx.reshape(-1, cfg.lanes)
    val = sm.val.reshape(-1, cfg.lanes)
    # Each tile row inherits its tile's segment id.
    seg = np.repeat(sm.seg_ids, cfg.sublanes)[:, None]
    live = idx != SENTINEL
    lanes = np.broadcast_to(np.arange(cfg.lanes)[None, :], idx.shape)
    rows_local = (idx.astype(np.int64) >> ROW_BITS) & COL_MASK
    cols_local = idx.astype(np.int64) & COL_MASK
    rows = rows_local * cfg.lanes + lanes
    cols = seg * cfg.segment_width + cols_local
    out_r = rows[live].astype(np.int64)
    out_c = cols[live].astype(np.int64)
    out_v = values_f32(val[live])
    if sm.n_aux:
        out_r = np.concatenate([out_r, sm.aux_rows.astype(np.int64)])
        out_c = np.concatenate([out_c, sm.aux_cols.astype(np.int64)])
        out_v = np.concatenate([out_v, sm.aux_vals])
    return out_r, out_c, out_v


def check_invariants(sm: SerpensMatrix, *, source=None,
                     row_perm=None) -> None:
    """Assert the format invariants the hardware schedule relies on.

    Thin wrapper over the encoder-independent verifier
    (:func:`repro_torch.analysis.verify.verify_matrix`, full mode), kept
    for its historic name and assert-style contract: seg_ids ascending,
    lane ownership, RAW-window freedom, sentinel legality, lane capacity,
    column ranges, nnz/byte accounting, spill caps and the aux
    side-stream; pass ``source=(rows, cols, vals)`` to also prove the
    round-trip multiset and per-lane ownership against the original COO,
    and ``row_perm`` to validate a balanced-lane permutation.  Raises
    ``AssertionError`` listing *all* violations (plan-level checks live in
    :func:`repro_torch.analysis.verify.verify_plan`).
    """
    # Deferred import: keeps this module import-light (and cycle-free)
    # for encode workers.
    from repro_torch.analysis.verify import verify_matrix
    verify_matrix(sm, mode="full", source=source,
                  row_perm=row_perm).raise_if_error(AssertionError)
