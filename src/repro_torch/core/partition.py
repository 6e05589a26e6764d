"""Channel-shard execution plans — the paper's scaling axis as a data type.

Serpens scales by adding HBM channels (Sec. 4.4, 16 -> 24 channels, Table 5):
the non-zero stream is split across channels while x stays cheap to
replicate.  On a TPU mesh the analogous "channel" is a chip; on one device a
multi-shard plan still describes how the stream traffic divides.  This module
turns that idea into an explicit plan object consumed by one executor
(:class:`repro_torch.core.spmv.SerpensOperator`) instead of a separate code path:

  * ``row`` partition ("more channels for A, disjoint accumulators"): each
    shard owns a contiguous, lane-aligned row block with its own Serpens
    stream; x is replicated (it is tiny relative to A — the paper's
    observation that the vectors deserve few channels); outputs concatenate
    with no inter-shard reduction — the paper's disjoint-URAM-per-PE design
    lifted one level up the hierarchy.

  * ``col`` partition (segments sharded): each shard streams the non-zeros
    of its column range and produces a *partial* full-length y; a sum
    (``psum`` under a mesh) combines.  Used when x itself must be sharded
    (very large K).

  * ``single``: the degenerate one-shard plan — the classic ``SerpensSpMV``.

Every shard is a full :class:`~repro_torch.core.format.SerpensMatrix`, so the
hot-row spill side-stream (aux COO) survives partitioning: each shard keeps
the spills of its own block, and the executor applies the epilogue per shard
before combining.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import format as sformat

PARTITIONS = ("single", "row", "col")
LANE_ASSIGNS = ("modulo", "balanced")


@dataclasses.dataclass(frozen=True)
class PlanSpec:
    """Partition geometry: how a matrix splits into channel shards.

    ``lane_assign`` picks how rows map to accumulator lanes:

      * ``"modulo"``   — the paper's split: row ``r`` is owned by lane
        ``r % lanes``.  Zero bookkeeping, but on power-law matrices the
        lane that drew a hot row sets every segment's schedule depth and
        the other lanes pad up to it.
      * ``"balanced"`` — maxE-style LPT assignment: rows are walked in
        descending nnz and each chunk of ``lanes`` rows goes to the
        currently lightest lanes, so heavy rows share lanes with light
        ones and per-lane totals equalize.  The row→virtual-row
        permutation is carried in the plan (``ChannelShardPlan.row_perm``)
        and undone by one device gather at the end of every matvec, so
        callers see the same output order either way.
    """

    partition: str = "single"
    num_shards: int = 1
    lane_assign: str = "modulo"

    def __post_init__(self):
        if self.partition not in PARTITIONS:
            raise ValueError(
                f"partition must be one of {PARTITIONS}, got "
                f"{self.partition!r}")
        if self.num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        if self.partition == "single" and self.num_shards != 1:
            raise ValueError("'single' plans have exactly one shard")
        if self.lane_assign not in LANE_ASSIGNS:
            raise ValueError(
                f"lane_assign must be one of {LANE_ASSIGNS}, got "
                f"{self.lane_assign!r}")


@dataclasses.dataclass
class ChannelShardPlan:
    """1..N per-channel Serpens streams plus the geometry to combine them.

    ``shards[d]`` is the d-th channel's :class:`SerpensMatrix` in *local*
    coordinates (row partition: rows offset by ``d * block_m``; col
    partition: cols offset by ``d * block_k``).  The stacked arrays pad all
    shards to a common tile count / aux length so they can be ``shard_map``'d
    over a mesh axis as one array with leading dim ``num_shards``.
    """

    shape: tuple[int, int]          # global (M, K)
    config: sformat.SerpensConfig
    spec: PlanSpec
    shards: list[sformat.SerpensMatrix]
    block_m: int                    # rows per shard (row partition)
    block_k: int                    # cols per shard (col partition)
    num_segments_local: int         # x segments per shard (uniform)
    # Stacked host arrays, leading dim = num_shards:
    idx: np.ndarray                 # int32 [N, T, SUB, LANES]
    val: np.ndarray                 # config.np_value_dtype [N, T, SUB, LANES]
    seg_ids: np.ndarray             # int32 [N, T]
    aux_rows: np.ndarray            # int32 [N, A] (A = max aux len, 0-padded)
    aux_cols: np.ndarray            # int32 [N, A]
    aux_vals: np.ndarray            # float32 [N, A]
    # lane_assign="balanced" only: global row r was encoded as virtual row
    # row_perm[r] (injective into the padded accumulator span; block-local
    # for row partitions so the shard of a row is unchanged).  The
    # executor's final gather ``acc[row_perm]`` restores caller row order.
    row_perm: np.ndarray | None = None

    @property
    def num_shards(self) -> int:
        return len(self.shards)

    @property
    def out_rows_padded(self) -> int:
        """Accumulator length of each shard (identical across shards)."""
        return self.shards[0].padded_rows

    @property
    def nnz(self) -> int:
        return int(sum(sm.nnz for sm in self.shards))

    @property
    def n_aux(self) -> int:
        return int(sum(sm.n_aux for sm in self.shards))

    @property
    def stream_bytes(self) -> int:
        """Off-chip bytes for one pass over all shards, including the
        cross-shard tile padding (8 B/slot at fp32, 6 B/slot at bf16) and
        spilled aux COO entries (12 B each, always fp32)."""
        per_slot = 4 + self.config.value_bytes
        return int(self.idx.size) * per_slot + 12 * self.n_aux

    @property
    def padding_ratio(self) -> float:
        total = self.idx.size
        kept = self.nnz - self.n_aux
        return float(total - kept) / max(total, 1)

    @property
    def virtual_rows(self) -> int:
        """Extent of the (virtual) row space the streams were encoded in."""
        if self.spec.partition == "row":
            return self.num_shards * self.block_m
        lanes = self.config.lanes
        return -(-int(self.shape[0]) // lanes) * lanes

    def to_coo(self):
        """Recover global COO triples from all shards (order deterministic)."""
        rs, cs, vs = [], [], []
        for d, sm in enumerate(self.shards):
            r, c, v = sformat.decode_to_coo(sm)
            if self.spec.partition == "row":
                r = r + d * self.block_m
            elif self.spec.partition == "col":
                c = c + d * self.block_k
            rs.append(r)
            cs.append(c)
            vs.append(v)
        r = np.concatenate(rs)
        if self.row_perm is not None:
            # Decoded rows are virtual; invert the balanced permutation.
            inv = np.full(self.virtual_rows, -1, np.int64)
            inv[self.row_perm] = np.arange(int(self.shape[0]),
                                           dtype=np.int64)
            r = inv[r]
        return (r, np.concatenate(cs), np.concatenate(vs))


def _pad_stack(mats: list[sformat.SerpensMatrix]):
    """Stack per-shard streams, padding to a common tile count.

    Padded tail tiles carry the shard's *last* segment id (matching
    ``encode``'s own chunk-alignment padding): padding with 0 would force a
    spurious re-stage of segment 0 — and break the ascending-seg invariant —
    on every shard shorter than the longest one.
    """
    cfg = mats[0].config
    tmax = max(m.num_tiles for m in mats)
    tmax = -(-tmax // cfg.tiles_per_chunk) * cfg.tiles_per_chunk
    if all(m.num_tiles == tmax for m in mats):
        if len(mats) == 1:             # aligned single shard: pure views
            m0 = mats[0]
            return m0.idx[None], m0.val[None], m0.seg_ids[None]
        return (np.stack([m.idx for m in mats]),
                np.stack([m.val for m in mats]),
                np.stack([m.seg_ids for m in mats]))
    idx, val, seg = [], [], []
    for m in mats:
        pad = tmax - m.num_tiles
        idx.append(np.concatenate(
            [m.idx, np.full((pad,) + m.idx.shape[1:], sformat.SENTINEL,
                            np.int32)]))
        val.append(np.concatenate(
            [m.val, np.zeros((pad,) + m.val.shape[1:], m.val.dtype)]))
        seg.append(np.concatenate(
            [m.seg_ids, np.full((pad,), m.seg_ids[-1], np.int32)]))
    return (np.stack(idx), np.stack(val), np.stack(seg))


def _stack_aux(mats: list[sformat.SerpensMatrix]):
    """Stack aux spill streams, 0-padding to a common length.

    Padding entries are (row 0, col 0, val 0.0): the epilogue scatter-add
    contributes exactly 0 for them.
    """
    amax = max(m.n_aux for m in mats)
    if len(mats) == 1:                             # single shard: views
        m0 = mats[0]
        return m0.aux_rows[None], m0.aux_cols[None], m0.aux_vals[None]
    rows = np.zeros((len(mats), amax), np.int32)
    cols = np.zeros((len(mats), amax), np.int32)
    vals = np.zeros((len(mats), amax), np.float32)
    for d, m in enumerate(mats):
        if m.n_aux:
            rows[d, :m.n_aux] = m.aux_rows
            cols[d, :m.n_aux] = m.aux_cols
            vals[d, :m.n_aux] = m.aux_vals
    return rows, cols, vals


def spec_geometry(shape, config: sformat.SerpensConfig,
                  spec: PlanSpec) -> tuple[int, int]:
    """(block_m, block_k) of a plan's shards.

    Row shards are lane-aligned so accumulators concatenate exactly; col
    shards are a whole number of segments so the segment-local packed
    words of a global sort apply verbatim.
    """
    m, k = int(shape[0]), int(shape[1])
    block_m, block_k = m, k
    if spec.partition == "row":
        block_m = -(-m // spec.num_shards)
        block_m = -(-block_m // config.lanes) * config.lanes
    elif spec.partition == "col":
        segs_total = max(1, -(-k // config.segment_width))
        block_k = (-(-segs_total // spec.num_shards)
                   * config.segment_width)
    return block_m, block_k


def finish_plan(shards: list[sformat.SerpensMatrix], shape,
                config: sformat.SerpensConfig, spec: PlanSpec,
                block_m: int, block_k: int,
                row_perm: np.ndarray | None = None) -> ChannelShardPlan:
    """Stack per-shard streams into a :class:`ChannelShardPlan` (the shared
    tail of the serial and parallel encode paths)."""
    # All shards must agree on segment count for a uniform x reshape.
    num_segments = max(sm.num_segments for sm in shards)
    for sm in shards:
        sm.num_segments = num_segments
    idx, val, seg_ids = _pad_stack(shards)
    aux_r, aux_c, aux_v = _stack_aux(shards)
    return ChannelShardPlan(
        shape=(int(shape[0]), int(shape[1])), config=config, spec=spec,
        shards=shards, block_m=block_m, block_k=block_k,
        num_segments_local=num_segments,
        idx=idx, val=val, seg_ids=seg_ids,
        aux_rows=aux_r, aux_cols=aux_c, aux_vals=aux_v,
        row_perm=row_perm)


def balanced_virtual_rows(row_nnz: np.ndarray, lanes: int) -> np.ndarray:
    """LPT lane assignment: row index → virtual row, per block.

    The maxE-SpMV idea specialized to lane-stationary accumulators: walk
    rows in descending nnz; each chunk of ``lanes`` rows goes to the
    currently lightest lanes (heaviest row → lightest lane), so per-lane
    nnz totals equalize instead of following the luck of ``r % lanes``.
    A row's virtual id is ``fill[lane] * lanes + lane``, which keeps every
    lane at most ``ceil(n / lanes)`` rows deep — the same accumulator
    span as the modulo split, so only the *membership* changes, not the
    stream geometry.  Deterministic (stable sorts, ties on row index) and
    injective into ``[0, ceil(n / lanes) * lanes)``.

    O(ceil(n / lanes)) small numpy passes — a few ms per million rows,
    negligible next to the encode's global sort.
    """
    n = int(row_nnz.size)
    virt = np.empty(n, np.int64)
    if n == 0:
        return virt
    order = np.argsort(-np.asarray(row_nnz, np.int64), kind="stable")
    loads = np.zeros(lanes, np.int64)
    fill = np.zeros(lanes, np.int64)
    for s in range(0, n, lanes):
        chunk = order[s:s + lanes]
        lane = np.argsort(loads, kind="stable")[:chunk.size]
        virt[chunk] = fill[lane] * lanes + lane
        loads[lane] += row_nnz[chunk]
        fill[lane] += 1
    return virt


def balanced_row_perm(prep: sformat.PreparedCOO, spec: PlanSpec,
                      block_m: int) -> np.ndarray:
    """Global row → virtual row for ``lane_assign="balanced"``.

    Row partitions permute block-locally (virtual rows stay inside their
    shard's ``[d * block_m, (d+1) * block_m)`` window, so ``shard =
    vrow // block_m`` still holds); col/single plans permute globally.
    """
    m, _ = prep.shape
    lanes = prep.config.lanes
    counts = (np.bincount(prep.rows, minlength=m) if prep.nnz
              else np.zeros(m, np.int64))
    if spec.partition != "row":
        return balanced_virtual_rows(counts, lanes)
    perm = np.empty(m, np.int64)
    for lo in range(0, m, block_m):
        hi = min(lo + block_m, m)
        perm[lo:hi] = lo + balanced_virtual_rows(counts[lo:hi], lanes)
    return perm


def plan_from_prepared(prep: sformat.PreparedCOO,
                       spec: PlanSpec = PlanSpec(), *,
                       n_workers: int = 1,
                       pool=None) -> ChannelShardPlan:
    """Encode a prepared COO into a channel-shard plan via one shared pass.

    All shards come out of a single bucketed ``format._encode_stream`` call
    that reuses the prepared (segment, lane) sort: a ``col``/``single`` plan
    inherits it verbatim (the shard key is a prefix function of the segment
    key) and a ``row`` plan derives its order with one extra stable pass
    over the shard key — never N independent ``encode()`` sorts.

    ``n_workers > 1`` shards that pass by (shard, segment) range over
    worker processes (:mod:`repro_torch.core.parallel_encode`) — bit-identical
    output, useful for 1e7+-nnz matrices on multi-core hosts.  ``pool``
    optionally reuses a persistent
    :class:`~repro_torch.core.parallel_encode.EncodePool`.
    """
    if n_workers > 1 and prep.nnz > 0 and spec.lane_assign == "modulo":
        from repro_torch.core import parallel_encode as penc
        return penc.plan_from_prepared_parallel(
            prep, spec, n_workers=n_workers, pool=pool)
    cfg = prep.config
    m, k = prep.shape
    n = spec.num_shards
    rows, cols, vals = prep.rows, prep.cols, prep.vals

    block_m, block_k = spec_geometry((m, k), cfg, spec)
    if spec.lane_assign == "balanced":
        return _plan_balanced(prep, spec, block_m, block_k)
    if spec.partition == "row":
        # Contiguous row blocks, locally re-indexed (lane-aligned: the lane
        # of a row is invariant under the shard offset).
        shard = rows // block_m
        order = prep.order[np.argsort(shard[prep.order], kind="stable")]
        shards = sformat._encode_stream(
            order, shard, rows - shard * block_m, cols, vals,
            n, (block_m, k), cfg)
    elif spec.partition == "col":
        # Contiguous column (segment) blocks; x shards, partial y's sum.
        shard = cols // block_k
        # block_k is a whole number of segments, so the bucket key and the
        # packed stream word of the prepared sort apply verbatim.
        shards = sformat._encode_stream(
            prep.order, shard, rows, cols - shard * block_k, vals,
            n, (m, block_k), cfg,
            bk_a=prep.bucket_key, pk_a=prep.packed)
    else:  # single
        shards = [sformat.encode_prepared(prep)]
    return finish_plan(shards, (m, k), cfg, spec, block_m, block_k)


def _plan_balanced(prep: sformat.PreparedCOO, spec: PlanSpec,
                   block_m: int, block_k: int) -> ChannelShardPlan:
    """``lane_assign="balanced"`` encode path of :func:`plan_from_prepared`.

    Remaps rows through the LPT permutation, re-runs the (segment, lane,
    lane-local row) bucket sort on *virtual* rows, and encodes with the
    same shared one-pass machinery as the modulo path.  Costs one extra
    O(nnz log nnz) sort versus modulo (the prepared sort is keyed on real
    rows and cannot be reused), which the tuner only pays where the
    padding win justifies it.
    """
    cfg = prep.config
    m, k = prep.shape
    n = spec.num_shards
    lanes = cfg.lanes
    cols, vals = prep.cols, prep.vals
    row_perm = balanced_row_perm(prep, spec, block_m)
    vrows = row_perm[prep.rows]
    if spec.partition == "row":
        # Virtual rows stay block-local, so shard derivation and the
        # lane-alignment argument are identical to the modulo path.
        shard = vrows // block_m
        order0, _, _ = sformat.sort_order(vrows, cols, (n * block_m, k), cfg)
        order = order0[np.argsort(shard[order0], kind="stable")]
        shards = sformat._encode_stream(
            order, shard, vrows - shard * block_m, cols, vals,
            n, (block_m, k), cfg)
    else:
        m_v = -(-m // lanes) * lanes
        order0, bk, pk = sformat.sort_order(vrows, cols, (m_v, k), cfg)
        if spec.partition == "col":
            # Shard key is a prefix of the segment key, so the fresh
            # virtual-row sort is already shard-grouped (as in modulo).
            shard = cols // block_k
            shards = sformat._encode_stream(
                order0, shard, vrows, cols - shard * block_k, vals,
                n, (m_v, block_k), cfg, bk_a=bk, pk_a=pk)
        else:  # single
            shard = np.zeros(vrows.size, np.int64)
            shards = sformat._encode_stream(
                order0, shard, vrows, cols, vals, 1, (m_v, k), cfg,
                bk_a=bk, pk_a=pk)
    return finish_plan(shards, (m, k), cfg, spec, block_m, block_k,
                       row_perm=row_perm)


def plan_apply_delta(
    plan: ChannelShardPlan,
    prep: sformat.PreparedCOO,
    delta_rows=None,
    delta_cols=None,
    delta_vals=None,
    *,
    mode: str = "add",
    merge: sformat.DeltaMerge | None = None,
) -> tuple[ChannelShardPlan, sformat.DeltaMerge, int]:
    """Apply a COO delta to every channel shard of ``plan`` in one pass.

    ``prep`` is the :class:`PreparedCOO` the plan was encoded from (the
    registry keeps it per entry); pass ``merge`` to reuse one
    :meth:`~repro_torch.core.format.PreparedCOO.merge_delta` across several
    plans of the same matrix.  Only the touched (shard, segment) tile
    blocks re-encode — one shared ``_encode_stream`` call over those
    segments' entries across *all* shards, spliced per shard.  The
    *encode* cost scales with the delta's segment footprint; what remains
    O(nnz) is memcpy-level traffic (membership scans, array splices), so
    small column-local deltas run 5-10x faster than a full re-encode, not
    arbitrarily faster.  Returns ``(new_plan, merge, respliced_slots)``;
    the new plan is bit-identical to a cold ``plan_from_prepared`` of the
    post-delta matrix.
    """
    cfg, spec = plan.config, plan.spec
    m, k = plan.shape
    if plan.row_perm is not None:
        raise ValueError(
            "plan_apply_delta does not support lane_assign='balanced' "
            "plans: the LPT lane assignment depends on per-row nnz, which "
            "a delta changes — re-encode via plan_from_prepared")
    if merge is None:
        if prep is None:
            raise ValueError("plan_apply_delta needs the plan's PreparedCOO")
        if prep.shape != (m, k) or prep.config != cfg:
            raise ValueError("prepared COO does not match the plan")
        merge = prep.merge_delta(delta_rows, delta_cols, delta_vals,
                                 mode=mode)
    if merge.is_noop:
        return plan, merge, 0
    new_prep = merge.prepared
    n = spec.num_shards
    w, lanes = cfg.segment_width, cfg.lanes
    nseg_l = plan.num_segments_local
    rows, cols, vals = new_prep.rows, new_prep.cols, new_prep.vals

    def seg_of(c):
        return c >> w.bit_length() - 1 if not w & (w - 1) else c // w

    # Shard-local coordinates of the merged triples and of the touched
    # coordinates (added + displaced entries).
    if spec.partition == "row":
        shard_all = rows // plan.block_m
        rows_loc, cols_loc = rows - shard_all * plan.block_m, cols
        t_shard = merge.touched_rows // plan.block_m
        t_lseg = seg_of(merge.touched_cols)
        pair_all = shard_all * nseg_l + seg_of(cols)
        shape_local = (plan.block_m, k)
        bk_a = pk_a = None           # lane-local rows are shard-local
    elif spec.partition == "col":
        shard_all = cols // plan.block_k
        rows_loc, cols_loc = rows, cols - shard_all * plan.block_k
        t_shard = merge.touched_cols // plan.block_k
        t_lseg = (merge.touched_cols - t_shard * plan.block_k) // w
        pair_all = shard_all * nseg_l + seg_of(cols_loc)
        shape_local = (m, plan.block_k)
        bk_a, pk_a = new_prep.bucket_key, new_prep.packed
    else:
        shard_all = np.zeros(rows.shape, np.int64)
        rows_loc, cols_loc = rows, cols
        t_shard = np.zeros(merge.touched_rows.shape, np.int64)
        t_lseg = seg_of(merge.touched_cols)
        pair_all = seg_of(cols)
        shape_local = (m, k)
        bk_a, pk_a = new_prep.bucket_key, new_prep.packed
    # The splice unit is the (shard, segment) tile block: a segment's
    # lanes share one block and one depth, so a delta touching any
    # (segment, lane) bucket re-encodes that whole segment's entries.
    touched_pairs = np.unique(t_shard * nseg_l + t_lseg)
    sel = np.flatnonzero(
        sformat._member_of_sorted(touched_pairs, pair_all, n * nseg_l))
    slots = 0
    if sel.size:
        s_shard = shard_all[sel]
        s_rows, s_cols, s_vals = rows_loc[sel], cols_loc[sel], vals[sel]
        rs = -(-shape_local[0] // lanes)
        skey = (((s_shard * nseg_l + s_cols // w) * lanes + s_rows % lanes)
                * np.int64(rs) + s_rows // lanes)
        minis = sformat._encode_stream(
            np.argsort(skey, kind="stable"), s_shard, s_rows, s_cols,
            s_vals, n, shape_local, cfg,
            bk_a=None if bk_a is None else bk_a[sel],
            pk_a=None if pk_a is None else pk_a[sel])
    else:
        minis = [None] * n

    if n == 1:
        nnz_shard = np.array([rows.size], np.int64)
    else:
        nnz_shard = (np.bincount(shard_all, minlength=n) if rows.size
                     else np.zeros(n, np.int64))
    new_shards = []
    for d in range(n):
        segs_d = np.unique(t_lseg[t_shard == d])
        if segs_d.size == 0:
            new_shards.append(plan.shards[d])   # untouched shard, shared
            continue
        mini = minis[d]
        if mini is not None and mini.nnz - mini.n_aux > 0:
            slots += int(mini.idx.size)
        new_shards.append(sformat.splice_encoded(
            plan.shards[d], mini, segs_d, int(nnz_shard[d])))
    idx, val, seg_ids = _pad_stack(new_shards)
    aux_r, aux_c, aux_v = _stack_aux(new_shards)
    return ChannelShardPlan(
        shape=(m, k), config=cfg, spec=spec, shards=new_shards,
        block_m=plan.block_m, block_k=plan.block_k,
        num_segments_local=nseg_l,
        idx=idx, val=val, seg_ids=seg_ids,
        aux_rows=aux_r, aux_cols=aux_c, aux_vals=aux_v), merge, slots


def make_plan(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    shape: tuple[int, int],
    config: sformat.SerpensConfig = sformat.SerpensConfig(),
    spec: PlanSpec = PlanSpec(),
    *,
    prepared: sformat.PreparedCOO | None = None,
    n_workers: int = 1,
    pool=None,
) -> ChannelShardPlan:
    """Split a COO matrix into a channel-shard plan and encode every shard.

    Pass ``prepared`` (from :func:`repro_torch.core.format.prepare`) to skip
    validation and reuse its global (segment, lane) sort — how the registry
    repartitions a cached matrix without re-sorting from scratch.

    ``n_workers > 1`` runs the bucket sort *and* the stream encode sharded
    by (shard, segment) range over worker processes
    (:mod:`repro_torch.core.parallel_encode`); the result is bit-identical to the
    serial encode.
    """
    if prepared is None:
        if n_workers > 1:
            from repro_torch.core import parallel_encode as penc
            _, plan = penc.prepare_and_plan(
                rows, cols, vals, shape, config, spec,
                n_workers=n_workers, pool=pool, want_prepared=False)
            return plan
        prepared = sformat.prepare(rows, cols, vals, shape, config)
    elif (prepared.shape != (int(shape[0]), int(shape[1]))
          or prepared.config != config):
        raise ValueError("prepared COO does not match shape/config")
    return plan_from_prepared(prepared, spec, n_workers=n_workers,
                              pool=pool)
