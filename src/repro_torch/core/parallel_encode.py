"""Parallel multi-process encode: the bucket sort sharded by segment range.

The vectorized encode pipeline (:mod:`repro_torch.core.format`) is a handful of
O(nnz) numpy passes, but one process still bottlenecks cold starts on
1e8+-nnz corpora — the serving tier's registry miss is exactly this encode.
This module spreads it over worker processes using the same structural fact
the incremental-update splice exploits (``format.splice_encoded``): the
Serpens stream is a concatenation of per-(shard, segment) tile blocks, each
self-contained (its depth, spill selection and RAW schedule derive from that
segment's entries alone).  Therefore:

  1. the parent buckets entries by *pair* id — ``shard * S + segment``, the
     splice unit's address — and cuts pair space into contiguous ranges of
     roughly equal nnz;
  2. each worker stable-sorts its range locally (ranges are contiguous in
     the global (shard, segment, lane, row) key space, and the partition
     preserves input order, so concatenated local sorts ARE the global
     bucket sort) and encodes it with the shared ``format._encode_stream``
     pass — the exact machinery ``partition.plan_apply_delta`` uses for
     delta re-encodes;
  3. the parent splices the returned tile blocks back together, per shard,
     in range order.

The result is **bit-identical** to a serial encode — property-tested in
``tests/test_parallel_encode_properties.py`` and re-verified in every
``benchmarks/encode_parallel.py`` sweep.

Two transfer modes, chosen automatically:

* **fork + copy-on-write** (preferred; used when the ``fork`` start method
  exists and torch has not been imported): the parent stashes its arrays in
  a module global and forks an ephemeral pool; children inherit the arrays
  for free and select their range themselves.  Never used once torch is
  loaded (forking a process with live torch threads or a CUDA context is
  not safe).
* **pickled args** (portable; used with a persistent :class:`EncodePool`,
  e.g. by ``MatrixRegistry``): the parent pre-partitions entries by range
  and ships each worker its slice.  Spawned workers import only numpy +
  ``repro_torch.core.format`` — never torch.

Speedup is bounded by physical cores and memory bandwidth: the pipeline is
memory-bound, so expect ~linear scaling up to the core count on dedicated
hosts and less under contention.  ``benchmarks/encode_parallel.py`` records
``cpu_count`` next to every measurement for exactly this reason.
"""
from __future__ import annotations

import multiprocessing as mp
import sys
import threading
import time

import numpy as np

from repro_torch.core import format as sformat
from repro_torch.core import partition as cpart

# NOTE: this module is imported by spawned worker processes, so it must
# never import torch — `repro_torch.obs` is safe (pure stdlib) and imported lazily
# on the parent side only (inside _run_tasks) to keep the worker import
# footprint minimal.

# Module-global handoff for the fork/copy-on-write path.  Set (under
# _COW_LOCK) immediately before an ephemeral fork pool starts, so children
# inherit the arrays without any serialization; cleared right after.
_COW: dict = {}
_COW_LOCK = threading.Lock()

# Pair-space ranges per worker: a few tasks per worker lets the pool
# load-balance segments whose schedule cost exceeds their nnz share
# (power-law hot segments), at negligible per-task overhead.
TASKS_PER_WORKER = 4


def _fork_cow_ok() -> bool:
    """Fork + COW is usable: fork exists and torch is not loaded here."""
    return ("fork" in mp.get_all_start_methods()
            and "torch" not in sys.modules)


def default_start_method() -> str:
    """``fork`` when safe in this process, else ``spawn``.

    torch spins up thread pools (and, on a card, a CUDA context) that do
    not survive ``fork``; once it is imported anywhere in the process,
    worker pools must ``spawn``.
    """
    return "fork" if _fork_cow_ok() else "spawn"


class EncodePool:
    """A persistent worker pool for parallel encodes.

    Workers are plain ``multiprocessing`` processes that import only numpy
    and :mod:`repro_torch.core.format` — never torch — so the pool is safe to
    hold next to a live torch runtime (start method auto-resolves to
    ``spawn`` there).  The pool starts lazily on first use; ``close()`` (or the
    context manager) tears it down.
    """

    def __init__(self, n_workers: int, start_method: str | None = None):
        if n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        self.n_workers = int(n_workers)
        self._method = start_method
        self._pool = None
        self._lock = threading.Lock()

    @property
    def start_method(self) -> str:
        return self._method or default_start_method()

    def _ensure(self):
        with self._lock:
            if self._pool is None:
                ctx = mp.get_context(self.start_method)
                self._pool = ctx.Pool(self.n_workers)
            return self._pool

    def map(self, tasks):
        return self._ensure().map(_encode_range_task, tasks, chunksize=1)

    def close(self) -> None:
        with self._lock:
            if self._pool is not None:
                self._pool.terminate()
                # Teardown path: holding the lock across the join is the
                # point — _ensure must not race a new pool into existence
                # while the old workers drain.
                self._pool.join()  # repro-lint: disable=lock-blocking-call
                self._pool = None

    def __enter__(self) -> "EncodePool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# Worker side (runs in child processes; numpy only).
# ---------------------------------------------------------------------------

def _local_sort_key(rows_loc, cols_loc, shard, n_shards: int,
                    shape_local, config: sformat.SerpensConfig):
    """Per-entry sort key matching :func:`format.prepare`'s ordering,
    extended shard-major for multi-shard plans — the same composite key
    ``partition.plan_apply_delta`` sorts its re-encoded entries by."""
    m_l, k_l = shape_local
    w, lanes = config.segment_width, config.lanes
    nseg_l = max(1, -(-k_l // w))
    row_span = -(-m_l // lanes)
    rows_loc = np.asarray(rows_loc, np.int64)
    cols_loc = np.asarray(cols_loc, np.int64)
    seg = sformat.seg_of(cols_loc, w)
    lane, rr = sformat.lane_split(rows_loc, lanes)
    bkey = seg * lanes + lane
    if n_shards > 1:
        bkey = bkey + np.asarray(shard, np.int64) * (nseg_l * lanes)
    return bkey * row_span + rr


def _encode_range_task(task):
    """Encode one (shard, segment)-range of entries into tile blocks.

    Runs in a worker process.  ``task`` is ``(data, n_shards, shape_local,
    config, is_sorted, want_order, sort_only)`` where ``data`` selects the
    entries:

    * ``("cow", lo, hi)`` — the parent's module-global ``_COW`` arrays
      (inherited copy-on-write under the fork start method).  With
      ``is_sorted`` the bounds slice ``_COW["order"]``; otherwise they
      bound *pair* ids and the worker selects ``_COW["pair"]`` entries,
      which keeps them in input order.
    * ``("arr", rows_loc, cols_loc, vals, shard, bk, pk)`` — the range's
      entries pre-partitioned and shipped by the parent (portable path).

    Returns ``(blocks, order, seconds)``: per-shard tile/aux blocks
    (``None`` for shards with no entries in range; stream arrays ``None``
    when every entry spilled); when ``want_order``, the entry order —
    global input indices in the cow path, range-local positions in the
    args path (the parent maps them through its partition permutation);
    and the worker's wall-time for this range, which the parent replays
    into the trace (perf_counter is not comparable across processes, so
    only the *duration* ships home).
    """
    t0 = time.perf_counter()
    (data, n_shards, shape_local, config, is_sorted, want_order,
     sort_only) = task
    if data[0] == "cow":
        _, lo, hi = data
        shared = _COW
        if is_sorted:
            sel = shared["order"][lo:hi]
        else:
            pair = shared["pair"]
            sel = np.flatnonzero((pair >= lo) & (pair < hi))
        rows = shared["rows"][sel]
        cols = shared["cols"][sel]
        vals = shared["vals"][sel]
        shard = None if shared["shard"] is None else shared["shard"][sel]
        bk = None if shared["bk"] is None else shared["bk"][sel]
        pk = None if shared["pk"] is None else shared["pk"][sel]
    else:
        _, rows, cols, vals, shard, bk, pk = data
        sel = None
    n = int(rows.size)
    if n == 0:
        return None
    if is_sorted:
        order = np.arange(n, dtype=np.int64)
    else:
        key = _local_sort_key(rows, cols, shard, n_shards, shape_local,
                              config)
        order = np.argsort(key, kind="stable")
    ret_order = None
    if want_order:
        ret_order = sel[order] if sel is not None else order
    if sort_only:
        return None, ret_order, time.perf_counter() - t0
    shard_a = np.zeros(n, np.int64) if shard is None else shard
    mats = sformat._encode_stream(order, shard_a, rows, cols, vals,
                                  n_shards, shape_local, config,
                                  bk_a=bk, pk_a=pk)
    blocks = []
    for sm in mats:
        if sm.nnz == 0:
            blocks.append(None)     # placeholder null stream: no entries
            continue
        kept = sm.nnz - sm.n_aux
        blocks.append((sm.idx if kept > 0 else None,
                       sm.val if kept > 0 else None,
                       sm.seg_ids if kept > 0 else None,
                       sm.aux_rows, sm.aux_cols, sm.aux_vals, sm.nnz))
    return blocks, ret_order, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# Parent side.
# ---------------------------------------------------------------------------

def _shard_coords(rows, cols, shape, config, spec, block_m, block_k):
    """(shard, rows_loc, cols_loc, pair, n_pairs, shape_local).

    ``pair`` is the (shard, local segment) id — ``shard * S + seg``, the
    splice-unit address — numbered shard-major so contiguous pair ranges
    are contiguous runs of both the sorted entry order and the encoded
    stream.  ``shard`` is ``None`` for single plans.
    """
    m, k = int(shape[0]), int(shape[1])
    w = config.segment_width
    seg = sformat.seg_of(cols, w)
    if spec.partition == "row":
        nseg = max(1, -(-k // w))
        shard = rows // block_m
        return (shard, rows - shard * block_m, cols,
                shard * nseg + seg, spec.num_shards * nseg, (block_m, k))
    if spec.partition == "col":
        nseg_l = block_k // w
        shard = cols // block_k
        # block_k is a whole number of segments: the global segment id IS
        # shard * S_local + local segment.
        return (shard, rows, cols - shard * block_k,
                seg, spec.num_shards * nseg_l, (m, block_k))
    return None, rows, cols, seg, max(1, -(-k // w)), (m, k)


def _range_bounds(counts, n_ranges: int):
    """Cut pair space into ≤ ``n_ranges`` contiguous ranges of ~equal nnz
    (empty ranges dropped)."""
    n_pairs = int(counts.size)
    if n_ranges <= 1 or n_pairs <= 1:
        return [(0, n_pairs)]
    cum = np.cumsum(counts, dtype=np.int64)
    total = int(cum[-1])
    if total == 0:
        return [(0, n_pairs)]
    targets = (total * np.arange(1, n_ranges, dtype=np.int64)) // n_ranges
    cuts = np.searchsorted(cum, targets, side="left") + 1
    bounds = np.unique(np.concatenate([[0], cuts, [n_pairs]]))
    out = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        size = int(cum[hi - 1]) - (int(cum[lo - 1]) if lo else 0)
        if size > 0:
            out.append((int(lo), int(hi)))
    return out or [(0, n_pairs)]


def _narrow(a, bound: int, dtype=np.int32):
    """Cast to ``dtype`` when every value fits (cuts transfer bytes)."""
    if a is None:
        return None
    return a.astype(dtype) if bound < np.iinfo(dtype).max else a


def _run_tasks(build_task, bounds, n_workers, pool, cow):
    """Dispatch range tasks; returns the workers' outputs in range order.

    ``build_task(i, lo, hi)`` builds the i-th task from its bounds (the
    caller supplies pair bounds or entry bounds as its transfer mode
    needs).  ``cow`` — the module-global array dict for the fork path —
    must be ``None`` for the portable pickled-args path.
    """
    from repro_torch import obs
    tasks = [build_task(i, *bounds[i]) for i in range(len(bounds))]
    with obs.span("encode-fanout", cat="encode", ranges=len(tasks),
                  workers=n_workers,
                  mode=("pool" if pool is not None
                        else "cow" if cow is not None else "spawn")):
        if pool is not None:
            outs = pool.map(tasks)
        elif cow is not None:
            with _COW_LOCK:
                global _COW
                _COW = cow
                try:
                    with mp.get_context("fork").Pool(n_workers) as p:
                        outs = p.map(_encode_range_task, tasks,
                                     chunksize=1)
                finally:
                    _COW = {}
        else:
            with EncodePool(n_workers, "spawn") as p:
                outs = p.map(tasks)
        if obs.is_enabled():
            # Replay each worker's measured wall-time as a trace span:
            # real duration, end-anchored here (cross-process clocks are
            # not comparable, so placement is approximate by design).
            for i, out in enumerate(outs):
                if out is not None:
                    obs.event("encode-range", out[2], cat="encode",
                              range=i)
    return outs


def _parallel_encode(rows, cols, vals, shape, config, spec, *,
                     n_workers: int, pool=None, order=None,
                     want_order: bool = False, sort_only: bool = False):
    """The shared parent pipeline: partition by pair range, dispatch, and
    splice.  ``rows``/``cols``/``vals`` must already be validated
    (``format._validate_coo``).  ``order`` — a full presorted entry order
    (shard-major for row plans) — skips the workers' local sorts.

    Returns ``(plan | None, global_order | None)``; the plan is ``None``
    for ``sort_only`` rounds, the order is ``None`` unless ``want_order``
    (in which case it is bit-identical to the serial sort's).
    """
    m, k = int(shape[0]), int(shape[1])
    block_m, block_k = cpart.spec_geometry(shape, config, spec)
    n_shards = spec.num_shards
    (shard, rows_loc, cols_loc, pair, n_pairs,
     shape_local) = _shard_coords(rows, cols, shape, config, spec,
                                  block_m, block_k)
    sformat._check_row_capacity(shape_local[0], config)
    counts = np.bincount(pair, minlength=n_pairs)
    ranges = _range_bounds(counts, n_workers * TASKS_PER_WORKER)
    ecum = np.concatenate([[0], np.cumsum(counts, dtype=np.int64)])
    entry_bounds = [(int(ecum[lo]), int(ecum[hi])) for lo, hi in ranges]
    is_sorted = order is not None

    use_cow = pool is None and _fork_cow_ok()
    bk = pk = None
    if spec.partition != "row":
        # Global bucket/packed words apply verbatim to single and col
        # plans (see partition.plan_from_prepared); row shards rebuild
        # them shard-locally inside _encode_stream.
        bk, pk, _ = sformat._key_arrays(rows, cols, (m, k), config)
    if use_cow:
        cow = {"rows": rows_loc, "cols": cols_loc, "vals": vals,
               "shard": shard, "bk": bk, "pk": pk,
               "pair": pair, "order": order}
        # Sorted entries slice `order` directly (entry bounds); unsorted
        # workers select their own pair range from the full arrays.
        bounds = entry_bounds if is_sorted else ranges

        def build_task(i, lo, hi):
            return (("cow", lo, hi), n_shards, shape_local, config,
                    is_sorted, want_order, sort_only)
    else:
        cow = None
        bounds = entry_bounds
        # Pre-partition once: contiguous in the sorted order when we have
        # one; else one stable pair-bucketing pass (radix — preserves
        # input order inside each pair, which the spill selection and the
        # want_order reconstruction both rely on).
        perm = order if is_sorted else np.argsort(pair, kind="stable")

        def build_task(i, lo, hi):
            sel = perm[lo:hi]
            return (("arr",
                     _narrow(rows_loc[sel], shape_local[0]),
                     _narrow(cols_loc[sel], shape_local[1]),
                     vals[sel],
                     None if shard is None else _narrow(shard[sel],
                                                        n_shards),
                     None if bk is None else bk[sel],
                     None if pk is None else pk[sel]),
                    n_shards, shape_local, config, is_sorted,
                    want_order and not is_sorted, sort_only)

    outs = _run_tasks(build_task, bounds, n_workers, pool, cow)

    global_order = None
    if want_order:
        if is_sorted:
            global_order = order
        else:
            parts = []
            for (lo, hi), out in zip(entry_bounds, outs):
                if out is None:
                    continue
                local = out[1]
                parts.append(local if use_cow else perm[lo:hi][local])
            global_order = (np.concatenate(parts) if parts
                            else np.zeros((0,), np.int64))
    if sort_only:
        return None, global_order

    # ---- splice the returned tile blocks, per shard, in range order ----
    if shard is None:
        nnz_shard = np.array([rows_loc.size], np.int64)
    else:
        nnz_shard = (np.bincount(shard, minlength=n_shards)
                     if rows_loc.size else np.zeros(n_shards, np.int64))
    nseg_local = max(1, -(-shape_local[1] // config.segment_width))
    shards_out = []
    for d in range(n_shards):
        idx_p, val_p, seg_p = [], [], []
        aux_r, aux_c, aux_v = [], [], []
        for out in outs:
            if out is None or out[0] is None:
                continue
            blk = out[0][d]
            if blk is None:
                continue
            bidx, bval, bseg, ar, ac, av, _ = blk
            if bidx is not None:
                idx_p.append(bidx)
                val_p.append(bval)
                seg_p.append(bseg)
            if ar.size:
                aux_r.append(ar)
                aux_c.append(ac)
                aux_v.append(av)
        if idx_p:
            idx = np.concatenate(idx_p)
            val = np.concatenate(val_p)
            seg_ids = np.concatenate(seg_p)
        else:                       # no live stream entries: null chunk
            idx = np.full((config.tiles_per_chunk, config.sublanes,
                           config.lanes), sformat.SENTINEL, np.int32)
            val = np.zeros(idx.shape, config.np_value_dtype)
            seg_ids = np.zeros((config.tiles_per_chunk,), np.int32)
        shards_out.append(sformat.SerpensMatrix(
            shape=shape_local, nnz=int(nnz_shard[d]), config=config,
            idx=idx, val=val, seg_ids=seg_ids, num_segments=nseg_local,
            aux_rows=(np.concatenate(aux_r) if aux_r
                      else sformat._empty_i32()),
            aux_cols=(np.concatenate(aux_c) if aux_c
                      else sformat._empty_i32()),
            aux_vals=(np.concatenate(aux_v) if aux_v
                      else sformat._empty_f32())))
    plan = cpart.finish_plan(shards_out, (m, k), config, spec,
                             block_m, block_k)
    return plan, global_order


# ---------------------------------------------------------------------------
# Public API.
# ---------------------------------------------------------------------------

def prepare_parallel(rows, cols, vals, shape,
                     config: sformat.SerpensConfig = sformat.SerpensConfig(),
                     *, n_workers: int, pool=None) -> sformat.PreparedCOO:
    """Parallel :func:`format.prepare`: the global bucket sort sharded by
    segment range over worker processes.  Bit-identical result (order,
    bucket_key, packed)."""
    rows, cols, vals = sformat._validate_coo(rows, cols, vals, shape,
                                             config)
    m, k = int(shape[0]), int(shape[1])
    bk, pk, _ = sformat._key_arrays(rows, cols, (m, k), config)
    if n_workers <= 1 or rows.size == 0 or bk is None:
        # Serial fallback (incl. the huge-geometry int64/lexsort paths).
        return sformat.prepare(rows, cols, vals, (m, k), config)
    _, order = _parallel_encode(rows, cols, vals, (m, k), config,
                                cpart.PlanSpec(), n_workers=n_workers,
                                pool=pool, want_order=True,
                                sort_only=True)
    return sformat.PreparedCOO(shape=(m, k), config=config, rows=rows,
                               cols=cols, vals=vals, order=order,
                               bucket_key=bk, packed=pk)


def plan_from_prepared_parallel(prep: sformat.PreparedCOO,
                                spec: cpart.PlanSpec = cpart.PlanSpec(),
                                *, n_workers: int,
                                pool=None) -> cpart.ChannelShardPlan:
    """Parallel ``partition.plan_from_prepared``: reuses the prepared sort
    (one extra stable shard pass for row plans) and spreads the stream
    encode over worker processes.  Bit-identical plan.

    ``lane_balance`` configs cannot ship pre-sorted entries — that spill
    pass caps each lane by *input-order* rank within its bucket, which a
    gathered sorted slice no longer encodes — so their workers re-sort
    their ranges locally (same result, one extra parallel radix pass).
    """
    if n_workers <= 1 or prep.nnz == 0:
        return cpart.plan_from_prepared(prep, spec)
    order = None
    if not prep.config.lane_balance:
        if spec.partition == "row":
            block_m, _ = cpart.spec_geometry(prep.shape, prep.config,
                                             spec)
            shard = prep.rows // block_m
            order = prep.order[np.argsort(shard[prep.order],
                                          kind="stable")]
        else:
            order = prep.order
    plan, _ = _parallel_encode(prep.rows, prep.cols, prep.vals,
                               prep.shape, prep.config, spec,
                               n_workers=n_workers, pool=pool,
                               order=order)
    return plan


def prepare_and_plan(rows, cols, vals, shape,
                     config: sformat.SerpensConfig = sformat.SerpensConfig(),
                     spec: cpart.PlanSpec = cpart.PlanSpec(), *,
                     n_workers: int = 1, pool=None,
                     want_prepared: bool = True):
    """One-shot sort + encode — the registry's cold-start path.

    Returns ``(prepared | None, plan)``.  With ``n_workers > 1`` both the
    bucket sort and the stream encode run range-sharded over worker
    processes in a *single* round: workers sort and encode their range,
    and the parent reassembles the global order (for the returned
    :class:`~repro_torch.core.format.PreparedCOO`) alongside the spliced plan.
    Row-partitioned plans with ``want_prepared`` sort serially (their
    shard-major encode order differs from ``prepare``'s) and only the
    encode parallelizes.
    """
    if n_workers <= 1 or np.asarray(rows).size == 0:
        prep = sformat.prepare(rows, cols, vals, shape, config)
        return (prep if want_prepared else None,
                cpart.plan_from_prepared(prep, spec))
    rows, cols, vals = sformat._validate_coo(rows, cols, vals, shape,
                                             config)
    m, k = int(shape[0]), int(shape[1])
    bk, pk, _ = sformat._key_arrays(rows, cols, (m, k), config)
    if bk is None:                  # huge-geometry fallbacks: serial sort
        prep = sformat.prepare(rows, cols, vals, (m, k), config)
        return (prep if want_prepared else None,
                plan_from_prepared_parallel(prep, spec,
                                            n_workers=n_workers,
                                            pool=pool))
    if spec.partition == "row" and want_prepared:
        prep = sformat.prepare(rows, cols, vals, (m, k), config)
        return prep, plan_from_prepared_parallel(prep, spec,
                                                 n_workers=n_workers,
                                                 pool=pool)
    plan, order = _parallel_encode(rows, cols, vals, (m, k), config,
                                   spec, n_workers=n_workers, pool=pool,
                                   want_order=want_prepared)
    prep = None
    if want_prepared:
        prep = sformat.PreparedCOO(shape=(m, k), config=config,
                                   rows=rows, cols=cols, vals=vals,
                                   order=order, bucket_key=bk, packed=pk)
    return prep, plan


def encode_parallel(rows, cols, vals, shape,
                    config: sformat.SerpensConfig = sformat.SerpensConfig(),
                    *, n_workers: int, pool=None) -> sformat.SerpensMatrix:
    """Parallel :func:`format.encode` (single-shard stream), bit-identical
    to the serial encode."""
    _, plan = prepare_and_plan(rows, cols, vals, shape, config,
                               cpart.PlanSpec(), n_workers=n_workers,
                               pool=pool, want_prepared=False)
    return plan.shards[0]
