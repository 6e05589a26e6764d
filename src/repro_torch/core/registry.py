"""Content-addressed cache of encoded channel-shard plans — the serving
tier's matrix store.

The paper's format conversion (``format.encode``) is the expensive host-side
step: per-lane scheduling over every segment.  A serving system that re-ran
it per request would be bottlenecked on preprocessing, not on the
accelerator.  ``MatrixRegistry`` amortizes it: matrices are keyed by a
content hash of their COO triples + geometry (Serpens config *and*
partition spec — a 4-shard row plan is a different stream layout than a
single-shard one), encoded exactly once into a
:class:`~repro_torch.core.partition.ChannelShardPlan`, and kept resident until a
byte-budget LRU evicts them.  ``get`` hands back a ready-to-run
:class:`~repro_torch.core.spmv.SerpensOperator` bound to the registry's
device (CUDA unless the caller asks for the CPU), cached per entry.

``put(spec="auto")`` hands the plan to a shared
:class:`~repro_torch.core.autotune.PlanTuner` that ranks candidates by the
matrix's structural features and learns from dispatch observations
(``record_observation``/``retune``).  Not ported yet: ``verify`` other
than ``"off"`` (the stream verifier, which raises
``NotImplementedError``).  There are no mesh bindings.

This mirrors the deployment model of HBM SpMV accelerators (Serpens,
Parravicini et al.'s Top-K SpMV): the sparse matrix is *resident* on the
device and many vectors stream against it.
"""
from __future__ import annotations

import dataclasses
import hashlib
import logging
import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from repro_torch import obs
from repro_torch.core import format as sformat
from repro_torch.core import parallel_encode as penc
from repro_torch.core import partition as cpart
from repro_torch.core.autotune import PlanTuner
from repro_torch.core.features import features_of
from repro_torch.core.spmv import SerpensOperator
from repro_torch.kernels import ops as kops

log = logging.getLogger("repro_torch.registry")


def content_key(rows, cols, vals, shape, config: sformat.SerpensConfig,
                spec: cpart.PlanSpec | str = cpart.PlanSpec()) -> str:
    """Deterministic id for (COO triples, shape, geometry, partition).

    Element *order* is part of the key: duplicates are legal in COO and the
    stream layout depends on input order, so two orderings are two streams.
    ``spec="auto"`` keys the *request* ("tuner's choice"), not whatever
    geometry the tuner picks — a repeat auto put is a hit even after an
    online retune swapped the underlying plan.
    """
    h = hashlib.sha256()
    spec_id = ("auto",) if spec == "auto" else (
        spec.partition, spec.num_shards, spec.lane_assign)
    h.update(repr((tuple(int(s) for s in shape), config,
                   spec_id)).encode())
    for arr, dt in ((rows, np.int64), (cols, np.int64), (vals, np.float32)):
        a = np.ascontiguousarray(np.asarray(arr, dtype=dt))
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def stream_key(plan: cpart.ChannelShardPlan) -> str:
    """Deterministic id for an already-encoded plan (``put_operator``).

    Keyed on the stacked stream arrays themselves, so it lives in a
    different id namespace than :func:`content_key` (prefix ``s``): entries
    adopted via ``put_operator`` dedupe against each other, not against
    ``put`` entries.
    """
    h = hashlib.sha256()
    h.update(repr((tuple(int(x) for x in plan.shape), plan.config,
                   (plan.spec.partition, plan.spec.num_shards,
                    plan.spec.lane_assign))).encode())
    for a in (plan.idx, plan.val, plan.seg_ids):
        h.update(np.ascontiguousarray(a).tobytes())
    if plan.n_aux:
        for a in (plan.aux_rows, plan.aux_cols, plan.aux_vals):
            h.update(np.ascontiguousarray(a).tobytes())
    if plan.row_perm is not None:
        h.update(np.ascontiguousarray(plan.row_perm).tobytes())
    return "s" + h.hexdigest()[:15]


def delta_key(parent: str, mode: str, rows, cols, vals) -> str:
    """Content-chain hash: the post-update version id of an entry derives
    from its parent content hash plus the delta, so every version in an
    update lineage is content-addressed (same base + same deltas in the
    same order ⇒ same id)."""
    h = hashlib.sha256()
    h.update(repr((parent, mode)).encode())
    for arr, dt in ((rows, np.int64), (cols, np.int64), (vals, np.float32)):
        a = np.asarray([] if arr is None else arr, dtype=dt)
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


@dataclasses.dataclass
class RegistryStats:
    hits: int = 0
    misses: int = 0
    encodes: int = 0
    evictions: int = 0
    encode_seconds: float = 0.0
    encode_slots: int = 0           # stream slots produced by all encodes
    delta_encodes: int = 0          # incremental update() re-encodes
    delta_seconds: float = 0.0
    delta_slots: int = 0            # stream slots respliced by updates
    prepared_drops: int = 0         # PreparedCOO dropped under byte pressure
    bindings_dropped: int = 0       # bindings shed under byte pressure
    background_puts: int = 0        # put(blocking=False) encodes completed
    queue_seconds: float = 0.0      # background submit -> encode-start wait
    device_bytes_in_use: int = 0    # bound-operator bytes (stats_snapshot)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    @property
    def encode_slots_per_s(self) -> float:
        """Aggregate encode throughput (stream slots / wall second)."""
        return (self.encode_slots / self.encode_seconds
                if self.encode_seconds else 0.0)

    @property
    def delta_slots_per_s(self) -> float:
        """Aggregate incremental re-encode throughput (respliced stream
        slots / wall second of update() encode time)."""
        return (self.delta_slots / self.delta_seconds
                if self.delta_seconds else 0.0)


@dataclasses.dataclass
class _Entry:
    content: str                    # content hash — detects id reuse
    primary: cpart.PlanSpec         # geometry the entry was put with
    backend: str                    # backend chosen at put time
    plans: dict                     # PlanSpec -> ChannelShardPlan
    ops: dict                       # PlanSpec -> operator on the device
    # Prepared COO (validated triples + global (segment, lane) sort) kept so
    # a repartition to a new geometry reuses the bucketing instead of
    # decoding the stream and re-sorting from scratch.  None for entries
    # adopted via put_operator (their input order is unknown).
    prepared: object = None
    encode_seconds: float = 0.0     # host wall-time spent encoding this entry
    encode_slots: int = 0           # stream slots those encodes produced
    queue_seconds: float = 0.0      # background-put queue wait (0 if sync)
    version: int = 0                # bumped by every update() on this entry
    delta_encodes: int = 0          # incremental updates applied
    delta_seconds: float = 0.0      # wall-time of those incremental encodes
    delta_slots: int = 0            # stream slots respliced by them
    # spec="auto" entries: the TuneDecision behind the current plan, and
    # the caller's un-overridden config so a retune re-applies the next
    # candidate's overrides from the same base.  None for manual entries.
    tune: object = None
    base_config: object = None

    @property
    def stream_bytes(self) -> int:
        return sum(p.stream_bytes for p in self.plans.values())

    @property
    def prepared_bytes(self) -> int:
        """Host bytes of the resident PreparedCOO (0 once dropped)."""
        return 0 if self.prepared is None else int(self.prepared.nbytes)

    @property
    def device_bytes(self) -> int:
        """Device buffer bytes held by this entry's cached operator
        bindings (every plan an operator was built for keeps its streams
        resident on device)."""
        return sum(op.device_bytes for op in self.ops.values())

    @property
    def total_bytes(self) -> int:
        """What the byte budget charges: encoded streams + prepared COO
        + device buffers of cached operator bindings."""
        return self.stream_bytes + self.prepared_bytes + self.device_bytes

    @property
    def encode_slots_per_s(self) -> float:
        return (self.encode_slots / self.encode_seconds
                if self.encode_seconds else 0.0)

    @property
    def delta_slots_per_s(self) -> float:
        return (self.delta_slots / self.delta_seconds
                if self.delta_seconds else 0.0)


@dataclasses.dataclass
class _PendingEncode:
    """A put(blocking=False) whose encode has not installed an entry yet."""

    content: str                    # content key the job will install
    shape: tuple[int, int]
    submit_time: float              # perf_counter at put()
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    error: BaseException | None = None
    cancelled: bool = False         # evicted/replaced before install
    # on_ready() callbacks waiting for this encode to settle.  Fired
    # exactly once (outside the registry lock) when the job finishes —
    # whether it installed, failed, or was cancelled mid-flight — so an
    # event-driven consumer (the serving pipeline's parked requests)
    # never has to poll ready().
    listeners: list = dataclasses.field(default_factory=list)
    settled: bool = False           # listeners drained; late adds fire now


def _check_verify(verify: str) -> None:
    if verify not in ("full", "fast", "off"):
        raise ValueError(
            f"verify must be 'full', 'fast' or 'off', got {verify!r}")
    if verify != "off":
        raise NotImplementedError(
            "stream verification needs the analysis package, which waits "
            "for a later slice of the port; use verify='off'")


class MatrixRegistry:
    """LRU cache of ready-to-run channel-shard plans, bounded by bytes.

    ``byte_budget`` caps the total bytes an entry keeps resident: the
    encoded streams (``stream_bytes`` — the off-chip footprint the paper's
    bandwidth model is written in), the entry's ``PreparedCOO`` arrays
    (triples + bucket sort), which for low-padding matrices exceed the
    stream itself, *and* the device buffers of cached operator
    bindings (``device_bytes_in_use``).  When an insert pushes the total
    over budget, pressure is shed in three stages: cached bindings of
    least-recently-used entries are dropped first (device memory released;
    the next ``get`` re-binds), then prepared arrays (the entry still
    serves; repartition/update degrade to the decode-and-re-encode path),
    then whole LRU entries are evicted — except the entry being inserted,
    so a single over-budget matrix still serves (with a warning in the
    stats via ``over_budget``).

    ``n_workers > 1`` encodes matrices with ≥ ``min_parallel_nnz``
    non-zeros range-sharded over a process pool (bit-identical streams;
    see :mod:`repro_torch.core.parallel_encode`), and ``put(blocking=False)``
    runs any encode on a background thread so the serving tier never
    stalls a dispatcher on a registry miss.

    Every binding lives on ``device`` (default CUDA; ``device="cpu"``
    runs the plain PyTorch path).  Without a card, asking for CUDA raises.
    """

    def __init__(self, byte_budget: int = 1 << 31,
                 config: sformat.SerpensConfig = sformat.SerpensConfig(),
                 backend: str = "auto", *, device=None, n_workers: int = 1,
                 encode_pool: penc.EncodePool | None = None,
                 min_parallel_nnz: int = 1 << 21,
                 background_threads: int = 2,
                 tuner=None, verify: str = "off"):
        if byte_budget <= 0:
            raise ValueError("byte_budget must be positive")
        _check_verify(verify)
        self.byte_budget = int(byte_budget)
        self.default_config = config
        self.device = kops.resolve_device(device)
        self.default_backend = kops.resolve_backend(backend, self.device)
        # Auto-tuning (put(spec="auto")): shared PlanTuner, created on
        # first use when not injected.  An injected tuner's arms must run
        # on this registry's device.
        if tuner is not None:
            kops.resolve_backend(tuner.backend, self.device)
        self.tuner = tuner
        # Parallel encode: matrices with >= min_parallel_nnz non-zeros
        # encode range-sharded over n_workers processes (below that the
        # in-process pipeline wins — see README "Parallel encode").
        self.n_workers = max(1, int(n_workers))
        self.min_parallel_nnz = int(min_parallel_nnz)
        self._pool = encode_pool
        self._owns_pool = encode_pool is None
        # Background (put(blocking=False)) encodes run on these threads;
        # each may itself fan out over the process pool.
        self._background_threads = max(1, int(background_threads))
        self._executor: ThreadPoolExecutor | None = None
        self._pending: dict[str, _PendingEncode] = {}
        self.stats = RegistryStats()
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.RLock()

    # -- introspection ----------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, matrix_id: str) -> bool:
        with self._lock:
            return matrix_id in self._entries

    @property
    def bytes_in_use(self) -> int:
        """Budgeted bytes: encoded streams + resident prepared arrays."""
        with self._lock:
            return self._bytes

    @property
    def stream_bytes_in_use(self) -> int:
        with self._lock:
            return sum(e.stream_bytes for e in self._entries.values())

    @property
    def prepared_bytes_in_use(self) -> int:
        with self._lock:
            return sum(e.prepared_bytes for e in self._entries.values())

    @property
    def device_bytes_in_use(self) -> int:
        """Device buffer bytes held by cached operator bindings."""
        with self._lock:
            return sum(e.device_bytes for e in self._entries.values())

    @property
    def over_budget(self) -> bool:
        with self._lock:
            return self._bytes > self.byte_budget

    def ids(self) -> list[str]:
        """Cached ids, least→most recently used."""
        with self._lock:
            return list(self._entries)

    def stats_snapshot(self) -> RegistryStats:
        """Consistent copy of the aggregate stats (reads under the lock —
        the raw ``stats`` object is mutated field-by-field by concurrent
        puts, so derived ratios read from it can tear).  The snapshot's
        ``device_bytes_in_use`` is filled in from the live bindings."""
        with self._lock:
            snap = dataclasses.replace(self.stats)
            snap.device_bytes_in_use = sum(
                e.device_bytes for e in self._entries.values())
            return snap

    def encode_stats(self) -> dict[str, dict]:
        """Per-entry encode economics: wall-time and slot throughput.

        Slots are stream elements (padding included; 8 B each at fp32
        values, 6 B at bf16) — the unit the paper's bandwidth model
        streams, so slots/s is directly the host-side preprocessing rate
        the accelerator must not outrun.
        """
        with self._lock:
            return {key: {"encode_seconds": e.encode_seconds,
                          "encode_slots": e.encode_slots,
                          "slots_per_s": e.encode_slots_per_s,
                          "queue_seconds": e.queue_seconds,
                          "version": e.version,
                          "delta_encodes": e.delta_encodes,
                          "delta_seconds": e.delta_seconds,
                          "delta_slots_per_s": e.delta_slots_per_s,
                          "spec": (f"{e.primary.partition}:"
                                   f"{e.primary.num_shards}:"
                                   f"{e.primary.lane_assign}"),
                          "backend": e.backend,
                          "auto_tuned": e.tune is not None,
                          "tune": (None if e.tune is None
                                   else e.tune.to_dict())}
                    for key, e in self._entries.items()}

    def version(self, matrix_id: str) -> int:
        """How many updates this entry has absorbed (0 = as put)."""
        with self._lock:
            return self._entries[matrix_id].version

    # -- core API ---------------------------------------------------------
    def _encode_pool(self) -> penc.EncodePool | None:
        """The persistent worker pool (lazily created when n_workers>1)."""
        with self._lock:
            if self.n_workers > 1 and self._pool is None:
                self._pool = penc.EncodePool(self.n_workers)
            return self._pool

    def _get_executor(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._executor is None:
                self._executor = ThreadPoolExecutor(
                    max_workers=self._background_threads,
                    thread_name_prefix="registry-encode")
            return self._executor

    def close(self) -> None:
        """Release the worker pool / background threads (entries remain).

        The executor drains first: an in-flight background encode may
        still lazily (re)create the pool via ``_encode_pool``, so the
        pool is only captured and closed once no job can run.
        """
        with self._lock:
            executor, self._executor = self._executor, None
        if executor is not None:
            executor.shutdown(wait=True)
        with self._lock:
            pool = self._pool if self._owns_pool else None
            if self._owns_pool:
                self._pool = None
        if pool is not None:
            pool.close()

    def get_tuner(self) -> PlanTuner:
        """The shared :class:`~repro_torch.core.autotune.PlanTuner`
        (created on first use when none was injected at construction),
        ranking plans for this registry's backend."""
        with self._lock:
            if self.tuner is None:
                self.tuner = PlanTuner(backend=self.default_backend)
            return self.tuner

    def _encode_plan(self, rows, cols, vals, shape, cfg, spec, be):
        """prepare + encode + bind (the pure, slow part; no lock held).

        Large matrices fan out over the process pool
        (:func:`repro_torch.core.parallel_encode.prepare_and_plan` —
        bit-identical to the serial encode); returns ``(prep, plan, op,
        seconds, slots, spec, backend, tune)`` with spec/backend concrete.

        ``spec="auto"`` consults the tuner: features come out of the
        prepared sort for near-free, the chosen candidate's config
        overrides are grafted onto the prepared arrays (the bucket sort
        only depends on segment/lane geometry, which candidates never
        change), and the entry remembers the decision so dispatch
        observations feed back into the tuner.
        """
        t0 = time.perf_counter()
        nnz = int(np.asarray(rows).size)
        nw = self.n_workers if nnz >= self.min_parallel_nnz else 1
        tune = None
        if spec == "auto":
            with obs.span("tune", cat="registry", nnz=nnz) as sp:
                prep = sformat.prepare(rows, cols, vals, shape, cfg)
                tune = self.get_tuner().choose(features_of(prep))
                cand = tune.candidate
                cfg2 = cand.apply_config(cfg)
                if cfg2 != cfg:
                    prep = dataclasses.replace(prep, config=cfg2)
                spec, be = cand.spec, cand.backend
                sp.args["choice"] = cand.key
            with obs.span("encode", cat="registry", nnz=nnz,
                          workers=nw) as sp:
                plan = cpart.plan_from_prepared(
                    prep, spec, n_workers=nw,
                    pool=self._encode_pool() if nw > 1 else None)
                sp.args["slots"] = int(plan.idx.size)
        else:
            with obs.span("encode", cat="registry", nnz=nnz,
                          workers=nw) as sp:
                prep, plan = penc.prepare_and_plan(
                    rows, cols, vals, shape, cfg, spec, n_workers=nw,
                    pool=self._encode_pool() if nw > 1 else None)
                sp.args["slots"] = int(plan.idx.size)
        with obs.span("bind", cat="registry"):
            op = SerpensOperator(plan, backend=be, device=self.device)
        dt = time.perf_counter() - t0
        return prep, plan, op, dt, int(plan.idx.size), spec, be, tune

    def _install(self, key, ck, spec, be, prep, plan, op, dt, slots,
                 queue_wait: float = 0.0, tune=None,
                 base_config=None) -> str:
        """Book-keep one finished encode (caller does NOT hold the lock)."""
        with self._lock:
            self.stats.encode_seconds += dt
            self.stats.encodes += 1
            self.stats.encode_slots += slots
            self.stats.queue_seconds += queue_wait
            entry = self._entries.get(key)
            if entry is not None and entry.content == ck:
                self.stats.hits += 1       # raced with another thread
                self._entries.move_to_end(key)
                return key
            if entry is not None:          # same name, new content: replace
                del self._entries[key]
                self._bytes -= entry.total_bytes
            self.stats.misses += 1
            self._insert(key, _Entry(content=ck, primary=spec, backend=be,
                                     plans={spec: plan}, ops={spec: op},
                                     prepared=prep, encode_seconds=dt,
                                     encode_slots=slots,
                                     queue_seconds=queue_wait,
                                     tune=tune, base_config=base_config))
        return key

    def put(self, rows, cols, vals, shape, *, config=None, backend=None,
            matrix_id: str | None = None, partition: str = "single",
            num_shards: int = 1, lane_assign: str = "modulo",
            spec=None, value_dtype: str | None = None,
            blocking: bool = True, verify: str | None = None) -> str:
        """Ensure the matrix's plan is cached; return its id.

        A repeat ``put`` of the same content + geometry is a *hit*: the
        encode does not re-run.  ``partition``/``num_shards``/
        ``lane_assign`` choose the channel-shard geometry (part of the
        content key); ``spec`` overrides all three with an explicit
        :class:`~repro_torch.core.partition.PlanSpec` — or the string
        ``"auto"``, which hands the choice of (spec, config overrides) to
        the shared :class:`~repro_torch.core.autotune.PlanTuner` based on
        the matrix's structural features (``backend`` is then the
        tuner's, which is this registry's).  ``value_dtype``
        overrides the config's value-stream dtype (``"float32"`` /
        ``"bfloat16"``) without constructing a config by hand; the dtype
        is part of the content key, so the same triples cached at both
        precisions are two distinct entries.  Pass
        ``matrix_id`` to name the entry explicitly (e.g. a model/layer
        path); otherwise the content hash is the id.  Re-using an explicit
        id with *different* content replaces the entry (a miss) rather than
        silently serving the stale matrix.

        ``blocking=False`` returns the id immediately and runs the encode
        on a background thread (which may itself fan out over the process
        pool): poll :meth:`ready`, or let :meth:`get` block until the
        entry installs.  The triples are copied at submit, so the caller
        may mutate its buffers right away.  Stats record the queue wait
        (submit → encode start) separately from encode wall-time.

        ``verify`` other than ``"off"`` (the reference's stream verifier
        gate) raises ``NotImplementedError`` until the analysis package is
        ported.
        """
        if verify is not None:
            _check_verify(verify)
        cfg = config or self.default_config
        if value_dtype is not None:
            cfg = dataclasses.replace(cfg, value_dtype=value_dtype)
        if spec is None:
            spec = cpart.PlanSpec(partition, num_shards, lane_assign)
        elif spec != "auto" and not isinstance(spec, cpart.PlanSpec):
            raise TypeError(f"spec must be a PlanSpec or 'auto', "
                            f"got {spec!r}")
        ck = content_key(rows, cols, vals, shape, cfg, spec)
        key = matrix_id or ck
        be = (self.default_backend if backend is None
              else kops.resolve_backend(backend, self.device))
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and entry.content == ck:
                self.stats.hits += 1
                self._entries.move_to_end(key)
                return key
            pending = self._pending.get(key)
            same_pending = (pending is not None and pending.content == ck
                            and not pending.cancelled
                            and pending.error is None)
            if pending is not None and not same_pending:
                # Same name, new content (or failed job): supersede it.
                pending.cancelled = True
                self._pending.pop(key, None)
                pending = None
            if not blocking:
                if same_pending:
                    return key             # identical encode already queued
                pending = _PendingEncode(
                    content=ck,
                    shape=(int(shape[0]), int(shape[1])),
                    submit_time=time.perf_counter())
                self._pending[key] = pending
                # Copy at submit: the encode reads these after we return.
                args = (np.array(rows, np.int64), np.array(cols, np.int64),
                        np.array(vals, np.float32),
                        (int(shape[0]), int(shape[1])))
                self._get_executor().submit(
                    self._background_encode, key, pending, args, cfg,
                    spec, be, obs.capture_context())
                obs.instant("encode-queued", cat="registry", matrix=key)
                return key
        if same_pending:                   # blocking put over a queued twin
            pending.done.wait()
            with self._lock:
                if pending.error is not None:
                    raise RuntimeError(
                        f"background encode of {key!r} failed"
                    ) from pending.error
                entry = self._entries.get(key)
                if entry is not None and entry.content == ck:
                    return key
            # The twin was cancelled (evict/clear mid-encode) — a blocking
            # put still promises a cached entry, so encode it ourselves.
        # Encode outside the lock — it is the slow part and pure.
        prep, plan, op, dt, slots, spec2, be2, tune = self._encode_plan(
            rows, cols, vals, shape, cfg, spec, be)
        return self._install(key, ck, spec2, be2, prep, plan, op, dt, slots,
                             tune=tune,
                             base_config=cfg if tune is not None else None)

    def _background_encode(self, key, pending: _PendingEncode, args, cfg,
                           spec, be, trace_ctx: dict | None = None) -> None:
        """Executor job for put(blocking=False).

        ``trace_ctx`` is the submitter's ambient trace context
        (:func:`obs.capture_context` at put time): adopting it here makes
        every span this encode emits carry the submitting request's tags,
        so the background work shows up attributed in the trace.
        """
        queue_wait = time.perf_counter() - pending.submit_time
        with obs.attach_context(trace_ctx or {}, matrix=key):
            obs.event("encode-queue-wait", queue_wait, cat="registry")
            try:
                rows, cols, vals, shape = args
                prep, plan, op, dt, slots, spec2, be2, tune = \
                    self._encode_plan(rows, cols, vals, shape, cfg, spec,
                                      be)
            except BaseException as e:      # surfaced by ready()/get()
                obs.instant("encode-failed", cat="registry", error=str(e))
                with self._lock:
                    pending.error = e
                self._settle_pending(pending)
                return
            with self._lock:
                cancelled = pending.cancelled
                if cancelled:          # evicted mid-encode: count the work
                    if self._pending.get(key) is pending:
                        del self._pending[key]
                    self.stats.encodes += 1
                    self.stats.encode_seconds += dt
                    self.stats.encode_slots += slots
                    self.stats.queue_seconds += queue_wait
            if not cancelled:
                # Install BEFORE clearing the pending record: ready()/get()
                # always see pending-or-entry, never a gap a concurrent
                # flush would misread as "unknown matrix".
                self._install(key, pending.content, spec2, be2, prep, plan,
                              op, dt, slots, queue_wait=queue_wait,
                              tune=tune,
                              base_config=cfg if tune is not None else None)
                with self._lock:
                    self.stats.background_puts += 1
                    if self._pending.get(key) is pending:
                        del self._pending[key]
                    if pending.cancelled:
                        # evict() raced the install (it found no entry to
                        # remove yet): honor it now.
                        entry = self._entries.get(key)
                        if entry is not None \
                                and entry.content == pending.content:
                            del self._entries[key]
                            self._bytes -= entry.total_bytes
                            self.stats.evictions += 1
        self._settle_pending(pending)

    def _settle_pending(self, pending: _PendingEncode) -> None:
        """Mark a background encode finished and fire its listeners.

        ``done`` is set first so blocked waiters wake, then the listener
        list is drained under the lock (``settled`` flips so a concurrent
        ``on_ready`` fires immediately instead of registering into a list
        nobody will drain again) and the callbacks run outside it — a
        listener is free to call back into the registry.
        """
        with self._lock:
            pending.settled = True
            listeners, pending.listeners = list(pending.listeners), []
        pending.done.set()
        for cb in listeners:
            try:
                cb()
            except Exception:       # noqa: BLE001 — listener bugs are theirs
                log.exception("on_ready listener failed")

    def on_ready(self, matrix_id: str, callback) -> None:
        """Invoke ``callback()`` once ``matrix_id``'s background encode
        settles — installed, failed, or cancelled (poll :meth:`ready` to
        tell which).  Fires immediately (on the calling thread) when no
        encode is pending; otherwise fires exactly once on the encode
        worker thread.  This is what lets the serving pipeline park a
        request submitted against a cold matrix and re-enter it on the
        event instead of polling at every flush.
        """
        with self._lock:
            pending = self._pending.get(matrix_id)
            if pending is not None and not pending.settled:
                pending.listeners.append(callback)
                return
        callback()

    def ready(self, matrix_id: str) -> bool:
        """Poll a background put: True once the entry serves, False while
        its encode is queued/running.  Raises ``KeyError`` for unknown ids
        and re-raises a failed background encode's error."""
        with self._lock:
            pending = self._pending.get(matrix_id)
            if pending is not None:
                if pending.error is not None:
                    raise RuntimeError(
                        f"background encode of {matrix_id!r} failed"
                    ) from pending.error
                return False
            if matrix_id in self._entries:
                return True
        raise KeyError(f"matrix {matrix_id!r} not in registry")

    def shape(self, matrix_id: str) -> tuple[int, int]:
        """(M, K) of a cached or still-encoding matrix (KeyError else)."""
        with self._lock:
            entry = self._entries.get(matrix_id)
            if entry is not None:
                return tuple(entry.plans[entry.primary].shape)
            pending = self._pending.get(matrix_id)
            if pending is not None:
                return tuple(pending.shape)
        raise KeyError(f"matrix {matrix_id!r} not in registry")

    def content(self, matrix_id: str) -> str:
        """Current content hash of a cached or still-encoding matrix —
        what a deferred serving request pins itself to, so a name
        re-registered with new data mid-encode is detected rather than
        silently served (KeyError for unknown ids)."""
        with self._lock:
            entry = self._entries.get(matrix_id)
            if entry is not None:
                return entry.content
            pending = self._pending.get(matrix_id)
            if pending is not None:
                return pending.content
        raise KeyError(f"matrix {matrix_id!r} not in registry")

    @property
    def pending_encodes(self) -> int:
        with self._lock:
            return len(self._pending)

    def put_operator(self, op: SerpensOperator,
                     matrix_id: str | None = None) -> str:
        """Adopt an already-built operator (counts as a miss, no encode).

        Dedupes against other adopted operators via :func:`stream_key`; an
        operator whose triples were also ``put`` directly gets its own entry
        (the COO input order that produced it is unknown here).  The
        operator must live on the registry's device.
        """
        if op.device != self.device:
            raise ValueError(f"operator on {op.device}; this registry binds "
                             f"on {self.device}")
        ck = stream_key(op.plan)
        key = matrix_id or ck
        spec = op.plan.spec
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and entry.content == ck:
                self.stats.hits += 1
                self._entries.move_to_end(key)
            else:
                if entry is not None:
                    del self._entries[key]
                    self._bytes -= entry.total_bytes
                self.stats.misses += 1
                self._insert(key, _Entry(
                    content=ck, primary=spec, backend=op.backend,
                    plans={spec: op.plan},
                    ops={spec: op}))
        return key

    def update(self, matrix_id: str, delta_rows, delta_cols,
               delta_vals=None, *, mode: str = "add") -> str:
        """Apply a COO delta to a cached matrix without a full re-encode.

        Every cached plan of the entry is updated in one shared pass
        (:func:`~repro_torch.core.partition.plan_apply_delta`): the delta merges
        into the entry's resident ``PreparedCOO`` bucket sort and only the
        touched (shard, segment) tile blocks re-encode, spliced into the
        existing streams — the encode cost scales with the delta's
        segment footprint; only memcpy-level O(nnz) passes remain.  Modes
        ``"add"`` (append entries; duplicates sum), ``"set"`` (replace the
        entries at each delta (row, col) pair) and ``"delete"`` (remove
        them; ``delta_vals`` optional).

        The entry is *versioned in place*: its ``matrix_id`` is unchanged
        but its content hash advances along a chain
        (``delta_key(parent, delta)``), its ``version`` counter bumps, and
        all cached bindings are invalidated so the next ``get``
        serves operators over the new streams.  Operators handed out
        before the update keep the old (immutable) plan — in-flight work
        is never retroactively changed.

        Entries whose prepared arrays were dropped under byte pressure
        (and entries adopted via ``put_operator``) degrade to a
        decode-and-re-encode of the full matrix — same result, full-encode
        cost.
        """
        d_r = np.asarray(delta_rows)
        d_c = np.asarray(delta_cols)
        d_v = delta_vals if delta_vals is None else np.asarray(delta_vals)
        while True:
            with self._lock:
                pending = self._pending.get(matrix_id)
            if pending is not None:
                # Update while the background encode is still running:
                # wait for the entry to install, then apply the delta.
                pending.done.wait()
            with self._lock:
                entry = self._entries.get(matrix_id)
                if entry is None:
                    raise KeyError(
                        f"matrix {matrix_id!r} not in registry "
                        f"(cached: {len(self._entries)})")
                content = entry.content
                prep = entry.prepared
                plans = dict(entry.plans)
            new_ck = delta_key(content, mode, d_r, d_c, d_v)
            # Merge + re-encode outside the lock (the slow, pure part).
            t0 = time.perf_counter()
            with obs.span("delta-encode", cat="registry", matrix=matrix_id,
                          mode=mode, delta_nnz=int(d_r.size),
                          degraded=prep is None) as dsp:
                if prep is not None:
                    merge = prep.merge_delta(d_r, d_c, d_v, mode=mode)
                    if merge.is_noop:  # nothing changed: keep the version
                        return matrix_id  # and every cached binding
                    new_prep = merge.prepared
                    new_plans, slots = {}, 0
                    for spec, plan in plans.items():
                        if plan.row_perm is not None:
                            # Balanced lanes: the LPT assignment depends on
                            # per-row nnz, which the delta changed — cold
                            # re-encode from the merged sort (still skips
                            # re-validate + global re-sort).
                            new_plans[spec] = cpart.plan_from_prepared(
                                merge.prepared, spec)
                            slots += int(new_plans[spec].idx.size)
                        else:
                            new_plans[spec], merge, s = \
                                cpart.plan_apply_delta(plan, prep,
                                                       merge=merge)
                            slots += s
                else:
                    # Degraded path: prepared dropped (byte pressure) or
                    # never known (adopted operator) — decode and
                    # re-encode cold.
                    src = next(iter(plans.values()))
                    r, c, v = src.to_coo()
                    base = sformat.prepare(r, c, v, src.shape, src.config)
                    merge = base.merge_delta(d_r, d_c, d_v, mode=mode)
                    if merge.is_noop:
                        return matrix_id
                    new_prep = merge.prepared
                    new_plans = {
                        spec: cpart.plan_from_prepared(new_prep, spec)
                        for spec in plans}
                    slots = sum(int(p.idx.size)
                                for p in new_plans.values())
                dsp.args["slots"] = slots
            dt = time.perf_counter() - t0
            with self._lock:
                entry = self._entries.get(matrix_id)
                if entry is None or entry.content != content:
                    continue   # lost a race with put/update: redo on top
                old_total = entry.total_bytes
                entry.plans = new_plans
                entry.prepared = new_prep
                entry.content = new_ck
                entry.version += 1
                entry.ops.clear()          # stale bindings invalidated
                entry.delta_encodes += 1
                entry.delta_seconds += dt
                entry.delta_slots += slots
                self.stats.delta_encodes += 1
                self.stats.delta_seconds += dt
                self.stats.delta_slots += slots
                self._bytes += entry.total_bytes - old_total
                self._entries.move_to_end(matrix_id)
                self._evict_over_budget(keep=matrix_id)
            return matrix_id

    # -- auto-tuning feedback ---------------------------------------------
    def tune_decision(self, matrix_id: str):
        """The :class:`~repro_torch.core.autotune.TuneDecision` behind an
        auto-tuned entry's current plan, or None for manual entries."""
        with self._lock:
            entry = self._entries.get(matrix_id)
            return None if entry is None else entry.tune

    def record_observation(self, matrix_id: str, *, slots_per_s: float,
                           requests_per_s: float | None = None) -> bool:
        """Feed one measured dispatch back into the tuner.

        Called by the service after a dispatch against an auto-tuned
        matrix; no-op (False) for manual entries.
        """
        with self._lock:
            entry = self._entries.get(matrix_id)
            tune = None if entry is None else entry.tune
            tuner = self.tuner
        if tune is None or tuner is None:
            return False
        tuner.observe(tune.bucket, tune.candidate, slots_per_s,
                      requests_per_s=requests_per_s,
                      predicted=tune.predicted)
        return True

    def retune(self, matrix_id: str) -> bool:
        """Re-consult the tuner for an auto-tuned entry; swap its plan if
        the ranking changed under it.

        Cheap when the choice is stable (one ranked lookup, no encode).
        On a swap the entry is re-encoded from its resident prepared sort
        with the new candidate's config overrides, and its cached bindings
        are dropped, so their device bytes leave ``device_bytes_in_use``
        and the next ``get`` binds the new plan.  An operator handed out
        before (an in-flight batch holds its own) keeps the old plan.
        Returns True iff the plan was swapped.  Entries whose prepared
        arrays were shed under byte pressure (or manual entries) are left
        alone.
        """
        with self._lock:
            entry = self._entries.get(matrix_id)
            if entry is None or entry.tune is None or entry.prepared is None:
                return False
            tuner = self.tuner
            if tuner is None:
                return False
            prep = entry.prepared
            content = entry.content
            old = entry.tune
            base_cfg = entry.base_config or prep.config
        decision = tuner.choose(features_of(prep), explore=False)
        if decision.candidate.key == old.candidate.key:
            with self._lock:
                entry = self._entries.get(matrix_id)
                if entry is not None and entry.content == content:
                    entry.tune = decision  # refresh the predicted score
            return False
        cand = decision.candidate
        cfg2 = cand.apply_config(base_cfg)
        prep2 = (prep if cfg2 == prep.config
                 else dataclasses.replace(prep, config=cfg2))
        t0 = time.perf_counter()
        with obs.span("retune", cat="registry", matrix=matrix_id,
                      choice=cand.key, was=old.candidate.key):
            plan = cpart.plan_from_prepared(prep2, cand.spec)
        dt = time.perf_counter() - t0
        slots = int(plan.idx.size)
        with self._lock:
            entry = self._entries.get(matrix_id)
            if entry is None or entry.content != content:
                return False   # evicted/updated mid-encode: drop the work
            old_total = entry.total_bytes
            entry.plans = {cand.spec: plan}
            entry.ops.clear()              # old bindings' device bytes go
            entry.prepared = prep2
            entry.primary = cand.spec
            entry.backend = cand.backend
            entry.tune = decision
            entry.encode_seconds += dt
            entry.encode_slots += slots
            self.stats.encodes += 1
            self.stats.encode_seconds += dt
            self.stats.encode_slots += slots
            self._bytes += entry.total_bytes - old_total
            self._entries.move_to_end(matrix_id)
            self._evict_over_budget(keep=matrix_id)
        tuner.record_retune(decision.bucket)
        return True

    def get(self, matrix_id: str, *, block: bool = True,
            timeout: float | None = None) -> SerpensOperator:
        """Fetch a ready operator on the registry's device (refreshes LRU
        recency); a binding shed under byte pressure is rebuilt here.

        If the id names a still-encoding background put, ``get`` waits for
        it (``timeout`` seconds at most — ``TimeoutError`` after; with
        ``block=False`` it raises ``KeyError`` immediately instead).
        """
        pending = None
        with self._lock:
            pending = self._pending.get(matrix_id)
        if pending is not None:
            if not block:
                raise KeyError(
                    f"matrix {matrix_id!r} is still encoding "
                    f"(put(blocking=False); poll ready() or get with "
                    f"block=True)")
            if not pending.done.wait(timeout):
                raise TimeoutError(
                    f"matrix {matrix_id!r} still encoding after "
                    f"{timeout}s")
            with self._lock:
                if pending.error is not None:
                    raise RuntimeError(
                        f"background encode of {matrix_id!r} failed"
                    ) from pending.error
        with self._lock:
            if matrix_id not in self._entries:
                self.stats.misses += 1
                raise KeyError(f"matrix {matrix_id!r} not in registry "
                               f"(cached: {len(self._entries)})")
            self.stats.hits += 1
            self._entries.move_to_end(matrix_id)
            entry = self._entries[matrix_id]
            spec = entry.primary
            op = entry.ops.get(spec)
            if op is not None:
                return op
            plan = entry.plans[spec]
            backend = entry.backend
            content = entry.content
        # Device transfer outside the lock, like every slow path.
        return self._make_binding(matrix_id, content, plan, spec, backend)

    def evict(self, matrix_id: str) -> None:
        obs.instant("evict", cat="registry", matrix=matrix_id)
        with self._lock:
            pending = self._pending.pop(matrix_id, None)
            if pending is not None:
                # Evict while encoding: the job completes but never
                # installs; a later get() raises KeyError.
                pending.cancelled = True
            entry = self._entries.pop(matrix_id, None)
            if entry is not None:
                self._bytes -= entry.total_bytes
                self.stats.evictions += 1

    def clear(self) -> None:
        obs.instant("registry-clear", cat="registry")
        with self._lock:
            for pending in self._pending.values():
                pending.cancelled = True
            self._pending.clear()
            self.stats.evictions += len(self._entries)
            self._entries.clear()
            self._bytes = 0

    # -- internals --------------------------------------------------------
    def _make_binding(self, key: str, content: str, plan, spec,
                      backend: str) -> SerpensOperator:
        """Build + cache an operator binding (call WITHOUT the lock).

        The ``SerpensOperator`` construction moves the plan's streams to
        the device — slow work that must not stall concurrent
        submit/get/put on the registry lock.  The publish step re-checks
        the entry: first racer's binding wins, and an entry evicted or
        updated mid-transfer gets an uncached (but working) operator.

        Bindings live until byte pressure or an update sheds them.  Their
        device bytes are charged to the byte budget
        (``device_bytes_in_use``), and bindings are the first thing
        ``_evict_over_budget`` drops.
        """
        with obs.span("bind", cat="registry", matrix=key):
            op = SerpensOperator(plan, backend=backend, device=self.device)
        with self._lock:
            entry = self._entries.get(key)
            if entry is None or entry.content != content:
                return op      # evicted/updated mid-transfer: uncached
            cached = entry.ops.get(spec)
            if cached is not None:
                return cached
            entry.ops[spec] = op
            self._bytes += op.device_bytes
            self._evict_over_budget(keep=key)
        return op

    def _insert(self, key: str, entry: _Entry) -> None:
        """Insert + LRU-evict down to budget (caller holds the lock)."""
        self._entries[key] = entry
        self._bytes += entry.total_bytes
        self._evict_over_budget(keep=key)

    def _evict_over_budget(self, keep: str) -> None:
        """Shed bytes until within budget, never evicting ``keep``.

        Three-stage pressure, cheapest-to-rebuild first: (1) drop cached
        operator bindings LRU-first (releases their device buffers;
        the next ``get`` re-binds from the host plan), (2) drop
        PreparedCOO arrays LRU-first (the entry keeps serving;
        repartition and update degrade to the decode-path re-encode),
        (3) evict whole entries.  ``keep``'s bindings are never shed —
        one may have just been handed out — and its prepared arrays are
        the last to go before eviction starts.
        """
        if self._bytes > self.byte_budget:
            for key in [k for k in self._entries if k != keep]:
                if self._bytes <= self.byte_budget:
                    break
                e = self._entries[key]
                db = e.device_bytes
                if db:
                    self._bytes -= db
                    e.ops.clear()
                    self.stats.bindings_dropped += 1  # repro-lint: disable=stat-lock
        if self._bytes > self.byte_budget:
            victims = [k for k in self._entries if k != keep] + \
                ([keep] if keep in self._entries else [])
            for key in victims:
                if self._bytes <= self.byte_budget:
                    break
                e = self._entries[key]
                if e.prepared is not None:
                    self._bytes -= e.prepared_bytes
                    e.prepared = None
                    self.stats.prepared_drops += 1  # repro-lint: disable=stat-lock
        while self._bytes > self.byte_budget and len(self._entries) > 1:
            old_key, old = next(iter(self._entries.items()))
            if old_key == keep:
                break  # never evict the entry just inserted/extended
            del self._entries[old_key]
            self._bytes -= old.total_bytes
            self.stats.evictions += 1  # repro-lint: disable=stat-lock
