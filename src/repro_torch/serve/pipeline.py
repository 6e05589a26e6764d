"""Staged asynchronous serving pipeline for registry-resident matrices.

Serpens sustains HBM bandwidth by decoupling its memory-centric PEs into
independent fetch/compute/write stages so no stage ever stalls another
(paper Sec. 3).  This module gives the serving tier the same shape — four
explicit stages connected by bounded queues::

    submit ──► [admission] ──► wait queue ──► [coalesce] ──► [dispatch]
                  │ block /        │ (bounded,     │ pow2 SpMM    │ launch,
                  │ reject /       │  parked       │ buckets      │ no block
                  │ shed-oldest    │  re-entries)  ▼              ▼
                  ▼                          in-flight queue (depth 1)
           per-owner error                            │
           results on shed                     [collect] ──► per-owner
                                               device-block    result queues

* **admission** — every ``submit``/``submit_solve`` passes a bounded gate
  (``AdmissionConfig``): ``block`` applies backpressure to the caller
  (bounded by ``block_timeout``), ``reject`` raises
  :class:`AdmissionRejected`, ``shed-oldest`` evicts the oldest queued
  request and routes it a :class:`RequestShed` error result.  A per-owner
  fairness cap stops one caller from monopolizing the queue.
* **coalesce** — same-matrix requests group into SpMM batches of at most
  ``max_bucket`` vectors, padded to a power of two (same economics as the
  synchronous service: the A-stream is read once per batch).  Requests
  against still-encoding matrices are *parked*: a registry ``on_ready``
  listener re-enters them when the encode settles — no flush-time polling
  when the dispatcher runs.
* **dispatch** — launches the batch on the device and returns without
  blocking (CUDA launches are asynchronous; the dispatcher thread launches
  on its own CUDA stream and records an event after the batch); the
  launched batch goes into a bounded
  in-flight queue.  ``inflight_depth=1`` (the default) is double
  buffering: one batch held by the collector plus one buffered, so
  host-side coalesce/pack of batch N+1 overlaps device execution of
  batch N.  Deeper pipes buy no throughput once the queue stays primed
  but add a full batch of tail latency per extra slot.
* **collect** — waits on the batch's event, copies the result to the
  host, records latency, and
  deposits each request's result into its owner's bounded result queue
  (``max_stored_results`` per owner; overflow drops the owner's oldest
  uncollected result and charges it to that owner).

``start()`` spawns the dispatcher + collector threads; without them the
same pipeline runs synchronously inside ``flush()`` (one stage after
another, with rollback-and-requeue on dispatch failure), which is the
back-compat contract :class:`repro_torch.serve.spmv_service.SpMVService` keeps.
Solver runs (:mod:`repro_torch.solvers`) enter through the same admission
gate via ``submit_solve`` and dispatch as singleton batches.

Failure semantics differ by mode on purpose: the synchronous path rolls
back and re-queues every request of the failed flush (callers retry the
flush), while the pipelined path converts a failed batch into per-request
error results (there is no caller to re-raise into).
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import queue as queue_mod
import threading
import time
from collections import OrderedDict, deque

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch import solvers
from repro_torch.core.registry import MatrixRegistry
from repro_torch.kernels import ops as kops
from repro_torch.obs.metrics import MetricsRegistry

log = logging.getLogger("repro_torch.serve")

# Micro-batch width buckets are small powers of two, so batch-size buckets
# are too (le-inclusive: a 16-wide batch lands in the 16 bucket).
BATCH_SIZE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)

ADMISSION_POLICIES = ("block", "reject", "shed-oldest")


def _on_stream(stream):
    """Run the block on ``stream`` (a CUDA stream), or as is for None."""
    return (contextlib.nullcontext() if stream is None
            else torch.cuda.stream(stream))


def bucket_width(n: int, max_bucket: int) -> int:
    """Pad a batch width to the next power of two, capped at ``max_bucket``.

    Power-of-two buckets bound the set of SpMM widths a matrix is served
    at to log2(max_bucket)+1 shapes.
    """
    if n < 1:
        raise ValueError("batch width must be >= 1")
    w = 1
    while w < n:
        w *= 2
    return min(w, max_bucket)


class AdmissionError(RuntimeError):
    """Base class for admission-gate outcomes."""


class AdmissionRejected(AdmissionError):
    """Raised at submit when the gate refuses the request (policy
    ``reject``, a ``block`` timeout, or ``shed-oldest`` with nothing
    shed-able)."""


class RequestShed(AdmissionError):
    """Stored as the error of a queued request evicted by ``shed-oldest``;
    re-raised to its owner by :meth:`SpMVPipeline.result`."""


@dataclasses.dataclass
class AdmissionConfig:
    """The admission stage's policy knobs.

    ``max_pending`` bounds the wait queue; ``per_owner_cap`` additionally
    bounds any single owner's share of it (fairness under overload);
    ``block_timeout`` bounds how long a ``block``-policy submit may wait
    (None = forever).  The gate applies at submit only — deferred requests
    re-queued by a failed flush may transiently exceed the bound rather
    than be dropped.
    """

    policy: str = "block"
    max_pending: int = 4096
    per_owner_cap: int | None = None
    block_timeout: float | None = 30.0

    def __post_init__(self):
        if self.policy not in ADMISSION_POLICIES:
            raise ValueError(f"policy must be one of {ADMISSION_POLICIES}, "
                             f"got {self.policy!r}")
        if self.max_pending < 1:
            raise ValueError("max_pending must be >= 1")
        if self.per_owner_cap is not None and self.per_owner_cap < 1:
            raise ValueError("per_owner_cap must be >= 1 or None")
        if self.block_timeout is not None and self.block_timeout <= 0:
            raise ValueError("block_timeout must be > 0 or None")


@dataclasses.dataclass
class SpMVRequest:
    ticket: int
    matrix_id: str
    op: object          # SerpensOperator captured at submit — a later registry
                        # eviction cannot strand an already-queued request.
                        # None while the matrix is still background-encoding
                        # (resolved at coalesce once the registry reports
                        # ready).
    x: np.ndarray | None
    alpha: float
    beta: float
    y: np.ndarray | None
    submit_time: float
    # Content hash pinned at submit for deferred (op=None) requests: if
    # the id is re-registered with different data (or updated) before the
    # request dispatches, it fails explicitly instead of being silently
    # served against a matrix it was never submitted to.
    expect_content: str | None = None
    # Caller identity for per-owner admission caps and result queues
    # (defaults to the submitting thread's name): queue-overflow drops of
    # this request's uncollected result are charged to its owner.
    owner: str | None = None
    # True while the request waits on a background encode.  The running
    # dispatcher skips parked requests; a registry on_ready listener
    # un-parks them (pipeline re-entry).  The synchronous flush path
    # polls them instead, exactly like the pre-pipeline service.
    parked: bool = False
    # "spmv" or "solve"; solve requests carry the solver name + kwargs and
    # dispatch as singleton batches through the same admission gate.
    kind: str = "spmv"
    solve_kind: str | None = None
    solve_kw: dict | None = None


@dataclasses.dataclass
class SpMVResult:
    """Per-request outcome + the serving economics of its batch."""
    ticket: int
    y: np.ndarray | None
    latency_s: float          # submit → result materialized
    batch_size: int           # real requests coalesced in this SpMM call
    bucket_n: int             # padded width actually dispatched
    stream_bytes_per_vector: float  # A-stream bytes / real vectors in batch
    # Set when the request can never complete (e.g. its still-encoding
    # matrix was evicted, its background encode failed, or admission shed
    # it); ``result()`` re-raises it to the collecting caller.
    error: BaseException | None = None
    owner: str | None = None
    # Solver result object (CGResult / PowerResult) for submit_solve
    # requests; ``y`` holds the solution vector on the host.  A solve's
    # stream_bytes_per_vector counts one A-stream per solver iteration.
    solve: object | None = None


@dataclasses.dataclass
class ServiceStats:
    batches: int = 0
    stream_bytes: int = 0     # total A-stream traffic dispatched
    vectors: int = 0          # real vectors (= requests) served
    deferred: int = 0         # requests that waited on a background encode
    results_dropped: int = 0  # uncollected results dropped from owner queues
    admitted: int = 0         # requests accepted by the admission gate
    rejected: int = 0         # submits refused (reject / block timeout)
    shed: int = 0             # queued requests evicted by shed-oldest

    @property
    def amortized_bytes_per_vector(self) -> float:
        return self.stream_bytes / self.vectors if self.vectors else 0.0

    @property
    def mean_batch_size(self) -> float:
        return self.vectors / self.batches if self.batches else 0.0


@dataclasses.dataclass
class _Launched:
    """A dispatched-but-not-collected SpMM batch in the in-flight queue."""
    batch: list
    op: object                # held until collected: keeps its device
                              # tensors alive while the kernels run
    out: torch.Tensor         # device result; collect copies it to host
    width: int
    t_compute: float          # perf_counter at compute launch
    done: object = None       # CUDA event recorded after the batch
    stream: object = None     # the dispatcher's stream (pipelined mode)


_TakeResult = tuple  # (ready_reqs, n_taken, n_deferred)


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Equal devices, reading a CUDA device without an index as the
    current one."""
    def norm(d):
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return d
    return a.type == b.type and (a.type != "cuda" or norm(a) == norm(b))


class SpMVPipeline:
    """Admission → coalesce → dispatch → collect over registry matrices.

    Synchronous by default: ``flush()`` runs coalesce/dispatch/collect on
    the calling thread (micro-batching semantics identical to the
    pre-pipeline ``SpMVService``).  ``start()`` switches to pipelined
    mode: a dispatcher thread coalesces and launches batches, a collector
    thread blocks on device results and deposits them, and ``flush()``
    becomes a drain barrier returning ``{}`` (results arrive through
    per-owner queues via ``result()``).

    With ``mesh``/``axis`` (and ``partition``, the registry's default
    without it) every batch and solve runs the matrix's plan over that
    ``DeviceMesh`` axis, one shard a rank.  Every rank of the mesh runs
    its own service and makes the same calls; such a service serves
    synchronously (``start`` is refused).

    Usage::

        reg = MatrixRegistry(device="cuda")
        mid = reg.put(rows, cols, vals, shape)
        svc = SpMVPipeline(reg, max_bucket=16, device="cuda",
                           admission=AdmissionConfig("shed-oldest",
                                                     max_pending=256))
        with svc:                       # start()/stop() the stage threads
            t = svc.submit(mid, x)
            y = svc.result(t, timeout=5.0).y
    """

    def __init__(self, registry: MatrixRegistry, max_bucket: int = 16,
                 backend: str | None = None, mesh=None,
                 axis: str | None = None, partition: str | None = None,
                 max_stored_results: int = 4096,
                 metrics: MetricsRegistry | None = None,
                 retune_every: int = 16,
                 admission: AdmissionConfig | str | None = None,
                 inflight_depth: int = 1, *, device=None):
        if max_bucket < 1 or max_bucket & (max_bucket - 1):
            raise ValueError("max_bucket must be a power of two >= 1")
        if mesh is not None and axis is None:
            raise ValueError("mesh requires axis")
        if mesh is None and partition is not None:
            raise ValueError("partition requires mesh")
        if max_stored_results < 1:
            raise ValueError("max_stored_results must be >= 1")
        if retune_every < 0:
            raise ValueError("retune_every must be >= 0")
        if inflight_depth < 1:
            raise ValueError("inflight_depth must be >= 1")
        if admission is None:
            admission = AdmissionConfig()
        elif isinstance(admission, str):
            admission = AdmissionConfig(policy=admission)
        # The service runs where its registry binds: CUDA unless the caller
        # asks for the CPU, and a device that differs from the registry's
        # raises rather than serving from somewhere else.
        self.device = kops.resolve_device(device)
        if not _same_device(self.device, registry.device):
            raise ValueError(f"service on {self.device}, but the registry "
                             f"binds on {registry.device}")
        if mesh is not None and mesh.device_type != registry.device.type:
            raise ValueError(f"mesh is over {mesh.device_type!r} devices, "
                             f"but the registry binds on {registry.device}")
        self.registry = registry
        self.max_bucket = max_bucket
        self.admission = admission
        self.inflight_depth = int(inflight_depth)
        # A backend override is resolved exactly once here, against the
        # registry's device ("auto" → concrete); None defers to each
        # operator's own bind-time choice.
        self.backend = (None if backend is None
                        else kops.resolve_backend(backend, registry.device))
        # Auto-tuned matrices feed observed slots/s back to the registry's
        # tuner after every SpMM dispatch; every `retune_every`
        # observations on a matrix the registry re-consults the tuner and
        # swaps the plan if the ranking flipped (0 disables the cadence).
        self.retune_every = int(retune_every)
        self._tune_obs: dict[str, int] = {}
        # With a mesh, every dispatched batch and solve runs the
        # channel-shard plan one shard a rank over `axis` (the registry
        # caches the mesh binding).  Every rank runs the same service
        # (SPMD): what a rank dispatches must follow from its submits
        # alone, never from its clock or its threads' timing, or the
        # ranks' collectives would not match.
        self.mesh = mesh
        self.axis = axis
        self.partition = partition
        # The serving stats live in a MetricsRegistry (private per service
        # by default, so two services never alias counters; pass
        # metrics=obs.REGISTRY to scrape several on one page).  The
        # ServiceStats dataclass remains as the read view (`stats`),
        # assembled under the pipeline lock so cross-metric ratios never
        # tear.  Mutations happen under the same lock for the same reason.
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        m = self.metrics
        self._m_batches = m.counter(
            "spmv_batches_total", "SpMM dispatches")
        self._m_vectors = m.counter(
            "spmv_vectors_total", "real vectors (requests) served")
        self._m_stream_bytes = m.counter(
            "spmv_stream_bytes_total", "A-stream bytes dispatched")
        self._m_deferred = m.counter(
            "spmv_deferred_total",
            "requests that waited on a background encode")
        self._m_dropped = m.counter(
            "spmv_results_dropped_total",
            "uncollected results dropped from owner queues, by owner")
        self._m_admitted = m.counter(
            "spmv_admitted_total", "requests accepted by the admission gate")
        self._m_rejected = m.counter(
            "spmv_rejected_total",
            "submits refused by admission (reject policy / block timeout)")
        self._m_shed = m.counter(
            "spmv_shed_total",
            "queued requests evicted by shed-oldest, by owner")
        self._m_block_waits = m.counter(
            "spmv_admission_block_waits_total",
            "submits that had to wait under the block policy")
        self._m_dispatch_lat = m.histogram(
            "spmv_dispatch_latency_seconds",
            "submit -> result-materialized latency per request")
        self._m_flush = m.histogram(
            "spmv_flush_seconds", "wall time of each flush() call")
        self._m_batch_size = m.histogram(
            "spmv_batch_size", "real requests coalesced per SpMM dispatch",
            buckets=BATCH_SIZE_BUCKETS, max_samples=0)
        self._g_depth = m.gauge(
            "spmv_queue_depth", "requests waiting in the admission queue")
        self._g_parked = m.gauge(
            "spmv_parked_requests",
            "queued requests waiting on a background encode")
        self._g_inflight = m.gauge(
            "spmv_inflight_batches",
            "batches launched on the device, not yet collected")
        self._g_stored = m.gauge(
            "spmv_stored_results",
            "deposited results not yet collected, all owners")
        # One lock guards all pipeline state; the two condition variables
        # share it (entering either acquires the same lock).  _cv signals
        # queue-state changes (admission space / work for the dispatcher),
        # _result_cv signals deposited results (and drain progress).
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._result_cv = threading.Condition(self._lock)
        # Admission-ordered wait queue.  Bounded by the admission gate
        # (max_pending), not by the container, because shed-oldest pops
        # from the FRONT and a failed flush re-queues at the front —
        # deque(maxlen=...) would silently drop from the wrong end
        # instead of applying policy.
        self._queue = deque()  # repro-lint: disable=unbounded-queue
        self._owner_pending: dict[str, int] = {}
        self._parked = 0            # parked entries currently in _queue
        self._in_system = 0         # taken off the queue, not yet deposited
        # Per-owner bounded result queues (ticket → result, FIFO) + the
        # ticket → owner map for deposited-uncollected tickets.
        self._results: dict[str, OrderedDict[int, SpMVResult]] = {}
        self._ticket_owner: dict[int, str] = {}
        self._stored = 0
        self.max_stored_results = int(max_stored_results)
        self._next_ticket = 0
        # (matrix_id, content) pairs with a live on_ready listener, so a
        # thousand parked submits against one cold matrix register one
        # callback, not a thousand.
        self._listened: set[tuple[str, str]] = set()
        # Pipelined-mode machinery: dispatcher → collector hand-off.
        self._inflight: queue_mod.Queue = queue_mod.Queue(
            maxsize=self.inflight_depth)
        self._inflight_n = 0
        self._running = False
        self._stop = threading.Event()
        self._dispatcher_t: threading.Thread | None = None
        self._collector_t: threading.Thread | None = None
        # The dispatcher's own CUDA stream (created by start() on a CUDA
        # registry), so its launches never queue behind other work on the
        # default stream.
        self._stream = None

    # -- lifecycle --------------------------------------------------------
    @property
    def pipelined(self) -> bool:
        """True while the dispatcher/collector threads run."""
        return self._running

    def start(self) -> "SpMVPipeline":
        """Spawn the dispatcher + collector threads (idempotent).

        Refused under a mesh: each rank's dispatcher would coalesce what
        its own queue holds at that moment, so two ranks could launch
        batches of different widths and their collectives would not
        match.  A mesh-bound service serves in synchronous mode, where
        ``flush`` forms the batches from the submit sequence alone.
        """
        if self.mesh is not None:
            raise NotImplementedError(
                "a mesh-bound service serves synchronously (flush); a "
                "pipelined dispatch agreed across ranks is ROADMAP "
                "Queue 1 #8")
        with self._lock:
            if self._running:
                return self
            self._running = True
        if self.device.type == "cuda" and self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        self._stop.clear()
        self._dispatcher_t = threading.Thread(
            target=self._dispatcher_loop, name="spmv-dispatch", daemon=True)
        self._collector_t = threading.Thread(
            target=self._collector_loop, name="spmv-collect", daemon=True)
        self._dispatcher_t.start()
        self._collector_t.start()
        obs.instant("pipeline-start", inflight_depth=self.inflight_depth)
        return self

    def stop(self, drain: bool = True, timeout: float = 60.0) -> None:
        """Stop the stage threads; by default drain in-flight work first.

        Parked requests (still-encoding matrices) stay queued — a later
        synchronous ``flush()`` or restarted pipeline picks them up.
        """
        with self._lock:
            if not self._running:
                return
        if drain:
            try:
                self.drain(timeout=timeout)
            except TimeoutError:
                log.warning("pipeline stop: drain timed out after %.1fs",
                            timeout)
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        if self._dispatcher_t is not None:
            self._dispatcher_t.join(timeout)
        self._inflight.put(None)          # collector shutdown sentinel
        if self._collector_t is not None:
            self._collector_t.join(timeout)
        with self._lock:
            self._running = False
        obs.instant("pipeline-stop")

    def __enter__(self) -> "SpMVPipeline":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def drain(self, timeout: float | None = None) -> None:
        """Block until every dispatchable request has been deposited.

        Parked requests (waiting on background encodes) do not block the
        drain — they are not dispatchable yet, exactly as the synchronous
        ``flush()`` leaves them queued.
        """
        deadline = (None if timeout is None
                    else time.perf_counter() + timeout)
        with self._result_cv:
            self._cv.notify_all()         # kick the dispatcher
            while (len(self._queue) - self._parked > 0
                   or self._in_system > 0):
                if deadline is not None \
                        and time.perf_counter() >= deadline:
                    raise TimeoutError(
                        f"pipeline did not drain within {timeout}s "
                        f"(queued={len(self._queue)}, "
                        f"in_system={self._in_system})")
                self._result_cv.wait(0.05)

    # -- submission -------------------------------------------------------
    def submit(self, matrix_id: str, x, alpha: float = 1.0,
               beta: float = 0.0, y=None, owner: str | None = None) -> int:
        """Queue one ``y_out = α·A·x + β·y`` request; returns a ticket.

        Matrices still encoding in the background (``put(blocking=False)``)
        are accepted without blocking: the request parks with no operator
        and re-enters the pipeline when the registry reports the encode
        settled (pipelined mode) or at a later ``flush`` (synchronous
        mode).  Under a mesh the submit waits for the encode instead and
        binds the operator here, on every rank at the same submit, so no
        rank's flush depends on when its encode finished.

        ``owner`` names the caller for the per-owner admission cap and
        result queue (default: the submitting thread's name).  Depending
        on the admission policy this call may block (``block``) or raise
        :class:`AdmissionRejected` (``reject`` / block timeout).
        """
        with obs.span("submit", matrix=matrix_id):
            expect = None
            if self._bind_now(matrix_id):       # KeyError when unknown
                op = self._get_op(matrix_id)    # refreshes LRU
                m_len, k_len = op.shape
            else:
                op = None                       # resolved at coalesce time
                m_len, k_len = self.registry.shape(matrix_id)
                expect = self.registry.content(matrix_id)
            # Copy on enqueue: the caller may reuse/mutate its buffer before
            # flush (np.asarray would alias an already-float32 input).
            # Boundary dtype policy (same as SerpensOperator): floating
            # inputs cast to fp32 here, non-floating inputs are a bug.
            x = np.asarray(x)
            if not np.issubdtype(x.dtype, np.floating):
                raise TypeError(
                    f"x must have a floating dtype, got {x.dtype} (cast "
                    f"explicitly if an integer input is intentional)")
            x = np.array(x, np.float32)
            if x.ndim != 1 or x.shape[0] != k_len:
                raise ValueError(
                    f"x has shape {x.shape}; matrix {matrix_id!r} needs a "
                    f"length-{k_len} vector")
            if beta != 0.0 and y is None:
                raise ValueError("beta != 0 requires y")
            if y is not None:
                if not np.issubdtype(np.asarray(y).dtype, np.floating):
                    raise TypeError(
                        f"y must have a floating dtype, got "
                        f"{np.asarray(y).dtype}")
                y = np.array(y, np.float32)
                if y.shape != (m_len,):
                    raise ValueError(
                        f"y has shape {y.shape}; expected ({m_len},)")
            if owner is None:
                owner = threading.current_thread().name
            req = SpMVRequest(
                ticket=-1, matrix_id=matrix_id, op=op, x=x,
                alpha=float(alpha), beta=float(beta), y=y,
                submit_time=time.perf_counter(), expect_content=expect,
                owner=owner, parked=op is None)
            ticket = self._admit(req)
            if op is None:
                self._listen_for(matrix_id, expect)
            obs.flow_start("request", ticket, matrix=matrix_id)
        return ticket

    def submit_solve(self, matrix_id: str, kind: str, *, b=None,
                     owner: str | None = None, **solve_kw) -> int:
        """Queue a whole solver run (:data:`repro_torch.solvers.SOLVERS`)
        through the same admission gate; returns a ticket whose result
        carries the solver outcome in ``SpMVResult.solve`` (and the
        solution vector in ``y``).

        ``b`` is the right-hand side for ``conjugate_gradient``/``cg``
        (required there, rejected elsewhere); solver keywords (``tol``,
        ``max_iters``, ``fused``, ...) pass through ``solve_kw``.  Solves
        dispatch as singleton batches: they never coalesce with SpMV
        requests, but they queue, shed, and account like them.
        """
        if kind not in solvers.SOLVERS:
            raise ValueError(f"unknown solver {kind!r}; known: "
                             f"{sorted(solvers.SOLVERS)}")
        needs_b = solvers.SOLVERS[kind] is solvers.conjugate_gradient
        if needs_b and b is None:
            raise ValueError(f"solver {kind!r} requires b")
        if not needs_b and b is not None:
            raise ValueError(f"solver {kind!r} takes no b")
        with obs.span("submit", matrix=matrix_id, kind=f"solve:{kind}"):
            expect = None
            if self._bind_now(matrix_id):
                op = self._get_op(matrix_id)
                m_len, _ = op.shape
            else:
                op = None
                m_len, _ = self.registry.shape(matrix_id)
                expect = self.registry.content(matrix_id)
            kw = dict(solve_kw)
            if b is not None:
                b = np.asarray(b)
                if not np.issubdtype(b.dtype, np.floating):
                    raise TypeError(
                        f"b must have a floating dtype, got {b.dtype}")
                b = np.array(b, np.float32)
                if b.ndim != 1 or b.shape[0] != m_len:
                    raise ValueError(
                        f"b has shape {b.shape}; matrix {matrix_id!r} "
                        f"needs a length-{m_len} vector")
                kw["b"] = b
            if owner is None:
                owner = threading.current_thread().name
            req = SpMVRequest(
                ticket=-1, matrix_id=matrix_id, op=op,
                x=b, alpha=1.0, beta=0.0, y=None,
                submit_time=time.perf_counter(), expect_content=expect,
                owner=owner, parked=op is None, kind="solve",
                solve_kind=kind, solve_kw=kw)
            ticket = self._admit(req)
            if op is None:
                self._listen_for(matrix_id, expect)
            obs.flow_start("request", ticket, matrix=matrix_id)
        return ticket

    def solve(self, matrix_id: str, kind: str, *, b=None,
              owner: str | None = None, timeout: float | None = 60.0,
              **solve_kw) -> SpMVResult:
        """Convenience: ``submit_solve`` + (synchronous mode) ``flush`` +
        ``result``; returns the :class:`SpMVResult` (solver outcome in
        ``.solve``, solution vector in ``.y``)."""
        ticket = self.submit_solve(matrix_id, kind, b=b, owner=owner,
                                   **solve_kw)
        if not self._running:
            self.flush()
        return self.result(ticket, timeout=timeout)

    def update(self, matrix_id: str, delta_rows, delta_cols,
               delta_vals=None, *, mode: str = "add") -> str:
        """Apply a COO delta to a served matrix (incremental re-encode).

        Versioning is snapshot-at-submit: requests already queued (or
        in-flight) keep the operator they captured when they were
        submitted and are served against the pre-update matrix; every
        submit after this call sees the new version.  The two versions
        never mix inside one batch — batches group on the operator
        identity, not the id.  Requests submitted while their matrix was
        still background-encoding hold no operator yet — they pin the
        content hash instead, and an update (or re-put) landing before
        they dispatch fails those tickets explicitly rather than serving
        a version they were not submitted against.
        """
        return self.registry.update(matrix_id, delta_rows, delta_cols,
                                    delta_vals, mode=mode)

    # -- admission --------------------------------------------------------
    def _admit(self, req: SpMVRequest) -> int:
        """Run the admission gate; enqueue + assign a ticket, or raise."""
        adm = self.admission
        deadline = (None if adm.block_timeout is None
                    else time.perf_counter() + adm.block_timeout)
        waited = False
        with self._cv:
            while True:
                scope = self._over_limit_locked(req.owner)
                if scope is None:
                    ticket = self._next_ticket
                    self._next_ticket += 1
                    req.ticket = ticket
                    self._queue.append(req)
                    self._owner_pending[req.owner] = \
                        self._owner_pending.get(req.owner, 0) + 1
                    if req.parked:
                        self._parked += 1
                        if self._running:
                            # Pipelined mode never polls at flush, so the
                            # deferral is counted where it happens: here.
                            self._m_deferred.inc()
                    self._m_admitted.inc()
                    self._sync_gauges_locked()
                    self._cv.notify_all()
                    return ticket
                if adm.policy == "reject":
                    self._m_rejected.inc(scope=scope)
                    raise AdmissionRejected(
                        f"admission queue full ({scope} limit: "
                        f"{len(self._queue)} queued, owner={req.owner!r})")
                if adm.policy == "shed-oldest":
                    victim = self._shed_victim_locked(scope, req.owner)
                    if victim is None:      # nothing shed-able
                        self._m_rejected.inc(scope=scope)
                        raise AdmissionRejected(
                            f"admission queue full ({scope} limit) and "
                            f"nothing shed-able")
                    self._shed_locked(victim)
                    continue                # re-check: one shed, one slot
                # block: wait for space (bounded by block_timeout).
                if not waited:
                    waited = True
                    self._m_block_waits.inc()
                remaining = (None if deadline is None
                             else deadline - time.perf_counter())
                if remaining is not None and remaining <= 0:
                    self._m_rejected.inc(scope="timeout")
                    raise AdmissionRejected(
                        f"submit blocked longer than block_timeout="
                        f"{adm.block_timeout}s ({scope} limit)")
                self._cv.wait(0.5 if remaining is None
                              else min(remaining, 0.5))

    def _over_limit_locked(self, owner: str) -> str | None:
        """Which admission limit the next enqueue would break, if any."""
        if len(self._queue) >= self.admission.max_pending:
            return "queue"
        cap = self.admission.per_owner_cap
        if cap is not None and self._owner_pending.get(owner, 0) >= cap:
            return "owner"
        return None

    def _shed_victim_locked(self, scope: str,
                            owner: str) -> SpMVRequest | None:
        """The request shed-oldest evicts: the queue's oldest entry, or —
        when only the per-owner cap is exceeded — that owner's oldest."""
        if scope == "owner":
            for r in self._queue:
                if r.owner == owner:
                    return r
            return None
        return self._queue[0] if self._queue else None

    def _shed_locked(self, victim: SpMVRequest) -> None:
        self._queue.remove(victim)
        self._owner_dec_locked(victim.owner)
        if victim.parked:
            self._parked -= 1
        owner = victim.owner or "unknown"
        err = RequestShed(
            f"request {victim.ticket} shed by admission control "
            f"(shed-oldest, queue at capacity)")
        self._m_shed.inc(owner=owner)  # repro-lint: disable=stat-lock
        self._deposit_locked(SpMVResult(
            ticket=victim.ticket, y=None, latency_s=0.0, batch_size=0,
            bucket_n=0, stream_bytes_per_vector=0.0, error=err,
            owner=victim.owner))
        self._sync_gauges_locked()
        self._result_cv.notify_all()
        obs.instant("request-shed", ticket=victim.ticket, owner=owner)
        log.warning("spmv_request_shed ticket=%d owner=%s queue_depth=%d",
                    victim.ticket, owner, len(self._queue))

    def _owner_dec_locked(self, owner: str) -> None:
        n = self._owner_pending.get(owner, 0) - 1
        if n > 0:
            self._owner_pending[owner] = n
        else:
            self._owner_pending.pop(owner, None)

    def _sync_gauges_locked(self) -> None:
        self._g_depth.set(len(self._queue))
        self._g_parked.set(self._parked)
        self._g_stored.set(self._stored)

    def _listen_for(self, matrix_id: str, content: str | None) -> None:
        """Register one registry on_ready listener per (id, content)
        generation; firing un-parks every matching queued request.

        Called WITHOUT the pipeline lock: the registry may run the
        callback synchronously, and the callback takes the lock.
        """
        key = (matrix_id, content or "")
        with self._lock:
            if key in self._listened:
                return
            self._listened.add(key)
        try:
            self.registry.on_ready(
                matrix_id, lambda: self._on_matrix_settled(key))
        except Exception:
            with self._lock:
                self._listened.discard(key)
            raise

    def _on_matrix_settled(self, key: tuple[str, str]) -> None:
        """Registry listener: the encode settled (installed, failed, or
        cancelled) — un-park matching requests and wake the dispatcher.
        The dispatcher (or next flush) resolves what settled *to*."""
        matrix_id, _ = key
        with self._cv:
            self._listened.discard(key)
            for r in self._queue:
                if r.parked and r.matrix_id == matrix_id:
                    r.parked = False
                    self._parked -= 1
            self._sync_gauges_locked()
            self._cv.notify_all()
        obs.instant("encode-settled", matrix=matrix_id)

    # -- introspection ----------------------------------------------------
    @property
    def pending(self) -> int:
        with self._lock:            # submit/flush mutate under the lock
            return len(self._queue)

    def _stats_locked(self) -> ServiceStats:
        """Assemble the dataclass view from the metrics (lock held, so a
        concurrent dispatch can't land between two counter reads)."""
        return ServiceStats(
            batches=int(self._m_batches.total()),
            stream_bytes=int(self._m_stream_bytes.total()),
            vectors=int(self._m_vectors.total()),
            deferred=int(self._m_deferred.total()),
            results_dropped=int(self._m_dropped.total()),
            admitted=int(self._m_admitted.total()),
            rejected=int(self._m_rejected.total()),
            shed=int(self._m_shed.total()))

    @property
    def stats(self) -> ServiceStats:
        """Consistent dataclass view over the serving metrics (reads
        under the lock — cross-metric ratios must never tear)."""
        with self._lock:
            return self._stats_locked()

    def stats_snapshot(self) -> ServiceStats:
        """Alias of :attr:`stats`, kept for API compatibility."""
        return self.stats

    def results_dropped_by_owner(self) -> dict[str, int]:
        """{owner: dropped results} — the per-caller loss accounting."""
        return {(dict(k).get("owner", "unknown")): int(v)
                for k, v in self._m_dropped.items().items()}

    def snapshot(self) -> dict:
        """Serving + preprocessing economics in one dict.

        Combines the micro-batcher's amortization stats with the
        admission/queue state and the registry's encode-side numbers
        (wall-time, slot throughput): the host encode is the cold-start
        cost of every matrix this service fronts, and the incremental
        update path is its steady-state cost under a changing matrix, so
        a dashboard wants all three on the same page.  Latency
        percentiles are exact over the histogram's retained window.
        """
        with self._lock:
            ss = self._stats_locked()
            queue_depth = len(self._queue)
            parked = self._parked
            inflight = self._inflight_n
            stored = self._stored
        rs = self.registry.stats_snapshot()   # consistent under its lock
        lat = self._m_dispatch_lat
        adm = self.admission
        return {
            "batches": ss.batches,
            "vectors": ss.vectors,
            "mean_batch_size": ss.mean_batch_size,
            "amortized_bytes_per_vector": ss.amortized_bytes_per_vector,
            "deferred": ss.deferred,
            "results_dropped": ss.results_dropped,
            "results_dropped_by_owner": self.results_dropped_by_owner(),
            "dispatch_latency_p50": lat.percentile(50),
            "dispatch_latency_p95": lat.percentile(95),
            "dispatch_latency_p99": lat.percentile(99),
            "dispatch_latency_mean": lat.mean,
            "pipelined": self._running,
            "queue_depth": queue_depth,
            "parked": parked,
            "inflight_batches": inflight,
            "stored_results": stored,
            "admission": {
                "policy": adm.policy,
                "max_pending": adm.max_pending,
                "per_owner_cap": adm.per_owner_cap,
                "block_timeout": adm.block_timeout,
                "admitted": ss.admitted,
                "rejected": ss.rejected,
                "shed": ss.shed,
                "block_waits": int(self._m_block_waits.total()),
            },
            "encodes": rs.encodes,
            "encode_seconds": rs.encode_seconds,
            "mean_encode_s": (rs.encode_seconds / rs.encodes
                              if rs.encodes else 0.0),
            "encode_slots_per_s": rs.encode_slots_per_s,
            "background_puts": rs.background_puts,
            "queue_seconds": rs.queue_seconds,
            "delta_encodes": rs.delta_encodes,
            "delta_seconds": rs.delta_seconds,
            "delta_slots_per_s": rs.delta_slots_per_s,
            "tuner": (None if self.registry.tuner is None
                      else self.registry.tuner.snapshot()),
            "tuner_observations": dict(self._tune_obs),
        }

    def _bind_now(self, matrix_id: str) -> bool:
        """Whether a submit binds its operator now (the matrix serves;
        always under a mesh, where the submit waits for a pending encode)
        or parks the request.  KeyError for unknown ids."""
        return self.registry.ready(matrix_id) or self.mesh is not None

    def _get_op(self, matrix_id: str):
        """The registry's operator for this service: on its mesh axis when
        it has one (waiting for a pending encode)."""
        return self.registry.get(matrix_id, mesh=self.mesh, axis=self.axis,
                                 partition=self.partition)

    # -- coalesce (stage 2) ----------------------------------------------
    def _resolve_op(self, req: SpMVRequest):
        """Bind a deferred request's operator; raises when the matrix was
        replaced/updated/reshaped while its encode was pending."""
        op = self._get_op(req.matrix_id)
        # The request was validated against the *pending* matrix at
        # submit; if the id was re-registered or updated since (content no
        # longer what it pinned), fail this ticket explicitly — never
        # silently serve a matrix the caller did not submit against, and
        # never let a stale-shaped x poison the whole batch.
        if (req.expect_content is not None
                and self.registry.content(req.matrix_id)
                != req.expect_content):
            raise RuntimeError(
                f"matrix {req.matrix_id!r} was replaced or "
                f"updated while its encode was pending")
        if req.kind == "solve":
            if req.x is not None and req.x.shape[0] != op.shape[0]:
                raise RuntimeError(
                    f"matrix {req.matrix_id!r} changed shape to "
                    f"{op.shape} while its encode was pending")
        elif req.x.shape[0] != op.shape[1] or (
                req.y is not None
                and req.y.shape[0] != op.shape[0]):
            raise RuntimeError(
                f"matrix {req.matrix_id!r} changed shape to "
                f"{op.shape} while its encode was pending")
        return op

    def _take_ready(self, *, poll_parked: bool) -> _TakeResult:
        """Pop dispatchable requests off the wait queue and bind deferred
        operators.

        ``poll_parked=True`` (synchronous flush) takes everything and
        polls the registry for parked requests — ready ones bind, the
        rest re-queue at the front (``stats.deferred``), exactly the
        pre-pipeline behavior.  ``poll_parked=False`` (dispatcher) takes
        only un-parked requests; parked ones wait for their on_ready
        re-entry.  Returns (ready_requests, taken, still_deferred).
        """
        with self._lock:
            if poll_parked:
                taken = list(self._queue)
                self._queue.clear()
            else:
                taken = [r for r in self._queue if not r.parked]
                if taken:
                    remaining = [r for r in self._queue if r.parked]
                    self._queue.clear()
                    self._queue.extend(remaining)
            for r in taken:
                self._owner_dec_locked(r.owner)
                if r.parked:
                    self._parked -= 1
                    r.parked = False
            self._in_system += len(taken)
            self._sync_gauges_locked()
            self._cv.notify_all()   # queue shrank: wake blocked submits
        if not taken:
            return [], 0, 0
        # Resolve requests submitted against matrices that were still
        # encoding: ready now → bind their operator; still encoding →
        # re-queue (re-park); gone (evicted mid-encode / encode failed) →
        # deposit an error result for the submitter to collect.  Registry
        # calls run outside the pipeline lock — get() may re-bind.
        ready_reqs: list[SpMVRequest] = []
        deferred: list[SpMVRequest] = []
        failed: list[SpMVResult] = []
        for req in taken:
            if req.op is None:
                try:
                    if not self.registry.ready(req.matrix_id):
                        deferred.append(req)
                        continue
                    req.op = self._resolve_op(req)
                except Exception as e:  # noqa: BLE001 — routed to caller
                    obs.instant("request-failed", ticket=req.ticket,
                                matrix=req.matrix_id, error=str(e))
                    failed.append(SpMVResult(
                        ticket=req.ticket, y=None, latency_s=0.0,
                        batch_size=0, bucket_n=0,
                        stream_bytes_per_vector=0.0, error=e,
                        owner=req.owner))
                    continue
            ready_reqs.append(req)
        if deferred or failed:
            with self._result_cv:
                if deferred:
                    for req in deferred:
                        req.parked = True
                    self._parked += len(deferred)
                    self._queue.extendleft(reversed(deferred))
                    for req in deferred:
                        self._owner_pending[req.owner] = \
                            self._owner_pending.get(req.owner, 0) + 1
                    if not self._running:
                        # Synchronous mode counts deferral per flush (the
                        # pipelined gate counted it at submit).
                        self._m_deferred.add(len(deferred))
                self._in_system -= len(deferred) + len(failed)
                for res in failed:
                    self._deposit_locked(res)
                self._sync_gauges_locked()
                self._result_cv.notify_all()
                self._cv.notify_all()
            for req in deferred:
                obs.instant("request-deferred", ticket=req.ticket,
                            matrix=req.matrix_id)
                # Re-arm the re-entry in case the unpark raced a re-put.
                self._listen_for(req.matrix_id, req.expect_content)
        return ready_reqs, len(taken), len(deferred)

    def _coalesce(self, ready_reqs: list[SpMVRequest]) -> list[list]:
        """Group on the operator captured at submit: still valid even if
        the registry evicted the id since, and two requests only share a
        batch when they truly share a matrix (an id re-registered with
        new content mid-queue lands in its own group).  Solve requests
        are singleton batches."""
        with obs.span("coalesce", requests=len(ready_reqs)) as co_sp:
            groups: dict[object, list[SpMVRequest]] = {}
            for req in ready_reqs:
                key = (("solve", req.ticket) if req.kind == "solve"
                       else id(req.op))
                groups.setdefault(key, []).append(req)
            batches = [reqs[i:i + self.max_bucket]
                       for reqs in groups.values()
                       for i in range(0, len(reqs), self.max_bucket)]
            co_sp.args["batches"] = len(batches)
        return batches

    # -- dispatch (stage 3) ----------------------------------------------
    def _launch(self, op, batch: list[SpMVRequest]) -> _Launched:
        """Pack + launch one SpMM batch; returns without device-blocking
        (CUDA launches are asynchronous) so the next batch's host work can
        overlap.  In pipelined mode the batch runs on the dispatcher's own
        stream and an event marks its end for the collector."""
        n = len(batch)
        width = bucket_width(n, self.max_bucket)
        stream = self._stream if self._running else None
        dev = op.device
        if stream is not None:
            # The operator's tensors were copied to the card on the current
            # stream at bind time; the batch must not read them earlier.
            stream.wait_stream(torch.cuda.current_stream(dev))
        with obs.span("dispatch", matrix=batch[0].matrix_id, batch=n,
                      bucket=width), _on_stream(stream):
            for req in batch:
                obs.flow_step("request", req.ticket)
            t_comp = time.perf_counter()
            if n == 1 and width == 1:
                # Single-request fast path: the paper's plain SpMV.
                req = batch[0]
                with obs.span("compute", kind="matvec"):
                    acc = op.matvec(req.x, backend=self.backend)
                    out = req.alpha * acc
                    if req.beta != 0.0:
                        out = out + req.beta * torch.from_numpy(req.y).to(dev)
            else:
                with obs.span("pack", bucket=width):
                    x_mat = np.zeros((op.shape[1], width), np.float32)
                    y_mat = np.zeros((op.shape[0], width), np.float32)
                    alphas = np.zeros((width,), np.float32)
                    betas = np.zeros((width,), np.float32)
                    for j, req in enumerate(batch):
                        x_mat[:, j] = req.x
                        alphas[j] = req.alpha
                        betas[j] = req.beta
                        if req.y is not None:
                            y_mat[:, j] = req.y
                with obs.span("compute", kind="matmat"):
                    acc = op.matmat(x_mat, backend=self.backend)  # raw A @ X
                    out = (acc * torch.from_numpy(alphas).to(dev)[None, :]
                           + torch.from_numpy(y_mat).to(dev)
                           * torch.from_numpy(betas).to(dev)[None, :])
            done = None
            if out.is_cuda:
                done = torch.cuda.Event()
                done.record()
            with self._lock:
                self._m_batches.inc()
                self._m_vectors.add(n)
                self._m_stream_bytes.add(op.stream_bytes)
                self._m_batch_size.observe(n)
        return _Launched(batch=batch, op=op, out=out, width=width,
                         t_compute=t_comp, done=done, stream=stream)

    def _rollback_launch_locked(self, op, batch: list[SpMVRequest]) -> None:
        """Undo one launched batch's counters (lock held) so a failure is
        never observable as served traffic."""
        self._m_batches.add(-1)  # repro-lint: disable=stat-lock
        self._m_vectors.add(-len(batch))  # repro-lint: disable=stat-lock
        self._m_stream_bytes.add(-op.stream_bytes)  # repro-lint: disable=stat-lock

    # -- collect (stage 4) -----------------------------------------------
    def _collect(self, launched: _Launched) -> dict[int, SpMVResult]:
        """Device-block on a launched batch and build its results
        (deposit is the caller's job)."""
        batch, op = launched.batch, launched.op
        n = len(batch)
        with obs.span("collect", matrix=batch[0].matrix_id, batch=n):
            with obs.span("device-block"):
                if launched.done is not None:
                    launched.done.synchronize()
                # The copy runs on the stream that produced `out`, so the
                # tensor never crosses streams.
                with _on_stream(launched.stream):
                    ys = launched.out.cpu().numpy()
            if ys.ndim == 1:
                ys = ys[:, None]
        done = time.perf_counter()
        with self._lock:
            for req in batch:
                self._m_dispatch_lat.observe(done - req.submit_time)
        # Auto-tuning feedback: measured slots/s for this dispatch
        # (device-blocked, so compute_s is real wall time; it starts
        # before the host packs the batch, and in pipelined mode it also
        # includes in-flight queue residency) flows into the tuner; every
        # retune_every observations the registry re-consults the ranking
        # and may swap the plan.
        compute_s = max(done - launched.t_compute, 1e-9)
        mid = batch[0].matrix_id
        if self.mesh is not None \
                and self.registry.tune_decision(mid) is not None:
            compute_s = self._agreed_seconds(op, compute_s)
        if self.registry.record_observation(
                mid, slots_per_s=op.padded_slots / compute_s,
                requests_per_s=n / compute_s):
            with self._lock:
                count = self._tune_obs.get(mid, 0) + 1
                self._tune_obs[mid] = count
            if self.retune_every and count % self.retune_every == 0:
                self.registry.retune(mid)
        bytes_per_vec = op.stream_bytes / n
        results: dict[int, SpMVResult] = {}
        for j, req in enumerate(batch):
            results[req.ticket] = SpMVResult(
                ticket=req.ticket, y=ys[:, j],
                latency_s=done - req.submit_time,
                batch_size=n, bucket_n=launched.width,
                stream_bytes_per_vector=bytes_per_vec,
                owner=req.owner)
        return results

    def _agreed_seconds(self, op, seconds: float) -> float:
        """The slowest rank's seconds for this dispatch (an ``all_reduce``
        of the maximum over the axis's group), so every rank feeds the
        tuner the same observation and re-tunes at the same dispatch.
        Every rank calls it: the entry is auto-tuned on all or on none."""
        t = torch.tensor([seconds], dtype=torch.float64, device=op.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX,
                        group=self.mesh.get_group(self.axis))
        return float(t)

    def _solve_one(self, req: SpMVRequest) -> SpMVResult:
        """Run one solver request end to end (device-blocking: the
        solution is copied to the host).  Never raises — failures become
        the ticket's error result.  In pipelined mode the solve runs on
        the dispatcher's stream."""
        op = req.op
        stream = self._stream if self._running else None
        try:
            if stream is not None:
                stream.wait_stream(torch.cuda.current_stream(op.device))
            with obs.span("dispatch", matrix=req.matrix_id,
                          kind=f"solve:{req.solve_kind}"), \
                    _on_stream(stream):
                obs.flow_step("request", req.ticket)
                with obs.span("compute", kind=req.solve_kind):
                    sres = solvers.solve(op, req.solve_kind,
                                         **(req.solve_kw or {}))
                with obs.span("device-block"):
                    y = sres.x.cpu().numpy()
            done = time.perf_counter()
            iters = max(int(getattr(sres, "iterations", 1)), 1)
            # A solve streams A once per iteration — that is its serving
            # economics, so stream-bytes charge iters full passes.
            with self._lock:
                self._m_batches.inc()
                self._m_vectors.add(1)
                self._m_stream_bytes.add(op.stream_bytes * iters)
                self._m_batch_size.observe(1)
                self._m_dispatch_lat.observe(done - req.submit_time)
            return SpMVResult(
                ticket=req.ticket, y=y, latency_s=done - req.submit_time,
                batch_size=1, bucket_n=1,
                stream_bytes_per_vector=float(op.stream_bytes * iters),
                owner=req.owner, solve=sres)
        except Exception as e:  # noqa: BLE001 — routed to the caller
            obs.instant("request-failed", ticket=req.ticket,
                        matrix=req.matrix_id, error=str(e))
            return SpMVResult(
                ticket=req.ticket, y=None, latency_s=0.0, batch_size=0,
                bucket_n=0, stream_bytes_per_vector=0.0, error=e,
                owner=req.owner)

    # -- result store -----------------------------------------------------
    def _deposit_locked(self, res: SpMVResult) -> None:
        """File a finished result in its owner's bounded queue (lock
        held).

        Dropping an uncollected result is silent data loss for its
        caller, so every overflow drop evicts the *owner's own* oldest
        result (never another caller's), is charged to that owner
        (``spmv_results_dropped_total{owner=...}``), and is logged as a
        structured warning.
        """
        owner = res.owner or "unknown"
        q = self._results.setdefault(owner, OrderedDict())
        q[res.ticket] = res
        self._ticket_owner[res.ticket] = owner
        self._stored += 1
        while len(q) > self.max_stored_results:
            _, old = q.popitem(last=False)
            self._ticket_owner.pop(old.ticket, None)
            self._stored -= 1
            self._m_dropped.inc(owner=owner)  # repro-lint: disable=stat-lock
            obs.instant("result-dropped", ticket=old.ticket, owner=owner)
            log.warning(
                "spmv_result_dropped ticket=%d owner=%s matrix_batch=%d "
                "stored=%d max_stored_results=%d",
                old.ticket, owner, old.batch_size, len(q),
                self.max_stored_results)

    def _deposit_results(self, results: dict[int, SpMVResult]) -> None:
        """Deposit a batch of finished results and retire them from the
        in-system count (drain progress)."""
        with self._result_cv:
            for res in results.values():
                self._deposit_locked(res)
            self._in_system -= len(results)
            self._sync_gauges_locked()
            self._result_cv.notify_all()

    def _fail_batch(self, batch: list[SpMVRequest],
                    exc: BaseException) -> None:
        """Pipelined-mode failure path: the batch becomes per-request
        error results (no caller's flush to re-raise into)."""
        obs.instant("batch-failed", requests=len(batch), error=str(exc))
        self._deposit_results({
            req.ticket: SpMVResult(
                ticket=req.ticket, y=None, latency_s=0.0, batch_size=0,
                bucket_n=0, stream_bytes_per_vector=0.0, error=exc,
                owner=req.owner)
            for req in batch})

    def result(self, ticket: int, timeout: float | None = None
               ) -> SpMVResult:
        """Collect (and remove) one ticket's result from its owner queue.

        Blocks until the pipeline (or some thread's ``flush``) deposits
        it.  Raises ``TimeoutError`` after ``timeout`` seconds,
        ``KeyError`` for tickets that were never issued, and re-raises
        the stored error of requests that can never complete (including
        :class:`RequestShed`).  Each ticket is collectable exactly once.
        """
        deadline = (None if timeout is None
                    else time.perf_counter() + timeout)
        with obs.span("result-collect", ticket=ticket):
            with self._result_cv:
                if not 0 <= ticket < self._next_ticket:
                    raise KeyError(f"unknown ticket {ticket}")
                while True:
                    owner = self._ticket_owner.get(ticket)
                    if owner is not None:
                        q = self._results.get(owner)
                        if q is not None and ticket in q:
                            res = q.pop(ticket)
                            if not q:
                                del self._results[owner]
                            del self._ticket_owner[ticket]
                            self._stored -= 1
                            self._sync_gauges_locked()
                            break
                    remaining = (None if deadline is None
                                 else deadline - time.perf_counter())
                    if remaining is not None and remaining <= 0:
                        raise TimeoutError(
                            f"ticket {ticket} not completed within "
                            f"{timeout}s")
                    self._result_cv.wait(remaining)
            obs.flow_end("request", ticket)
        if res.error is not None:
            raise res.error
        return res

    # -- synchronous drive ------------------------------------------------
    def flush(self) -> dict[int, SpMVResult]:
        """Synchronous mode: dispatch all dispatchable pending requests;
        returns {ticket: result} for the requests *this call* dispatched.
        Pipelined mode: a drain barrier — blocks until the dispatcher has
        deposited everything dispatchable, then returns ``{}`` (results
        live in the per-owner queues; collect via :meth:`result`).

        Requests whose matrix is still background-encoding stay queued
        (``stats.deferred``) — the flushing thread never blocks on a cold
        start.  Every finished result is also deposited in its owner's
        result queue, so concurrent submitters collect their own tickets
        via :meth:`result` even when *this* thread's flush dispatched
        them.
        """
        if self._running:
            self.drain()
            return {}
        t_flush = time.perf_counter()
        with obs.span("flush") as flush_sp:
            results = self._flush_inner(flush_sp)
        dt_flush = time.perf_counter() - t_flush
        with self._lock:
            self._m_flush.observe(dt_flush)
        return results

    def _flush_inner(self, flush_sp) -> dict[int, SpMVResult]:
        ready_reqs, n_taken, n_deferred = self._take_ready(poll_parked=True)
        batches = self._coalesce(ready_reqs)
        flush_sp.args.update(requests=n_taken, batches=len(batches),
                             deferred=n_deferred)
        spmv_results: dict[int, SpMVResult] = {}
        solve_results: dict[int, SpMVResult] = {}
        launched: list[tuple] = []    # (op, batch) with counted stats
        try:
            for batch in batches:
                if batch[0].kind == "solve":
                    res = self._solve_one(batch[0])   # never raises
                    solve_results[res.ticket] = res
                    continue
                lb = self._launch(batch[0].op, batch)
                launched.append((lb.op, batch))
                spmv_results.update(self._collect(lb))
        except Exception:
            # The exception discards `spmv_results`, so requests from
            # already-dispatched batches would be stranded too: re-queue
            # every SpMV request (SpMV is pure — re-dispatch on the next
            # flush is safe) and roll back the launched batches' stats,
            # atomically with the re-queue so a concurrent snapshot never
            # sees the half-rolled-back state.  Completed solves are
            # final work — they deposit rather than re-run.
            with self._result_cv:
                for op, b in launched:
                    self._rollback_launch_locked(op, b)
                requeue = [r for b in batches for r in b
                           if r.kind != "solve"]
                self._queue.extendleft(reversed(requeue))
                for r in requeue:
                    self._owner_pending[r.owner] = \
                        self._owner_pending.get(r.owner, 0) + 1
                self._in_system -= len(requeue)
                for res in solve_results.values():
                    self._deposit_locked(res)
                self._in_system -= len(solve_results)
                self._sync_gauges_locked()
                self._result_cv.notify_all()
                self._cv.notify_all()
            obs.instant("flush-failed", batches_rolled_back=len(launched))
            raise
        results = {**spmv_results, **solve_results}
        self._deposit_results(results)
        return results

    def serve(self, requests, timeout: float | None = 60.0
              ) -> list[np.ndarray]:
        """Convenience: submit an iterable of (matrix_id, x[, alpha, beta])
        tuples, flush (or drain, when pipelined), and return the y's in
        submission order.

        Collects through the per-owner result queues, so concurrent
        ``serve``/``flush`` calls on other threads can interleave freely:
        whichever thread's flush dispatches a ticket, its submitter still
        receives it.  Re-flushes while its matrices finish background
        encodes; raises ``TimeoutError`` if not all results arrive within
        ``timeout`` seconds.
        """
        tickets = [self.submit(*r) for r in requests]
        deadline = (None if timeout is None
                    else time.perf_counter() + timeout)
        out: dict[int, SpMVResult] = {}
        waiting = list(tickets)
        while waiting:
            flushed = self.flush()
            for t in list(waiting):
                try:
                    out[t] = self.result(t, timeout=0.05)
                except TimeoutError:
                    # Deferred, another thread's flush, or dropped from
                    # the owner queue — our own flush's return still has
                    # the latter's result (synchronous mode).
                    if t not in flushed:
                        continue
                    out[t] = flushed[t]
                    obs.flow_end("request", t)
                waiting.remove(t)
            if waiting and deadline is not None \
                    and time.perf_counter() >= deadline:
                raise TimeoutError(
                    f"{len(waiting)} of {len(tickets)} requests not "
                    f"served within {timeout}s")
        return [out[t].y for t in tickets]

    # -- pipelined stage threads ------------------------------------------
    def _dispatchable_locked(self) -> int:
        return len(self._queue) - self._parked

    def _dispatcher_loop(self) -> None:
        """Stage thread: coalesce + launch.  Blocks on the bounded
        in-flight queue when the collector falls behind (backpressure)."""
        while True:
            with self._cv:
                while not self._stop.is_set() \
                        and self._dispatchable_locked() == 0:
                    self._cv.wait(0.5)
                if self._stop.is_set():
                    return
            try:
                self._pump_once()
            except Exception:   # noqa: BLE001 — stage must survive
                log.exception("pipeline dispatcher iteration failed")

    def _pump_once(self) -> None:
        ready_reqs, _, _ = self._take_ready(poll_parked=False)
        if not ready_reqs:
            return
        for batch in self._coalesce(ready_reqs):
            if batch[0].kind == "solve":
                res = self._solve_one(batch[0])   # never raises
                self._deposit_results({res.ticket: res})
                continue
            try:
                lb = self._launch(batch[0].op, batch)
            except Exception as e:  # noqa: BLE001 — per-batch containment
                self._fail_batch(batch, e)
                continue
            with self._lock:
                self._inflight_n += 1
                self._g_inflight.set(self._inflight_n)
            # Bounded hand-off: blocks at inflight_depth, which is what
            # stalls coalesce of batch N+2 until batch N collects.
            self._inflight.put(lb)

    def _collector_loop(self) -> None:
        """Stage thread: device-block + deposit."""
        while True:
            try:
                item = self._inflight.get(timeout=0.5)
            except queue_mod.Empty:
                continue
            if item is None:        # shutdown sentinel from stop()
                return
            try:
                results = self._collect(item)
            except Exception as e:  # noqa: BLE001 — per-batch containment
                with self._lock:
                    self._rollback_launch_locked(item.op, item.batch)
                self._fail_batch(item.batch, e)
                results = None
            if results is not None:
                self._deposit_results(results)
            with self._lock:
                self._inflight_n -= 1
                self._g_inflight.set(self._inflight_n)
