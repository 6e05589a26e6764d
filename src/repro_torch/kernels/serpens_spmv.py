"""Serpens stream SpMV/SpMM and the fused solver step: the CUDA kernels'
wrappers and plain versions.

The kernels (``csrc/serpens_spmv.cu``) replace the reference package's TPU
kernels ``spmv_pallas``, ``spmm_pallas`` and ``spmv_fused_pallas``.  They
are compiled with ``nvcc`` for ``sm_90a`` into ``build/`` at the
repository root on first use (``kernels/build.py``), loaded with
``ctypes`` and launched on PyTorch's current stream.

:func:`spmv` and :func:`spmm` take the stream and a padded x and return the
fp32 accumulator.  On CUDA tensors they launch the kernel as their plans
say (:func:`spmv_plan`, :func:`spmm_plan`) and count the launch in
:data:`spmv_launches` / :data:`spmm_launches`, the SpMM's also by vector
width in :data:`spmm_launches_by_width`; on CPU tensors
they run the plain version, :func:`spmv_plain` / :func:`spmm_plain`, which
decodes, gathers and ``index_add_``-s in fp32 like the reference's XLA
stream path.  Nothing falls back: a CUDA tensor either runs the kernel or
raises.

:func:`spmv_fused` is one solver iteration: a pass over A, then the
iteration's vector work (an *epilogue*) on the complete accumulator.  The
TPU kernel traces any Python epilogue into its last grid step; CUDA cannot
trace Python, so the kernel implements the three epilogues the solvers
use, and each solver registers its plain torch epilogue with
:func:`fused_epilogue` under the kernel's name for it.  On CUDA tensors an
unregistered epilogue raises; on CPU tensors any callable runs.  Under a
:class:`FusedLoop` the step also keeps the solver loop's control word on
the device (see there).
"""
from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from repro_torch.core.format import COL_MASK, ROW_BITS
from repro_torch.kernels import build as _build

# Launch counters: each wrapper adds one where it launches its kernel and
# nowhere else, so a run can show that its path went through the kernels.
# SpMM counts one launch per row-window pass, and each also by its vector
# width.
spmv_launches = 0
spmm_launches = 0
spmm_launches_by_width = {4: 0, 2: 0, 1: 0}
spmv_fused_launches = 0
# The SpmvPlan of the latest stream pass launched (spmv or a fused step),
# so a run can show which plan its pass ran on.
spmv_last_plan = None

# Dynamic shared memory one block may use on sm_90 (227 KB), the target the
# kernels are built for (kSpmvMaxSmem in csrc/serpens_spmv.cu), and the
# threads of a stream-pass block (kSpmvThreads), each of which keeps one
# lane of its group.
SMEM_BYTES = 232_448
_SPMV_THREADS = 1024


def build():
    """Compile ``csrc/serpens_spmv.cu`` (see :func:`.build.build`)."""
    return _build.build("serpens_spmv")


def _declare(lib) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.serpens_spmv.argtypes = [p, p, p, p, p, i64, i32, i32, i32, i64,
                                 i64, i32, i32, i32, i32, p]
    lib.serpens_spmv.restype = i32
    lib.serpens_spmm.argtypes = [p, p, p, p, p, i64, i32, i32, i32, i32,
                                 i32, i64, i64, i64, i32, p]
    lib.serpens_spmm.restype = i32
    lib.serpens_spmv_fused.argtypes = [
        i32, p, p, p, p, p, i64, i32, i32, i32, i64, i64, i32, i32, i32,
        i32, p, p, p, p, p, p, i32, p, ctypes.c_float, i32, p]
    lib.serpens_spmv_fused.restype = i32


def _library() -> ctypes.CDLL:
    """Build (first call only) and load the kernel library."""
    return _build.load("serpens_spmv", _declare)


# -- input checks (shared by kernel and plain paths) -------------------------
def _check_stream(idx, val, seg_ids, tiles_per_chunk: int) -> None:
    """The reference wrapper's checks, on the per-tile ``seg_ids``."""
    if idx.dim() != 3 or val.shape != idx.shape:
        raise ValueError(f"idx {tuple(idx.shape)} and val "
                         f"{tuple(val.shape)} must both be (tiles, sub, "
                         f"lanes)")
    num_tiles = idx.shape[0]
    if num_tiles % tiles_per_chunk:
        raise ValueError(
            f"stream has {num_tiles} tiles, not a multiple of "
            f"tiles_per_chunk={tiles_per_chunk}")
    if tuple(seg_ids.shape) != (num_tiles,):
        raise ValueError(
            f"seg_ids shaped {tuple(seg_ids.shape)}, expected "
            f"({num_tiles},) — a wrong length would silently mis-index x "
            f"segments")
    if idx.dtype != torch.int32 or seg_ids.dtype != torch.int32:
        raise ValueError("idx and seg_ids must be int32")
    if val.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"val must be float32 or bfloat16, got {val.dtype}")


def _check_device(*tensors) -> torch.device:
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}: the stream "
                             f"and x must share one device")
    return dev


def _check_kernel_args(idx, val, seg_ids, x) -> None:
    for name, t in (("idx", idx), ("val", val), ("seg_ids", seg_ids),
                    ("x", x)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype != torch.float32:
        raise ValueError(f"x must be float32, got {x.dtype}")


def _check_padded(x, segment_width: int) -> None:
    if x.shape[0] % segment_width:
        raise ValueError(f"x has {x.shape[0]} rows, not a multiple of "
                         f"segment_width={segment_width}")


def _raise_on(status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {status}")


# -- plain versions -----------------------------------------------------------
def _decode(idx, seg_ids, segment_width: int, lanes: int):
    """Decode the packed stream: live mask and global rows/cols (int64)."""
    live = idx != -1
    w = idx.to(torch.int64) & 0xFFFFFFFF          # unsigned view of the word
    lane = torch.arange(lanes, device=idx.device, dtype=torch.int64)
    rows = torch.where(live, (w >> ROW_BITS) & COL_MASK, 0) * lanes + lane
    cols = (seg_ids.to(torch.int64)[:, None, None] * segment_width
            + torch.where(live, w & COL_MASK, 0))
    return live, rows, cols


def spmv_plain(idx, val, seg_ids, x, *, num_rows_padded: int,
               segment_width: int):
    """Plain ``A @ x`` over the stream: decode, gather, fp32 ``index_add_``."""
    live, rows, cols = _decode(idx, seg_ids, segment_width, idx.shape[2])
    contrib = torch.where(live, val.float() * x[cols], 0.0)
    acc = torch.zeros(num_rows_padded, dtype=torch.float32, device=x.device)
    return acc.index_add_(0, rows.reshape(-1), contrib.reshape(-1))


def spmm_plain(idx, val, seg_ids, x, *, num_rows_padded: int,
               segment_width: int):
    """Plain ``A @ X`` for X (K_pad, N) → (num_rows_padded, N)."""
    live, rows, cols = _decode(idx, seg_ids, segment_width, idx.shape[2])
    v = torch.where(live, val.float(), 0.0).reshape(-1, 1)
    contrib = v * x[cols.reshape(-1)]
    acc = torch.zeros((num_rows_padded, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    return acc.index_add_(0, rows.reshape(-1), contrib)


# -- wrappers -----------------------------------------------------------------
def _ranges(n: int, parts: int) -> tuple:
    """``parts`` equal ``(lo, hi)`` ranges covering ``[0, n)``, the cut the
    kernel makes from a count."""
    return tuple((n * i // parts, n * (i + 1) // parts) for i in range(parts))


@dataclasses.dataclass(frozen=True)
class SpmvPlan:
    """How the SpMV stream pass runs: one block per (lane group, row
    window, tile split) cell, each keeping its part of the accumulator in
    shared memory.

    ``lanes`` and ``rows`` (lane-local rows, ``ceil(num_rows_padded /
    lanes)``) are the geometry; ``lane_group`` lanes per block (the last
    group may be partial); ``windows``, the ``(lo, hi)`` lane-local rows of
    each window, equal cuts of ``rows``; ``splits`` equal ranges of tiles
    per cell; ``smem_bytes`` the dynamic shared memory a block asks for.
    """
    lanes: int
    rows: int
    lane_group: int
    windows: tuple
    splits: int
    smem_bytes: int

    @property
    def groups(self) -> tuple:
        """The ``(lo, hi)`` lanes of each lane group."""
        lg = self.lane_group
        return tuple((lo, min(lo + lg, self.lanes))
                     for lo in range(0, self.lanes, lg))

    @property
    def blocks(self) -> int:
        return len(self.groups) * len(self.windows) * self.splits

    def tile_ranges(self, num_tiles: int) -> tuple:
        """The ``(first, end)`` tiles of each split."""
        return _ranges(num_tiles, self.splits)


def spmv_plan_of(lanes: int, num_rows_padded: int, lane_group: int,
                 windows: int, splits: int) -> SpmvPlan:
    """The :class:`SpmvPlan` of these counts (equal windows)."""
    rows = max(1, -(-num_rows_padded // lanes))
    return SpmvPlan(lanes, rows, lane_group, _ranges(rows, windows), splits,
                    lane_group * -(-rows // windows) * 4)


def spmv_plan(num_tiles: int, sub: int, lanes: int, num_rows_padded: int,
              smem_bytes: int = SMEM_BYTES, sms: int = 132) -> SpmvPlan:
    """The SpMV plan for a stream of ``num_tiles`` (``sub``, ``lanes``)
    tiles into ``num_rows_padded`` rows, on a card whose blocks may use
    ``smem_bytes`` of shared memory and that has ``sms`` SMs.

    The lane group is the largest whose accumulator (``lane_group × rows``
    fp32) fits in ``smem_bytes``, rounded down to a multiple of 8 (8
    lanes' idx are one 32-byte sector) or else of 4, unless it takes every
    lane; it is at most ``lanes`` and 1024 (one thread a lane).  When not
    even one lane's rows fit (lane-local rows go up to 65,536, 256 KB),
    the group is one lane and its rows are cut into the fewest equal
    windows that fit, each one more read of the lane's stream.  Splits share each (group, window) cell's
    tiles so that the blocks number about one per SM.  A stream of 2^31
    slots or more is refused (the kernel counts slots in 32 bits).
    """
    if num_tiles * sub * lanes >= 1 << 31:
        raise ValueError(f"a stream of {num_tiles} x {sub} x {lanes} slots "
                         f"has 2^31 or more")
    rows = max(1, -(-num_rows_padded // lanes))
    floats = smem_bytes // 4
    fit = min(lanes, _SPMV_THREADS, floats // rows)
    if fit >= 1:
        lg = fit
        if fit < lanes:
            lg = fit // 8 * 8 or fit // 4 * 4 or fit
        windows = 1
    else:
        lg, windows = 1, -(-rows // floats)
    cells = -(-lanes // lg) * windows
    splits = max(1, min(num_tiles, sms // cells))
    return spmv_plan_of(lanes, num_rows_padded, lg, windows, splits)


def _card_spmv_plan(idx, num_rows_padded: int) -> SpmvPlan:
    """:func:`spmv_plan` for this card and stream."""
    num_tiles, sub, lanes = idx.shape
    sms = torch.cuda.get_device_properties(idx.device).multi_processor_count
    return spmv_plan(num_tiles, sub, lanes, num_rows_padded, SMEM_BYTES, sms)


def _check_plan(plan: SpmvPlan, idx, num_rows_padded: int) -> None:
    lanes = idx.shape[2]
    if (plan.lanes, plan.rows) != (lanes,
                                   max(1, -(-num_rows_padded // lanes))) \
            or plan.windows != _ranges(plan.rows, len(plan.windows)):
        raise ValueError(f"{plan} does not fit a stream of {lanes} lanes "
                         f"into {num_rows_padded} rows")


def _spmv_args(idx, val, seg_ids, x, plan: SpmvPlan, acc, segment_width):
    """The stream pass's arguments to the C entries, from ``idx`` to
    ``splits``."""
    num_tiles, sub, lanes = idx.shape
    return (idx.data_ptr(), val.data_ptr(), seg_ids.data_ptr(),
            x.data_ptr(), acc.data_ptr(), num_tiles, sub, lanes,
            segment_width, x.shape[0], acc.numel(),
            int(val.dtype == torch.bfloat16), plan.lane_group,
            len(plan.windows), plan.splits)


def _spmv_run(idx, val, seg_ids, x, plan: SpmvPlan, *, num_rows_padded: int,
              segment_width: int):
    """Launch the stream pass on ``plan`` (checked CUDA inputs)."""
    global spmv_launches, spmv_last_plan
    _check_plan(plan, idx, num_rows_padded)
    lib = _library()
    alloc = torch.zeros if plan.splits > 1 else torch.empty
    acc = alloc(num_rows_padded, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _raise_on(lib.serpens_spmv(
        *_spmv_args(idx, val, seg_ids, x, plan, acc, segment_width), stream),
        "serpens_spmv")
    spmv_launches += 1
    spmv_last_plan = plan
    return acc


def spmv(idx, val, seg_ids, x, *, num_rows_padded: int, segment_width: int,
         tiles_per_chunk: int = 1):
    """``A @ x`` over the Serpens stream → fp32 ``(num_rows_padded,)``.

    Args:
      idx: int32 ``(tiles, sub, lanes)`` packed stream words.
      val: float32 or bfloat16 ``(tiles, sub, lanes)`` values.
      seg_ids: int32 ``(tiles,)`` x segment of each tile.
      x: float32 ``(num_segments * segment_width,)`` zero-padded vector.

    On CUDA tensors the kernel runs as :func:`spmv_plan` says for this
    stream and card.
    """
    _check_stream(idx, val, seg_ids, tiles_per_chunk)
    if x.dim() != 1:
        raise ValueError(f"spmv needs a 1-D x, got {tuple(x.shape)}")
    dev = _check_device(idx, val, seg_ids, x)
    if dev.type == "cpu":
        return spmv_plain(idx, val, seg_ids, x,
                          num_rows_padded=num_rows_padded,
                          segment_width=segment_width)
    if dev.type != "cuda":
        raise ValueError(f"no Serpens kernel for device {dev}")
    _check_kernel_args(idx, val, seg_ids, x)
    _check_padded(x, segment_width)
    return _spmv_run(idx, val, seg_ids, x,
                     _card_spmv_plan(idx, num_rows_padded),
                     num_rows_padded=num_rows_padded,
                     segment_width=segment_width)


@dataclasses.dataclass(frozen=True)
class SpmmPlan:
    """How :func:`spmm` runs: ``vec`` columns a thread moves at once (the
    kernel's instantiation: float4, float2 or scalar loads and reductions)
    and ``windows``, the ``(first row, end row)`` of acc each kernel pass
    applies."""
    vec: int
    windows: tuple


def spmm_plan(x, num_rows_padded: int, l2_bytes: int) -> SpmmPlan:
    """The SpMM plan for X ``(K_pad, N)`` on a card with ``l2_bytes`` of L2.

    ``vec`` is 4 if N % 4 == 0 and X's base is 16-byte aligned, else 2 if
    N is even and the base 8-byte aligned, else 1 (acc is allocated by
    :func:`spmm`, always aligned).  Every live slot updates a random acc
    row, so once the fp32 acc ``num_rows_padded × N`` outgrows half the L2
    (the rest holds the X window of the segments in flight and the
    stream's lines) the rows are split into the fewest equal windows whose
    acc fits that half; each window is one pass over the stream that
    gathers and reduces only the slots of its rows.
    """
    n = x.shape[1]
    addr = x.data_ptr()
    vec = next(w for w in (4, 2, 1) if n % w == 0 and addr % (4 * w) == 0)
    rows = num_rows_padded
    passes = max(1, -(-rows * n * 4 // (l2_bytes // 2)))
    return SpmmPlan(vec, tuple((rows * i // passes, rows * (i + 1) // passes)
                               for i in range(passes)))


def _spmm_run(idx, val, seg_ids, x, plan: SpmmPlan, *, num_rows_padded: int,
              segment_width: int):
    """Launch the SpMM kernel once per row window of ``plan`` (checked
    CUDA inputs), every pass into the one output."""
    global spmm_launches
    lib = _library()
    dev = x.device
    n = x.shape[1]
    num_tiles, sub, lanes = idx.shape
    stream = torch.cuda.current_stream(dev).cuda_stream
    acc = torch.zeros((num_rows_padded, n), dtype=torch.float32, device=dev)
    for lo, hi in plan.windows:
        status = lib.serpens_spmm(
            idx.data_ptr(), val.data_ptr(), seg_ids.data_ptr(),
            x.data_ptr(), acc.data_ptr(), num_tiles, sub, lanes,
            segment_width, n, plan.vec, x.shape[0], lo, hi,
            int(val.dtype == torch.bfloat16), stream)
        _raise_on(status, "serpens_spmm")
        spmm_launches += 1
        spmm_launches_by_width[plan.vec] += 1
    return acc


def spmm(idx, val, seg_ids, x, *, num_rows_padded: int, segment_width: int,
         tiles_per_chunk: int = 1):
    """``A @ X`` for X float32 ``(K_pad, N)`` → fp32 ``(num_rows_padded, N)``
    (same stream arguments as :func:`spmv`).  On CUDA tensors the kernel
    runs as :func:`spmm_plan` says for this X and card."""
    _check_stream(idx, val, seg_ids, tiles_per_chunk)
    if x.dim() != 2:
        raise ValueError(f"spmm needs a (K_pad, N) x, got {tuple(x.shape)}")
    dev = _check_device(idx, val, seg_ids, x)
    if dev.type == "cpu":
        return spmm_plain(idx, val, seg_ids, x,
                          num_rows_padded=num_rows_padded,
                          segment_width=segment_width)
    if dev.type != "cuda":
        raise ValueError(f"no Serpens kernel for device {dev}")
    _check_kernel_args(idx, val, seg_ids, x)
    _check_padded(x, segment_width)
    if x.shape[1] == 0:
        return torch.zeros((num_rows_padded, 0), dtype=torch.float32,
                           device=dev)
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    return _spmm_run(idx, val, seg_ids, x,
                     spmm_plan(x, num_rows_padded, l2),
                     num_rows_padded=num_rows_padded,
                     segment_width=segment_width)


# -- fused solver step --------------------------------------------------------
# Threads of the kernel's epilogue blocks (kEpiThreads there).
_EPI_THREADS = 256


@dataclasses.dataclass(frozen=True)
class EpilogueSpec:
    """The layout one epilogue of the CUDA kernel hard-codes.

    ``kernel_id`` is its ``enum Epilogue`` value.  ``extras`` gives each
    extra's size (the kernel's ``e0..e3``): ``"v"`` for a state vector in
    the (R, LANES) accumulator layout, an int for a small constant array
    (scalars travel as (1, 1)).  Output ``i < len(state)`` is written back
    in place into ``extras[state[i]]``; the ``scalars`` outputs after them
    go to :attr:`FusedLoop.scalars` (the kernel's ``scal``).  The stopping
    rule reads output ``measure`` (its square root when ``sqrt``).
    """
    name: str
    kernel_id: int
    extras: tuple
    state: tuple
    scalars: int
    measure: int
    sqrt: bool = False


# The epilogues csrc/serpens_spmv.cu implements, as its cg_*, pr_* and pw_*
# kernels lay them out.  CG: sol, r, p (also x), rs; stops on sqrt(rs).
# PageRank: r (also x), mask, [damping, n]; scal = [delta].  Power
# iteration: v (also x); scal = [lambda, residual], stops on the residual.
EPILOGUE_SPECS = {
    "cg": EpilogueSpec("cg", 0, extras=("v", "v", "v", 1),
                       state=(0, 1, 2, 3), scalars=0, measure=3, sqrt=True),
    "pagerank": EpilogueSpec("pagerank", 1, extras=("v", "v", 2), state=(0,),
                             scalars=1, measure=1),
    "power": EpilogueSpec("power", 2, extras=("v",), state=(0,), scalars=2,
                          measure=2),
}
# Registered plain epilogue function -> its spec; one function per name.
_EPILOGUES: dict = {}


def fused_epilogue(name: str):
    """Register a plain torch epilogue as the one the CUDA kernel runs
    under ``name`` (a key of :data:`EPILOGUE_SPECS`, whose layout the
    function must follow).  A name takes one function."""
    spec = EPILOGUE_SPECS.get(name)
    if spec is None:
        raise ValueError(f"the fused kernel has no epilogue {name!r}; it "
                         f"implements {sorted(EPILOGUE_SPECS)}")

    def register(fn):
        for other, s in _EPILOGUES.items():
            if s is spec and other is not fn:
                raise ValueError(f"epilogue {name!r} is already registered "
                                 f"to {other.__qualname__}")
        _EPILOGUES[fn] = spec
        return fn
    return register


class FusedLoop:
    """The device-side state of a solver loop run by fused steps.

    ``ctrl = [cont, it]`` (int32) is the reference's ``while_loop``
    condition, kept on the card: each step that runs adds one to ``it``
    and sets ``cont = measure > stop and it < max_iters``, and a step
    enqueued while ``cont == 0`` does nothing.  A solver therefore
    enqueues steps ahead and reads ``ctrl`` once per chunk, never once per
    iteration.  ``cont`` starts as ``first > stop`` (or true) when
    ``max_iters > 0``.  ``scalars`` holds the epilogue's scalar outputs,
    starting at the values a solve of zero iterations reports.  The
    accumulator and the partial-sum scratch are allocated at the first
    step and reused.
    """

    def __init__(self, device, *, stop: float, max_iters: int,
                 scalars: tuple = (), first=None):
        device = torch.device(device)
        self.stop = float(stop)
        self.max_iters = int(max_iters)
        self.ctrl = torch.tensor([int(self.max_iters > 0), 0],
                                 dtype=torch.int32, device=device)
        if first is not None and self.max_iters > 0:
            self.ctrl[0] = (first > self.stop).to(torch.int32)
        self.scalars = torch.tensor(scalars, dtype=torch.float32,
                                    device=device)
        self.acc = None
        self.part = None

    def _buffers(self, acc_len: int, nb: int):
        if self.acc is None or self.acc.numel() != acc_len:
            self.acc = torch.empty(acc_len, dtype=torch.float32,
                                   device=self.ctrl.device)
        if self.part is None or self.part.numel() != 3 * nb:
            self.part = torch.empty(3 * nb, dtype=torch.float32,
                                    device=self.ctrl.device)
        return self.acc, self.part


def _check_extras(spec: EpilogueSpec, extras, acc_len: int) -> None:
    if len(extras) != len(spec.extras):
        raise ValueError(f"epilogue {spec.name!r} takes {len(spec.extras)} "
                         f"extras, got {len(extras)}")
    for i, (e, size) in enumerate(zip(extras, spec.extras)):
        want = acc_len if size == "v" else size
        if e.numel() != want:
            raise ValueError(f"extra {i} of epilogue {spec.name!r} has "
                             f"{e.numel()} elements, expected {want}")
        if e.dtype != torch.float32 or not e.is_contiguous():
            raise ValueError(f"extra {i} of epilogue {spec.name!r} must be "
                             f"contiguous float32")


def _state_outs(spec: EpilogueSpec, extras, loop: FusedLoop) -> tuple:
    return (tuple(extras[j] for j in spec.state)
            + tuple(loop.scalars[k].view(1, 1) for k in range(spec.scalars)))


def spmv_fused_plain(idx, val, seg_ids, x, extras=(), *, epilogue,
                     num_rows_padded: int, segment_width: int):
    """Plain fused step: :func:`spmv_plain` (entries of x past its end
    read as zero), then ``epilogue(acc2d, *extras)`` in torch ops.
    Returns ``(acc, outs)`` and leaves the extras as they were."""
    lanes = idx.shape[2]
    live, rows, cols = _decode(idx, seg_ids, segment_width, lanes)
    live = live & (cols < x.shape[0])
    contrib = torch.where(live, val.float() * x[torch.where(live, cols, 0)],
                          0.0)
    acc = torch.zeros(num_rows_padded, dtype=torch.float32, device=x.device)
    acc.index_add_(0, rows.reshape(-1), contrib.reshape(-1))
    return acc, tuple(epilogue(acc.view(-1, lanes), *extras))


def _plain_step(spec, loop, epilogue, idx, val, seg_ids, x, extras,
                **geo):
    """The kernel's semantics in torch ops (CPU tensors): the plain step,
    its state written back in place, and the loop's control word."""
    if int(loop.ctrl[0]) == 0:
        acc = (loop.acc if loop.acc is not None else
               torch.zeros(geo["num_rows_padded"], dtype=torch.float32))
        return acc, _state_outs(spec, extras, loop)
    acc, outs = spmv_fused_plain(idx, val, seg_ids, x, extras,
                                 epilogue=epilogue, **geo)
    for i, j in enumerate(spec.state):
        extras[j].copy_(outs[i])
    for k in range(spec.scalars):
        loop.scalars[k] = outs[len(spec.state) + k].reshape(())
    measure = outs[spec.measure].reshape(())
    if spec.sqrt:
        measure = torch.sqrt(measure)
    it = int(loop.ctrl[1]) + 1
    loop.ctrl[1] = it
    loop.ctrl[0] = int(bool(measure > loop.stop) and it < loop.max_iters)
    loop.acc = acc
    return acc, _state_outs(spec, extras, loop)


def _epi_blocks(device: torch.device, acc_len: int) -> int:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(2 * sms, -(-acc_len // (_EPI_THREADS * 8))))


def spmv_fused(idx, val, seg_ids, x, extras=(), *, epilogue,
               num_rows_padded: int, segment_width: int,
               tiles_per_chunk: int = 1, loop: FusedLoop | None = None):
    """One fused solver step: ``acc = A @ x``, then ``epilogue(acc2d,
    *extras)`` on the complete accumulator.  Returns ``(acc, outs)``.

    Args:
      idx, val, seg_ids: the stream, as for :func:`spmv`.
      x: float32 1-D, at least K long.  Live columns are < K and entries
        past the end of x read as zero, so a solver passes a view of its
        flat state vector and pads nothing.
      extras: the reference's extras: state vectors in (R, LANES) layout,
        scalars as (1, 1) arrays.
      epilogue: a plain torch function ``(acc2d, *extras) -> outs``.
      loop: the :class:`FusedLoop` this step is an iteration of.

    On CPU tensors an unregistered epilogue simply runs after
    :func:`spmv_plain` (the reference's contract).  A registered one
    (:func:`fused_epilogue`) works **in place**: the outputs that are
    solver state (sol, r, p for CG; r for PageRank; v for power
    iteration) are written back into their extras, the scalar outputs
    into ``loop.scalars``, and ``outs`` holds those tensors.  The CUDA
    kernel always works so (the state then takes no second copy), and
    the CPU path copies the plain outputs back, so a solver runs one
    code path on both.  On CUDA tensors an unregistered epilogue raises.
    Without ``loop`` the step runs once, whatever the state.
    """
    _check_stream(idx, val, seg_ids, tiles_per_chunk)
    if x.dim() != 1:
        raise ValueError(f"spmv_fused needs a 1-D x, got {tuple(x.shape)}")
    dev = _check_device(idx, val, seg_ids, x, *extras)
    geo = dict(num_rows_padded=num_rows_padded, segment_width=segment_width)
    spec = _EPILOGUES.get(epilogue)
    if spec is None:
        if dev.type == "cuda":
            raise ValueError(
                f"epilogue {getattr(epilogue, '__name__', epilogue)!r} is "
                f"not registered with fused_epilogue: the CUDA kernel runs "
                f"only the epilogues it implements "
                f"({sorted(EPILOGUE_SPECS)})")
        if loop is not None:
            raise ValueError("a FusedLoop needs a registered epilogue")
        if dev.type != "cpu":
            raise ValueError(f"no Serpens kernel for device {dev}")
        return spmv_fused_plain(idx, val, seg_ids, x, tuple(extras),
                                epilogue=epilogue, **geo)
    extras = tuple(extras)
    _check_extras(spec, extras, num_rows_padded)
    if loop is None:
        loop = FusedLoop(dev, stop=-math.inf, max_iters=1,
                         scalars=(0.0,) * spec.scalars)
    if loop.scalars.numel() != spec.scalars or loop.ctrl.device != dev:
        raise ValueError(f"the FusedLoop does not fit epilogue "
                         f"{spec.name!r} on {dev}")
    if dev.type == "cpu":
        return _plain_step(spec, loop, epilogue, idx, val, seg_ids, x,
                           extras, **geo)
    if dev.type != "cuda":
        raise ValueError(f"no Serpens kernel for device {dev}")
    _check_kernel_args(idx, val, seg_ids, x)
    return _spmv_fused_run(spec, loop, idx, val, seg_ids, x, extras,
                           _card_spmv_plan(idx, num_rows_padded),
                           **geo)


def _spmv_fused_run(spec, loop, idx, val, seg_ids, x, extras,
                    plan: SpmvPlan, *, num_rows_padded: int,
                    segment_width: int):
    """Launch the fused step's kernel chain, its stream pass on ``plan``
    (checked CUDA inputs)."""
    global spmv_fused_launches, spmv_last_plan
    _check_plan(plan, idx, num_rows_padded)
    lib = _library()
    dev = x.device
    nb = _epi_blocks(dev, num_rows_padded)
    acc, part = loop._buffers(num_rows_padded, nb)
    ptrs = [e.data_ptr() for e in extras] + [None] * (4 - len(extras))
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = lib.serpens_spmv_fused(
        spec.kernel_id,
        *_spmv_args(idx, val, seg_ids, x, plan, acc, segment_width), *ptrs,
        loop.scalars.data_ptr() or None, part.data_ptr(), nb,
        loop.ctrl.data_ptr(), loop.stop, loop.max_iters, stream)
    _raise_on(status, "serpens_spmv_fused")
    spmv_fused_launches += 1
    spmv_last_plan = plan
    return acc, _state_outs(spec, extras, loop)
