"""The one dispatch point for running a Serpens stream, plus device helpers.

Two backends, named by ``backend=``:

  * ``"cuda"``  — the hand-written CUDA kernels (``serpens_spmv.py``), on
                  CUDA tensors.
  * ``"torch"`` — the plain PyTorch version of the same stream algorithm,
                  on CPU tensors (what the tests run).
  * ``"auto"``  — resolved from the tensors' device.

The backend must agree with the device: there is no fallback from one to
the other.  The reference package's names ``"xla"`` and ``"pallas"`` are
refused with a message rather than mapped silently.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.format import SerpensMatrix
from repro_torch.kernels import serpens_spmv

BACKENDS = ("cuda", "torch")

# Dispatch counter: passes over A that ran.  This module is the only place
# that counts: run_stream counts each call, run_stream_fused a lone call,
# and run_fused_loop the iterations its loop ran (read at each chunk's host
# sync, since steps enqueued after convergence make no pass).
_dispatches = 0

# Fused iterations enqueued between two host reads of a loop's control
# word.  Up to FUSED_CHUNK - 1 steps run empty after convergence.
FUSED_CHUNK = 8


def trace_dispatch_count() -> int:
    """Total stream passes over A dispatched so far.  Unlike the
    reference's trace-time count, this counts passes that run: a solve
    adds one per iteration."""
    return _dispatches


def _count_passes(n: int = 1) -> None:
    global _dispatches
    _dispatches += int(n)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks.

    ``None`` means ``cuda``.  Asking for CUDA on a machine without a card
    raises; nothing carries on quietly on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def resolve_backend(backend: str | None = None, device=None) -> str:
    """Resolve a backend name against the device it will run on.

    ``None``/``"auto"`` picks ``"cuda"`` for a CUDA device and ``"torch"``
    otherwise.  An explicit backend that contradicts the device raises
    ``ValueError``: ``"torch"`` on CUDA tensors would be a silent fallback
    to the plain version, ``"cuda"`` on CPU tensors cannot run.
    """
    dev = None if device is None else torch.device(device)
    if backend is None or backend == "auto":
        if dev is None:
            raise ValueError("backend='auto' needs a device to resolve")
        return "cuda" if dev.type == "cuda" else "torch"
    if backend in ("xla", "pallas"):
        raise ValueError(
            f"backend {backend!r} is a JAX backend of the reference package; "
            f"this package runs 'cuda' (the CUDA kernel) or 'torch' (the "
            f"plain version, CPU only)")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; known: {BACKENDS}")
    if dev is not None:
        if backend == "torch" and dev.type == "cuda":
            raise ValueError("backend='torch' on CUDA tensors: the plain "
                             "version is not a fallback for the kernel")
        if backend == "cuda" and dev.type != "cuda":
            raise ValueError(f"backend='cuda' needs CUDA tensors, got {dev}")
    return backend


def device_arrays(sm: SerpensMatrix, device) -> tuple:
    """Move a host SerpensMatrix's stream to ``device``: ``(idx, val,
    seg_ids)``.  A bf16 stream (``uint16`` bit patterns) becomes
    ``torch.bfloat16`` through a bit-preserving view."""
    val = sm.val
    if val.dtype == np.uint16:
        val_t = torch.from_numpy(np.ascontiguousarray(val).view(np.int16))
        val_t = val_t.view(torch.bfloat16)
    else:
        val_t = torch.from_numpy(np.ascontiguousarray(val, np.float32))
    return (torch.from_numpy(np.ascontiguousarray(sm.idx)).to(device),
            val_t.to(device),
            torch.from_numpy(np.ascontiguousarray(sm.seg_ids)).to(device))


def pad_x(x, num_segments: int, segment_width: int):
    """Zero-pad x (1-D, or (K, N)) along its first axis to
    ``num_segments * segment_width`` rows, as contiguous fp32."""
    return pad_rows(x.to(torch.float32), num_segments * segment_width)


def pad_rows(x, rows: int):
    """Zero-pad the leading axis of ``x`` to ``rows`` (contiguous)."""
    extra = rows - x.shape[0]
    if extra < 0:
        raise ValueError(f"x has {x.shape[0]} rows, more than {rows}")
    if extra == 0:
        return x.contiguous()
    return torch.cat([x, x.new_zeros((extra,) + tuple(x.shape[1:]))])


def run_stream(idx, val, seg_ids, x, *, num_rows_padded: int,
               segment_width: int, tiles_per_chunk: int = 1,
               backend: str = "auto"):
    """Run one Serpens stream against a padded x: 1-D (matvec) or
    ``(K_pad, N)`` (matmat).  Every executor funnels through here, so the
    backend/device agreement is checked in one place; the kernel wrappers
    then run the CUDA kernel on CUDA tensors and the plain version on CPU
    tensors."""
    _count_passes()
    resolve_backend(backend, x.device)
    fn = serpens_spmv.spmv if x.dim() == 1 else serpens_spmv.spmm
    return fn(idx, val, seg_ids, x, num_rows_padded=num_rows_padded,
              segment_width=segment_width, tiles_per_chunk=tiles_per_chunk)


def run_stream_fused(idx, val, seg_ids, x, *, epilogue, extras=(),
                     num_rows_padded: int, segment_width: int,
                     tiles_per_chunk: int = 1, backend: str = "auto",
                     loop=None):
    """One pass over A plus a fused epilogue: the solver hot path.

    ``epilogue(acc2d, *extras)`` runs on the complete (R, LANES) fp32
    accumulator: on CUDA tensors inside the fused kernel chain
    (:func:`~repro_torch.kernels.serpens_spmv.spmv_fused`, registered
    epilogues only), on CPU tensors in torch ops after the plain stream.
    x is the flat vector (at least K long, no padding needed).  Returns
    ``(acc, outs)``.  A lone call counts one pass over A; a step under a
    ``loop`` is counted by :func:`run_fused_loop` once it is known to
    have run.
    """
    if loop is None:
        _count_passes()
    resolve_backend(backend, x.device)
    return serpens_spmv.spmv_fused(
        idx, val, seg_ids, x, extras, epilogue=epilogue,
        num_rows_padded=num_rows_padded, segment_width=segment_width,
        tiles_per_chunk=tiles_per_chunk, loop=loop)


def run_fused_loop(step, loop) -> tuple[int, int]:
    """Run a solver's fused loop: enqueue ``step()`` (one
    :func:`run_stream_fused` call under ``loop``) :data:`FUSED_CHUNK`
    times, read the loop's control word once, and repeat until it says
    stop.  Counts the passes over A that ran.  Returns ``(iterations,
    host_syncs)``."""
    syncs = done = 0
    while True:
        for _ in range(FUSED_CHUNK):
            step()
        cont, it = loop.ctrl.tolist()
        syncs += 1
        _count_passes(it - done)
        done = it
        if not cont:
            return it, syncs
