"""SpMV serving façade — the micro-batcher API over the staged pipeline.

The serving engine itself lives in :mod:`repro_torch.serve.pipeline` as an
explicit four-stage pipeline (admission → coalesce → dispatch → collect);
this module keeps the original service surface — ``submit`` / ``flush`` /
``result`` / ``serve`` / ``snapshot`` — as a thin subclass.  With no
dispatcher running (the default), every ``flush()`` drives the stages
synchronously on the calling thread, which is bit-for-bit the historical
micro-batcher behavior; call :meth:`SpMVService.start` (or use the
service as a context manager) to switch the same object into pipelined
mode, where host-side coalescing overlaps device execution and ``flush``
becomes a drain barrier.

The serving economics are unchanged (paper Sec. 2.2): one SpMV streams
all of A, so ``flush`` coalesces same-matrix requests into SpMM calls
whose width pads to a power of two, amortizing the A-stream over the
batch.  See :class:`repro_torch.serve.pipeline.SpMVPipeline` for the stage and
admission-policy details.
"""
from __future__ import annotations

from repro_torch.serve.pipeline import (ADMISSION_POLICIES, AdmissionConfig,
                                  AdmissionError, AdmissionRejected,
                                  BATCH_SIZE_BUCKETS, RequestShed,
                                  ServiceStats, SpMVPipeline, SpMVRequest,
                                  SpMVResult, bucket_width, log)

__all__ = ["SpMVService", "SpMVPipeline", "SpMVRequest", "SpMVResult",
           "ServiceStats", "AdmissionConfig", "AdmissionError",
           "AdmissionRejected", "RequestShed", "ADMISSION_POLICIES",
           "BATCH_SIZE_BUCKETS", "bucket_width", "log"]


class SpMVService(SpMVPipeline):
    """Micro-batching front-end for registry-resident sparse matrices.

    Usage::

        reg = MatrixRegistry(device="cuda")
        mid = reg.put(rows, cols, vals, shape)
        svc = SpMVService(reg, max_bucket=16, device="cuda")
        t1 = svc.submit(mid, x1)
        t2 = svc.submit(mid, x2, alpha=2.0)
        results = svc.flush()          # one SpMM for both requests
        y1 = results[t1].y

    This is :class:`~repro_torch.serve.pipeline.SpMVPipeline` under its
    original name; everything — constructor signature included — is
    inherited.  Like the registry it serves from, it runs on ``device``
    (default CUDA; ``device="cpu"`` runs the plain path), and a device
    other than the registry's raises ``ValueError``.
    """
