"""Kernel-profiling hooks: ``torch.profiler`` integration + per-plan cost model.

The paper's results are roofline points — achieved GB/s of A-stream
traffic against the memory's peak — so a benchmark sweep wants, per run,
the plan's *modeled* cost (stream bytes, slots, padding) next to its
*measured* time.  :func:`plan_cost_report` produces exactly that for any
:class:`~repro_torch.core.spmv.SerpensOperator` (surfaced as
``op.cost_report()``), and :func:`profiler_trace` wraps a block in a
``torch.profiler`` trace (CPU and CUDA activity) written as a Chrome trace.

torch is imported inside the functions, so this module stays importable
from torch-free encode worker processes.
"""
from __future__ import annotations

import contextlib
import os
import time

# Assumed peak stream bandwidth for the modeled time, GB/s: the H100 SXM's
# data-sheet HBM3 rate (3.35 TB/s at the full 700 W limit).  The
# reference's 206 GB/s is the paper's FPGA (16 HBM2 channels at ~12.9 GB/s
# each), not this card's; override per call for other parts.
ASSUMED_BANDWIDTH_GBPS = 3350.0


def plan_cost_report(op, *, measure: bool = False,
                     backend: str | None = None,
                     bandwidth_gbps: float | None = None,
                     iters: int = 3) -> dict:
    """Cost-model report for one operator's channel-shard plan.

    Per shard: nnz, slots, stream bytes, padding ratio, per-lane live-slot
    imbalance (max/mean), and the modeled stream time
    ``bytes / bandwidth`` — all from the plan's host arrays.  With
    ``measure=True`` one matvec on the operator's device is timed (after a
    warm-up call; median of ``iters``: CUDA events on a card, the host
    clock on a CPU operator) and the report adds the achieved GB/s and its
    fraction of the assumed peak — the roofline position — plus per-shard
    measured time attributed proportionally to stream bytes (shards
    dispatch in one call, so only the total is directly observable).
    """
    import numpy as np
    from repro_torch.core.format import SENTINEL
    bw = float(bandwidth_gbps or ASSUMED_BANDWIDTH_GBPS)
    plan = op.plan
    shards = []
    for i, sm in enumerate(plan.shards):
        sb = int(sm.stream_bytes)
        # Per-lane live-slot imbalance (max/mean): the structural feature
        # the auto-tuner keys on — 1.0 is perfectly balanced lanes, higher
        # means some lanes pad while others stream.
        live = (np.asarray(sm.idx) != SENTINEL).sum(axis=(0, 1))
        lane_mean = float(live.mean()) if live.size else 0.0
        imb = float(live.max() / lane_mean) if lane_mean > 0.0 else 1.0
        shards.append({
            "shard": i,
            "nnz": int(sm.nnz),
            "n_aux": int(sm.n_aux),
            "slots": int(sm.idx.size),
            "stream_bytes": sb,
            "padding_ratio": float(sm.padding_ratio),
            "lane_slot_imbalance": imb,
            "est_stream_s": sb / (bw * 1e9),
        })
    total_bytes = int(plan.stream_bytes)
    report = {
        "shape": [int(s) for s in op.shape],
        "nnz": int(plan.nnz),
        "partition": plan.spec.partition,
        "num_shards": int(plan.num_shards),
        # Slot width follows the plan's value dtype: 4 B packed index +
        # 4 B fp32 value (the paper's 8 B element) or + 2 B bf16 value.
        "value_dtype": plan.config.value_dtype,
        "bytes_per_slot": 4 + plan.config.value_bytes,
        "stream_bytes": total_bytes,
        "bytes_per_nnz": total_bytes / max(int(plan.nnz), 1),
        "padded_slots": int(plan.idx.size),
        "padding_ratio": float(plan.padding_ratio),
        "lane_assign": plan.spec.lane_assign,
        "lane_slot_imbalance": max(
            (sh["lane_slot_imbalance"] for sh in shards), default=1.0),
        "assumed_bandwidth_gbps": bw,
        "est_stream_s": total_bytes / (bw * 1e9),
        "shards": shards,
    }
    if measure:
        measured = _time_matvec(op, backend, max(1, iters))
        report["measured_matvec_s"] = measured
        report["achieved_gbps"] = total_bytes / measured / 1e9
        report["roofline_fraction"] = report["achieved_gbps"] / bw
        for sh in shards:
            frac = sh["stream_bytes"] / max(total_bytes, 1)
            sh["measured_s_attributed"] = measured * frac
    return report


def _time_matvec(op, backend, iters: int) -> float:
    """Median seconds of ``op.matvec`` on a seeded x already on the
    operator's device, after one warm-up call.  On a card each timed call
    is bracketed by CUDA events and enqueued behind an untimed one, so the
    events measure the device's work rather than the host's enqueue; on a
    CPU operator each call is timed by the host clock."""
    import numpy as np
    import torch
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=op.shape[1]).astype(np.float32)).to(op.device)
    op.matvec(x, backend=backend)                       # warm-up
    times = []
    if op.device.type == "cuda":
        torch.cuda.synchronize(op.device)
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            op.matvec(x, backend=backend)       # keeps the queue fed
            start.record()
            op.matvec(x, backend=backend)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            op.matvec(x, backend=backend)
            times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


@contextlib.contextmanager
def profiler_trace(logdir: str | None):
    """``torch.profiler`` trace (CPU and CUDA activity) around a block.

    Yields the profiler; on exit its Chrome trace is written into
    ``logdir`` (created if needed) as ``trace_<pid>_<n>.json``, and its
    ``key_averages()`` stay readable.  No-op (yields ``None``) when
    ``logdir`` is falsy, so benchmark flags can pass it through
    unconditionally.
    """
    if not logdir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    n = sum(1 for f in os.listdir(logdir) if f.startswith("trace_"))
    prof.export_chrome_trace(
        os.path.join(str(logdir), f"trace_{os.getpid()}_{n}.json"))
