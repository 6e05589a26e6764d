#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: kernels, server, timings.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It needs one CUDA card, ``nvcc`` (the kernels are built from
``src/repro_torch/kernels/csrc`` on first use) and ``nvidia-smi``.  It
imports nothing of the JAX package.  Phases:

1. Each CUDA kernel against its plain PyTorch version on the card, at the
   shapes of the G7 ``soc_pokec`` stand-in at full size (fp32 and bf16
   streams; SpMM at N = 2 and 16), and on an ``OPTIMIZED_CONFIG`` plan
   (raw window 2, hot-row spill) at scale 0.1.  Elementwise tolerance:
   ``|y_kernel - y_plain| <= 1e-5 * (|A| @ |x|) + 1e-6`` — the kernels sum
   with fp32 atomics in another order than the plain ``index_add_``.
2. The server answers requests: ``MatrixRegistry(device="cuda")`` holds
   the G7 stand-in, and ``SpMVService`` serves 48 requests from 3 owners
   with mixed alpha/beta, first synchronously and then pipelined, each run
   checked against an fp64 host reference under the same tolerance.  The
   kernels' launch counters are set to 0 just before each run and read
   just after; each kernel must have launched.  Both runs are traced
   (``repro_torch.obs``) and print the host seconds spent in each span.
3. Timings with CUDA events at the G7 shapes: kernel, plain version, and
   one ``torch.sparse`` CSR product as a yardstick (the port never calls
   it), beside the bound the card's memory rate sets.
4. The solvers (the second slice's path), through ``SpMVService.solve``:
   PageRank on the column-normalised G7 stand-in at full size
   (``tol=1e-6``: the fp32 L1 delta's noise floor is near n·ulp(1/n) ≈
   1e-7 at this n, so 1e-7 would stall), held against an fp64 scipy
   PageRank of the same iteration count within ``1e-5·max(r) + 1e-9``
   elementwise; CG (``tol=1e-6``, true fp64 residual ≤ 1e-4) and 100
   power iterations (λ against the fp64 Rayleigh quotient of the returned
   v, rel 1e-4) on the G5 stand-in made SPD (upper triangle mirrored,
   diagonal = row's Σ|off-diagonal| + 1).  The fused kernel's launch
   counter is set to 0 before these solves and read after; each solve
   must be fused.  Then each solve again with ``fused=False`` (the spmv
   kernel plus torch ops): iteration counts within 1, solutions within
   the tolerances printed.  One fused step per epilogue against
   ``spmv_fused_plain`` on the same card tensors (acc as in phase 1;
   state vectors within 1e-5 of their magnitude; reduced scalars within
   ``1e-5·Σ|terms| + 1e-6``), and CUDA-event timings of the fused step,
   of one iteration of each solver's own fused and unfused loop bodies
   (16 iterations a run), of the plain version and of ``torch.mv`` on a
   CSR tensor plus the epilogue in torch ops (a yardstick only).  If the
   run has
   passed 8 minutes before the G5 part, G5 runs at scale 0.25 and says
   so; the G7 PageRank never shrinks.

Any failed check raises, and the script then exits nonzero without its
last line.  The last line is ``{"ok": true, "device": {...}}``; the line
before it is the kernels' JSON record.
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.core import format as sformat  # noqa: E402
from repro_torch.core import partition as cpart  # noqa: E402
from repro_torch.core.registry import MatrixRegistry  # noqa: E402
from repro_torch.core.spmv import SerpensOperator  # noqa: E402
from repro_torch.data.matrices import (column_normalize,  # noqa: E402
                                       paper_matrix)
from repro_torch.solvers.cg import (  # noqa: E402
    _cg_epilogue, _solve_fused, _solve_unfused)
from repro_torch.solvers.power_iteration import (  # noqa: E402
    _pagerank_epilogue, _pagerank_fused, _pagerank_unfused, _power_epilogue,
    _power_fused, _power_unfused)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import serpens_spmv as ks  # noqa: E402
from repro_torch.serve.spmv_service import SpMVService  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet), at the full 700 W limit.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
TOL_REL, TOL_ABS = 1e-5, 1e-6
SEED = 0
N_REQUESTS = 48
OWNERS = ("alice", "bob", "carol")

KERNELS = {
    "spmv": {"route": "cuda",
             "source": "src/repro_torch/kernels/csrc/serpens_spmv.cu",
             "replaces": "src/repro/kernels/serpens_spmv.py:68"},
    "spmm": {"route": "cuda",
             "source": "src/repro_torch/kernels/csrc/serpens_spmv.cu",
             "replaces": "src/repro/kernels/serpens_spmv.py:147"},
    "spmv_fused": {"route": "cuda",
                   "source": "src/repro_torch/kernels/csrc/serpens_spmv.cu",
                   "replaces": "src/repro/kernels/serpens_spmv.py:192"},
}
# The G5 part of phase 4 shrinks to this scale once the run has passed
# SLOW_RUN_S seconds (the script must end well inside 1200 s).
SLOW_RUN_S = 480.0
G5_SMALL_SCALE = 0.25


def say(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def check_close(what: str, got, want, scale, atol: float = TOL_ABS
                ) -> float:
    """Elementwise ``|got - want| <= TOL_REL * scale + atol``; returns
    the largest absolute error."""
    got = torch.as_tensor(got)
    want = torch.as_tensor(want, device=got.device, dtype=got.dtype)
    scale = torch.as_tensor(scale, device=got.device, dtype=got.dtype)
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite values")
    err = (got - want).abs()
    bad = err > TOL_REL * scale + atol
    if bool(bad.any()):
        i = int(torch.argmax((err - TOL_REL * scale).flatten()))
        raise AssertionError(
            f"{what}: {int(bad.sum())} elements out of tolerance; worst "
            f"flat index {i}: |err| {float(err.flatten()[i])} vs scale "
            f"{float(scale.flatten()[i])}")
    return float(err.max())


def time_ms(fn, iters: int) -> float:
    """Mean ms per call on the card (CUDA events, after one warm-up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def stream_on_card(plan, dev):
    """The single-shard plan's stream as card tensors, plus its geometry."""
    if plan.num_shards != 1:
        raise AssertionError("phase 1 expects a single-shard plan")
    idx, val, seg = ops.device_arrays(plan.shards[0], dev)
    geo = dict(num_rows_padded=plan.out_rows_padded,
               segment_width=plan.config.segment_width)
    return idx, val, seg, geo


def compare_kernel(name: str, idx, val, seg, x, geo, tpc: int) -> float:
    """One kernel launch against the plain version on the same inputs."""
    kern = ks.spmv if name == "spmv" else ks.spmm
    plain = ks.spmv_plain if name == "spmv" else ks.spmm_plain
    got = kern(idx, val, seg, x, tiles_per_chunk=tpc, **geo)
    torch.cuda.synchronize()
    want = plain(idx, val, seg, x, **geo)
    scale = plain(idx, val.abs(), seg, x.abs(), **geo)
    torch.cuda.synchronize()
    return check_close(f"{name} kernel vs plain", got, want, scale)


def host_reference(rows, cols, vals, m, x, alpha, beta, y):
    """fp64 ``alpha * A @ x + beta * y`` and its tolerance scale."""
    xv = x.astype(np.float64)[cols]
    ax = np.bincount(rows, weights=vals * xv, minlength=m)
    absax = np.bincount(rows, weights=np.abs(vals) * np.abs(xv),
                        minlength=m)
    ref = alpha * ax
    scale = abs(alpha) * absax
    if y is not None:
        ref = ref + beta * y.astype(np.float64)
        scale = scale + abs(beta) * np.abs(y.astype(np.float64))
    return ref, scale


def make_requests(rng, m: int, k: int):
    """48 (x, alpha, beta, y, owner) requests: some with beta = 0, no y."""
    reqs = []
    for i in range(N_REQUESTS):
        x = rng.standard_normal(k).astype(np.float32)
        alpha = float(rng.uniform(-2.0, 2.0))
        if i % 3 == 0:
            beta, y = 0.0, None
        else:
            beta = float(rng.uniform(-1.0, 1.0))
            y = rng.standard_normal(m).astype(np.float32)
        reqs.append((x, alpha, beta, y, OWNERS[i % len(OWNERS)]))
    return reqs


def serve_sync(svc, mid, reqs):
    """Lone request first (matvec path), then the other 47 in one flush
    (two full 16-wide batches and one of 15 padded to 16)."""
    x, a, b, y, o = reqs[0]
    t0 = svc.submit(mid, x, alpha=a, beta=b, y=y, owner=o)
    out = svc.flush()
    tickets = [svc.submit(mid, x, alpha=a, beta=b, y=y, owner=o)
               for x, a, b, y, o in reqs[1:]]
    out.update(svc.flush())
    res = [out[t] for t in [t0] + tickets]
    shapes = [(r.batch_size, r.bucket_n) for r in res]
    want = [(1, 1)] + [(16, 16)] * 32 + [(15, 16)] * 15
    if shapes != want:
        raise AssertionError(f"sync batches {shapes} != {want}")
    return res


def serve_pipelined(svc, mid, reqs):
    """The same mix through the running pipeline: the lone request is
    collected before the rest are submitted, so it runs alone."""
    with svc:
        x, a, b, y, o = reqs[0]
        first = svc.result(svc.submit(mid, x, alpha=a, beta=b, y=y,
                                      owner=o), timeout=300)
        tickets = [svc.submit(mid, x, alpha=a, beta=b, y=y, owner=o)
                   for x, a, b, y, o in reqs[1:]]
        res = [first] + [svc.result(t, timeout=300) for t in tickets]
    if (first.batch_size, first.bucket_n) != (1, 1):
        raise AssertionError("pipelined lone request did not run alone")
    return res


def check_results(what, res, refs) -> float:
    worst = 0.0
    for r, (ref, scale) in zip(res, refs):
        worst = max(worst, check_close(what, torch.from_numpy(r.y),
                                       torch.from_numpy(ref).float(),
                                       torch.from_numpy(scale).float()))
    return worst


def span_seconds() -> dict:
    """Host seconds per traced span name (a span's time includes the
    spans nested in it; pipelined spans overlap across threads)."""
    out: dict = {}
    for buf in obs.TRACER.buffers():
        for ph, name, _, _, dur_ns, _, _ in buf.events:
            if ph == "X":
                out[name] = out.get(name, 0.0) + dur_ns / 1e9
    return out


def bound_ms(plan, n: int) -> tuple[float, str]:
    """Least time for one stream pass on this card: the stream's bytes
    (idx 4 B + value per slot, x read once, y written once) over the
    memory rate, or its flops over the fp32 rate, whichever is larger."""
    cfg = plan.config
    slots = int(plan.idx.size)
    live = int(np.count_nonzero(plan.idx != -1))
    x_rows = plan.num_segments_local * cfg.segment_width
    nbytes = (slots * (4 + cfg.value_bytes) + 4 * plan.idx.shape[1]
              + 4 * n * (x_rows + plan.out_rows_padded))
    flops = 2 * live * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# -- phase 4: the solvers -----------------------------------------------------
FUSED_EPILOGUES = {"pagerank": _pagerank_epilogue, "cg": _cg_epilogue,
                   "power": _power_epilogue}
# Iterations per timed run of a solver body: two chunks of the fused loop.
BODY_ITERS = 16
# Bytes of the state each fused step must read and write once, in units of
# one (R, LANES) fp32 vector: CG reads sol, r, p and writes them back;
# PageRank reads r and the mask and writes r; power iteration reads and
# writes v.
STATE_VECTORS = {"cg": 6, "pagerank": 3, "power": 2}


def spd_from_upper(rows, cols, vals, n):
    """The upper triangle mirrored, diagonal = row's Σ|off-diagonal| + 1:
    symmetric and strictly diagonally dominant, so SPD."""
    up = rows < cols
    r, c, v = rows[up], cols[up], vals[up]
    diag = np.bincount(np.concatenate([r, c]),
                       weights=np.abs(np.concatenate([v, v])),
                       minlength=n) + 1.0
    ar = np.arange(n, dtype=r.dtype)
    return (np.concatenate([r, c, ar]), np.concatenate([c, r, ar]),
            np.concatenate([v, v, diag.astype(np.float32)]))


def csr64(rows, cols, vals, shape):
    import scipy.sparse as sp
    return sp.csr_matrix((vals.astype(np.float64), (rows, cols)),
                         shape=shape)


def pagerank64(a, iters: int, damping: float = 0.85):
    """fp64 PageRank on the host, the solver's update, ``iters`` steps."""
    n = a.shape[0]
    r = np.full(n, 1.0 / n)
    for _ in range(iters):
        link = damping * (a @ r)
        r = link + (1.0 - link.sum()) / n
    return r


def fused_state(name, op, dev, seed):
    """x and extras of one fused step on the card: CG's first iteration
    from b, a PageRank step from 1/n, a power step from a random unit v."""
    n = op.shape[0]
    g = torch.Generator(device="cpu").manual_seed(seed)
    if name == "cg":
        b = op.to_acc_layout(torch.randn(n, generator=g).to(dev))
        extras = (torch.zeros_like(b), b.clone(), b.clone(),
                  (b * b).sum().reshape(1, 1))
        return op.from_acc_layout(extras[2]), extras
    if name == "pagerank":
        extras = (op.to_acc_layout(torch.full((n,), 1.0 / n, device=dev)),
                  op.to_acc_layout(torch.ones(n, device=dev)),
                  torch.tensor([[0.85, n]], device=dev))
        return op.from_acc_layout(extras[0]), extras
    v = torch.randn(n, generator=g).to(dev)
    extras = (op.to_acc_layout(v / v.norm()),)
    return op.from_acc_layout(extras[0]), extras


def compare_fused(name, op, dev) -> float:
    """One fused step against ``spmv_fused_plain`` on the same inputs;
    returns the largest absolute error over acc and every output."""
    ep = FUSED_EPILOGUES[name]
    x, extras = fused_state(name, op, dev, SEED)
    idx, val, seg = op._shards[0]
    cfg = op.config
    geo = dict(num_rows_padded=op.plan.out_rows_padded,
               segment_width=cfg.segment_width)
    want_acc, want = ks.spmv_fused_plain(idx, val, seg, x, extras,
                                         epilogue=ep, **geo)
    scale = ks.spmv_plain(idx, val.abs(), seg, ops.pad_x(
        x.abs(), op.plan.num_segments_local, cfg.segment_width), **geo)
    k_extras = tuple(e.clone() for e in extras)
    kx = op.from_acc_layout(k_extras[2 if name == "cg" else 0])
    acc, got = ks.spmv_fused(idx, val, seg, kx, k_extras, epilogue=ep,
                             tiles_per_chunk=cfg.tiles_per_chunk, **geo)
    torch.cuda.synchronize()
    worst = check_close(f"spmv_fused[{name}] acc vs plain", acc, want_acc,
                        scale)
    n_state = len(ks._EPILOGUES[ep].state)
    for i, (g, w) in enumerate(zip(got, want)):
        if i < n_state:
            j = ks._EPILOGUES[ep].state[i]
            mag = max(float(w.abs().max()), float(extras[j].abs().max()))
            worst = max(worst, check_close(
                f"spmv_fused[{name}] state {i} vs plain", g, w,
                torch.full_like(w, mag), atol=0.0))
            continue
        if name == "power" and i == 1:       # λ = Σ v·Av: signed terms
            terms = float((extras[0] * want_acc.view_as(extras[0]))
                          .abs().sum())
        else:                                # Σ r², Σ|Δr|, ‖Av − λv‖
            terms = float(w.abs().sum())
        worst = max(worst, check_close(
            f"spmv_fused[{name}] scalar {i} vs plain", g, w,
            torch.full_like(w, terms)))
    return worst


def solver_bodies(name, op, dev) -> dict:
    """The solvers' own fused and unfused loop bodies (``_solve_fused``/
    ``_solve_unfused`` in ``solvers/cg.py``, ``_pagerank_*`` and
    ``_power_*`` in ``solvers/power_iteration.py``), each set up to run
    :data:`BODY_ITERS` iterations from the same start, with a stop that
    no measure reaches.  The fused body enqueues the kernel chain and
    reads the loop's control word once per chunk; the unfused one runs
    the spmv kernel, torch vector ops and a host read per iteration."""
    n = op.shape[0]
    g = torch.Generator(device="cpu").manual_seed(SEED + 1)
    if name == "cg":
        b = torch.randn(n, generator=g).to(dev)
        args = (torch.zeros_like(b), b, torch.dot(b, b))
        bodies = (_solve_fused, _solve_unfused)
    elif name == "pagerank":
        args = (torch.full((n,), 1.0 / n, device=dev), 0.85)
        bodies = (_pagerank_fused, _pagerank_unfused)
    else:
        v = torch.randn(n, generator=g).to(dev)
        args = (v / v.norm(),)
        bodies = (_power_fused, _power_unfused)
    return {kind: functools.partial(body, op, *args, -1.0, BODY_ITERS, None)
            for kind, body in zip(("fused", "unfused"), bodies)}


def time_fused(name, op, dev, csr) -> dict:
    """CUDA-event ms of one fused step (the kernel chain), of one
    iteration of the solvers' fused and unfused bodies
    (:func:`solver_bodies`), of the plain version, and of ``torch.mv`` on
    CSR + the epilogue in torch ops."""
    ep = FUSED_EPILOGUES[name]
    cfg = op.config
    idx, val, seg = op._shards[0]
    geo = dict(num_rows_padded=op.plan.out_rows_padded,
               segment_width=cfg.segment_width)
    x, extras = fused_state(name, op, dev, SEED + 1)
    loop = ks.FusedLoop(dev, stop=-float("inf"), max_iters=1 << 30,
                        scalars=(0.0,) * ks._EPILOGUES[ep].scalars)

    def fused():
        ks.spmv_fused(idx, val, seg, x, extras, epilogue=ep, loop=loop,
                      tiles_per_chunk=cfg.tiles_per_chunk, **geo)

    lanes = cfg.lanes
    m = op.shape[0]
    buf = torch.zeros(geo["num_rows_padded"], device=dev)

    def library():
        buf[:m].copy_(torch.mv(csr, x))
        ep(buf.view(-1, lanes), *extras)

    bodies = solver_bodies(name, op, dev)
    # The library step reads the state the fused timing left.
    return {"ms": time_ms(fused, 20),
            "fused_iter_ms": time_ms(bodies["fused"], 3) / BODY_ITERS,
            "unfused_iter_ms": time_ms(bodies["unfused"], 3) / BODY_ITERS,
            "plain_ms": time_ms(functools.partial(
                ks.spmv_fused_plain, idx, val, seg, x, extras, epilogue=ep,
                **geo), 3),
            "library_ms": time_ms(library, 20)}


def fused_bound(name, op) -> tuple[float, str]:
    """Least time of one fused step: the stream's bytes and the state
    vectors read/written once over the memory rate, or its flops (2 per
    live slot plus ~10 per state element) over the fp32 rate."""
    plan, cfg = op.plan, op.config
    slots = int(plan.idx.size)
    live = int(np.count_nonzero(plan.idx != -1))
    rp = plan.out_rows_padded
    nbytes = (slots * (4 + cfg.value_bytes) + 4 * plan.idx.shape[1]
              + 4 * STATE_VECTORS[name] * rp)
    flops = 2 * live + 10 * rp
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def zero_launches() -> None:
    ks.spmv_launches = ks.spmm_launches = ks.spmv_fused_launches = 0


def read_launches() -> dict:
    return {"spmv": ks.spmv_launches, "spmm": ks.spmm_launches,
            "spmv_fused": ks.spmv_fused_launches}


def phase_solvers(reg, svc, rows, cols, vals, shape, dev, t_run, card):
    """Phase 4; returns (launches, max error, timings, bounds) of the
    fused kernel's main-path runs."""
    t = time.perf_counter()
    m = shape[0]
    gv = column_normalize(rows, cols, vals, m)
    pmid = reg.put(rows, cols, gv, shape)
    pop = reg.get(pmid)
    say(f"[phase4] G7 column-normalised: registry put "
        f"{time.perf_counter() - t:.1f} s, fusable "
        f"{pop.supports_fused_epilogue}")

    g5_scale = 1.0
    if time.perf_counter() - t_run > SLOW_RUN_S:
        g5_scale = G5_SMALL_SCALE
        say(f"[phase4] run past {SLOW_RUN_S:.0f} s: G5 at scale {g5_scale}")
    t = time.perf_counter()
    r5, c5, v5, shape5, _ = paper_matrix("G5", scale=g5_scale, seed=SEED)
    sr, sc, sv = spd_from_upper(r5, c5, v5, shape5[0])
    n5 = shape5[0]
    smid = reg.put(sr, sc, sv, shape5)
    sop = reg.get(smid)
    say(f"[phase4] G5 stand-in SPD {n5} x {n5}, nnz {sv.size}, scale "
        f"{g5_scale}: generated and put in {time.perf_counter() - t:.1f} s")
    b = np.random.default_rng(SEED + 2).standard_normal(n5) \
        .astype(np.float32)

    solves = {"pagerank": (pmid, "pagerank", dict(tol=1e-6, max_iters=200)),
              "cg": (smid, "cg", dict(b=b, tol=1e-6, timeout=600)),
              "power": (smid, "power_iteration", dict(max_iters=100))}

    def solve_all(**over):
        """Each solve through the service; host seconds per solve (the
        result is on the host when solve returns)."""
        out, secs = {}, {}
        for k, (mid_k, kind_k, kw) in solves.items():
            t0 = time.perf_counter()
            out[k] = svc.solve(mid_k, kind_k, **{**kw, **over})
            secs[k] = time.perf_counter() - t0
        return out, secs

    # Warm-up (first-use costs such as cuBLAS's handle for torch.dot stay
    # out of the timed solves), then the main path: every solve fused,
    # counts from 0.
    solve_all(max_iters=2)
    solve_all(max_iters=2, fused=False)
    zero_launches()
    torch.cuda.synchronize()
    runs, secs = solve_all()
    torch.cuda.synchronize()
    launches = read_launches()
    iters = {k: r.solve.iterations for k, r in runs.items()}
    say(f"[phase4] fused solves: iterations {iters}, launches {launches}, "
        f"host syncs per solve "
        f"{ {k: r.solve.host_syncs for k, r in runs.items()} }, seconds "
        f"{ {k: round(v, 4) for k, v in secs.items()} }, ms per iteration "
        f"{ {k: round(1e3 * secs[k] / max(iters[k], 1), 4) for k in secs} }"
        f"  [{card}]")
    for k, r in runs.items():
        if not r.solve.fused:
            raise AssertionError(f"{k} did not run fused")
    if launches["spmv_fused"] < sum(iters.values()):
        raise AssertionError(f"spmv_fused launched {launches} times for "
                             f"{iters} iterations")
    pr, cg, pw = runs["pagerank"], runs["cg"], runs["power"]
    if not (pr.solve.converged and cg.solve.converged):
        raise AssertionError("PageRank or CG did not converge")

    # Against fp64 host references.
    t = time.perf_counter()
    a7 = csr64(rows, cols, gv, shape)
    r64 = pagerank64(a7, pr.solve.iterations)
    r_err = check_close("G7 PageRank vs fp64", torch.from_numpy(pr.y),
                        torch.from_numpy(r64).float(),
                        torch.full((m,), float(r64.max())), atol=1e-9)
    if abs(float(pr.y.sum()) - 1.0) >= 1e-3:
        raise AssertionError(f"PageRank sums to {float(pr.y.sum())}")
    a5 = csr64(sr, sc, sv, shape5)
    x64 = cg.y.astype(np.float64)
    true_res = float(np.linalg.norm(b - a5 @ x64) / np.linalg.norm(b))
    if true_res > 1e-4:
        raise AssertionError(f"CG true residual {true_res}")
    v64 = pw.y.astype(np.float64)
    rq = float(v64 @ (a5 @ v64) / (v64 @ v64))
    lam_rel = abs(pw.solve.eigenvalue - rq) / abs(rq)
    if lam_rel > 1e-4:
        raise AssertionError(f"power λ {pw.solve.eigenvalue} vs fp64 "
                             f"Rayleigh quotient {rq}")
    say(f"[phase4] vs fp64 ({time.perf_counter() - t:.1f} s): PageRank "
        f"max err {r_err:.3e} (sum {float(pr.y.sum()):.7f}, delta "
        f"{pr.solve.residual:.3e}); CG true residual {true_res:.3e} "
        f"(recursive {cg.solve.residual / np.linalg.norm(b):.3e}); power "
        f"λ {pw.solve.eigenvalue:.6f} vs {rq:.6f} (rel {lam_rel:.2e}, "
        f"residual {pw.solve.residual:.3e})")

    # Fused against unfused on the card.
    un, usecs = solve_all(fused=False)
    for k, u in un.items():
        if abs(u.solve.iterations - iters[k]) > 1:
            raise AssertionError(f"{k}: unfused {u.solve.iterations} vs "
                                 f"fused {iters[k]} iterations")
    pe = check_close("G7 PageRank fused vs unfused",
                     torch.from_numpy(pr.y),
                     torch.from_numpy(un["pagerank"].y),
                     torch.full((m,), float(pr.y.max())), atol=1e-9)
    # CG and power iteration: both runs stop within 1e-6 of a solution of
    # the same system, so they agree to ~κ·1e-6 of the solution's scale.
    ce = check_close("G5 CG fused vs unfused", torch.from_numpy(cg.y),
                     torch.from_numpy(un["cg"].y),
                     torch.full((n5,), 100.0 * float(np.abs(cg.y).max())))
    lam_un = abs(un["power"].solve.eigenvalue - pw.solve.eigenvalue) \
        / abs(pw.solve.eigenvalue)
    if lam_un > 1e-5:
        raise AssertionError(f"power λ fused vs unfused rel {lam_un}")
    ums = {k: round(1e3 * usecs[k] / max(u.solve.iterations, 1), 4)
           for k, u in un.items()}
    say(f"[phase4] unfused solves: iterations "
        f"{ {k: u.solve.iterations for k, u in un.items()} }, host syncs "
        f"{ {k: u.solve.host_syncs for k, u in un.items()} }, ms per "
        f"iteration {ums}  [{card}]; PageRank "
        f"max |fused - unfused| {pe:.3e}, CG {ce:.3e}, power λ rel "
        f"{lam_un:.2e}")

    # Kernel against plain, one step per epilogue at the main shapes.
    t = time.perf_counter()
    ops_by = {"pagerank": pop, "cg": sop, "power": sop}
    err = max(compare_fused(k, ops_by[k], dev) for k in FUSED_EPILOGUES)
    say(f"[phase4] fused step vs plain (G7 pagerank, G5 cg/power): max "
        f"err {err:.3e} in {time.perf_counter() - t:.1f} s")

    # Timings.
    t = time.perf_counter()
    with warnings.catch_warnings():     # torch.sparse's beta notices
        warnings.simplefilter("ignore", UserWarning)
        csr7 = torch.sparse_csr_tensor(
            torch.from_numpy(a7.indptr).long(),
            torch.from_numpy(a7.indices).long(),
            torch.from_numpy(a7.data).float(), shape).to(dev)
        csr5 = torch.sparse_csr_tensor(
            torch.from_numpy(a5.indptr).long(),
            torch.from_numpy(a5.indices).long(),
            torch.from_numpy(a5.data).float(), shape5).to(dev)
    csr_by = {"pagerank": csr7, "cg": csr5, "power": csr5}
    times, bounds = {}, {}
    for k in FUSED_EPILOGUES:
        times[k] = time_fused(k, ops_by[k], dev, csr_by[k])
        bounds[k] = fused_bound(k, ops_by[k])
        tm, (bd, by) = times[k], bounds[k]
        where = "G7" if k == "pagerank" else f"G5 x{g5_scale}"
        say(f"[phase4] {k} step ({where}): fused {tm['ms']:.4f} ms, "
            f"per iteration of the solver's fused body "
            f"{tm['fused_iter_ms']:.4f} ms and unfused body "
            f"{tm['unfused_iter_ms']:.4f} ms "
            f"({tm['unfused_iter_ms'] / tm['fused_iter_ms']:.2f}x), plain "
            f"{tm['plain_ms']:.4f} ms, torch.sparse CSR + epilogue "
            f"{tm['library_ms']:.4f} ms, bound {bd:.4f} ms ({by}); "
            f"{bd / tm['ms']:.3f} of the bound  [{card}]")
    say(f"[phase4] timings in {time.perf_counter() - t:.1f} s")
    return launches, max(err, 0.0), times, bounds


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    t_run = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    say(card)
    say(f"device: {kind}  count: {torch.cuda.device_count()}  torch "
        f"{torch.__version__}  cuda {torch.version.cuda}")
    say(json.dumps({"kernel_names": sorted(KERNELS)}))

    t = time.perf_counter()
    path, log = ks.build()
    say(f"[build] {path.name} in {time.perf_counter() - t:.1f} s")
    if log.strip():
        say(log.strip())

    # -- setup: the G7 stand-in, encoded once by the registry -------------
    t = time.perf_counter()
    rows, cols, vals, shape, meta = paper_matrix("G7", scale=1.0, seed=SEED)
    m, k = shape
    say(f"[setup] G7 {meta['name']} stand-in {m} x {k}, nnz {vals.size}, "
        f"generated in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    reg = MatrixRegistry(byte_budget=16 << 30, device="cuda")
    mid = reg.put(rows, cols, vals, shape)
    op = reg.get(mid)
    plan = op.plan
    say(f"[setup] registry put (encode + bind) {time.perf_counter() - t:.1f}"
        f" s: {plan.idx.size} slots, padding {plan.padding_ratio:.3f}, "
        f"{plan.stream_bytes / 1e6:.1f} MB stream, "
        f"{op.device_bytes / 1e6:.1f} MB on the card")

    # -- phase 1: kernels against their plain versions ---------------------
    t = time.perf_counter()
    rng = np.random.default_rng(SEED)
    errs = {"spmv": 0.0, "spmm": 0.0}
    idx, val, seg, geo = stream_on_card(plan, dev)
    kp = plan.num_segments_local * plan.config.segment_width
    tpc = plan.config.tiles_per_chunk
    x1 = ops.pad_x(torch.from_numpy(
        rng.standard_normal(k).astype(np.float32)).to(dev),
        plan.num_segments_local, plan.config.segment_width)
    errs["spmv"] = max(errs["spmv"],
                       compare_kernel("spmv", idx, val, seg, x1, geo, tpc))
    for n in (2, 16):
        xn = ops.pad_rows(torch.from_numpy(
            rng.standard_normal((k, n)).astype(np.float32)).to(dev), kp)
        errs["spmm"] = max(errs["spmm"], compare_kernel(
            "spmm", idx, val, seg, xn, geo, tpc))
    say(f"[phase1] G7 fp32 stream: spmv err {errs['spmv']:.3e}, "
        f"spmm (N=2,16) err {errs['spmm']:.3e}")

    bf_plan = cpart.make_plan(
        rows, cols, vals, shape,
        sformat.SerpensConfig(value_dtype="bfloat16"), cpart.PlanSpec())
    bidx, bval, bseg, bgeo = stream_on_card(bf_plan, dev)
    if bval.dtype != torch.bfloat16:
        raise AssertionError(f"bf16 stream arrived as {bval.dtype}")
    e = compare_kernel("spmv", bidx, bval, bseg, x1, bgeo, tpc)
    errs["spmv"] = max(errs["spmv"], e)
    say(f"[phase1] G7 bf16 stream: spmv err {e:.3e}")

    r2, c2, v2, shape2, _ = paper_matrix("G7", scale=0.1, seed=SEED)
    opt_plan = cpart.make_plan(r2, c2, v2, shape2, sformat.OPTIMIZED_CONFIG,
                               cpart.PlanSpec())
    oidx, oval, oseg, ogeo = stream_on_card(opt_plan, dev)
    ocfg = opt_plan.config
    okp = opt_plan.num_segments_local * ocfg.segment_width
    xo = rng.standard_normal(shape2[1]).astype(np.float32)
    xo_d = ops.pad_rows(torch.from_numpy(xo).to(dev), okp)
    e1 = compare_kernel("spmv", oidx, oval, oseg, xo_d, ogeo,
                        ocfg.tiles_per_chunk)
    xo16 = ops.pad_rows(torch.from_numpy(rng.standard_normal(
        (shape2[1], 16)).astype(np.float32)).to(dev), okp)
    e2 = compare_kernel("spmm", oidx, oval, oseg, xo16, ogeo,
                        ocfg.tiles_per_chunk)
    errs["spmv"], errs["spmm"] = max(errs["spmv"], e1), max(errs["spmm"], e2)
    oop = SerpensOperator(opt_plan, device=dev)
    ref, scale = host_reference(r2, c2, v2.astype(np.float64), shape2[0],
                                xo, 1.0, 0.0, None)
    e3 = check_close("OPTIMIZED operator (stream + aux spill) vs fp64",
                     oop.matvec(xo).cpu(), torch.from_numpy(ref).float(),
                     torch.from_numpy(scale).float())
    say(f"[phase1] G7 x0.1 OPTIMIZED_CONFIG ({opt_plan.n_aux} spilled): "
        f"spmv err {e1:.3e}, spmm err {e2:.3e}, operator vs fp64 "
        f"{e3:.3e}")
    del oop, oidx, oval, oseg, xo_d, xo16
    say(f"[phase1] ok in {time.perf_counter() - t:.1f} s")

    # -- phase 2: the server answers requests (the main path) -------------
    reqs = make_requests(np.random.default_rng(SEED + 1), m, k)
    t = time.perf_counter()
    vals64 = vals.astype(np.float64)
    refs = [host_reference(rows, cols, vals64, m, x, a, b, y)
            for x, a, b, y, _ in reqs]
    say(f"[phase2] fp64 host references in {time.perf_counter() - t:.1f} s")
    svc = SpMVService(reg, max_bucket=16, device="cuda")
    launches = {}
    rps = {}
    t2 = time.perf_counter()
    for run, drive in (("sync", serve_sync), ("pipelined", serve_pipelined)):
        obs.clear()
        obs.enable()
        zero_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = drive(svc, mid, reqs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        launches[run] = read_launches()
        obs.disable()
        spans = span_seconds()
        rps[run] = len(res) / dt
        worst = check_results(f"{run} service vs fp64 reference", res, refs)
        say(f"[phase2] {run}: {len(res)} requests in {dt:.3f} s "
            f"({rps[run]:.1f} req/s), launches {launches[run]}, "
            f"batches {sorted({(r.batch_size, r.bucket_n) for r in res})}, "
            f"max err {worst:.3e}")
        say(f"[phase2] {run} host seconds by span: " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(spans.items(),
                                              key=lambda kv: -kv[1])))
    for name in ("spmv", "spmm"):
        if sum(v[name] for v in launches.values()) == 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"serving path")
    stats = reg.stats_snapshot()
    if stats.evictions or stats.bindings_dropped:
        raise AssertionError(f"registry shed the G7 entry: {stats}")
    say(f"[phase2] ok in {time.perf_counter() - t2:.1f} s: service stats "
        f"{svc.stats}")

    # -- phase 3: timings at the G7 shapes --------------------------------
    t3 = time.perf_counter()
    x16 = ops.pad_rows(torch.from_numpy(rng.standard_normal(
        (k, 16)).astype(np.float32)).to(dev), kp)
    p = functools.partial
    with warnings.catch_warnings():     # torch.sparse's beta notices
        warnings.simplefilter("ignore", UserWarning)
        csr = torch.sparse_coo_tensor(
            torch.from_numpy(np.stack([rows, cols])), torch.from_numpy(vals),
            shape).to(dev).coalesce().to_sparse_csr()
    times = {
        "spmv": {
            "ms": time_ms(p(ks.spmv, idx, val, seg, x1,
                            tiles_per_chunk=tpc, **geo), 50),
            "plain_ms": time_ms(p(ks.spmv_plain, idx, val, seg, x1,
                                  **geo), 10),
            "library_ms": time_ms(p(torch.mv, csr,
                                    x1[:k].contiguous()), 50)},
        "spmm": {
            "ms": time_ms(p(ks.spmm, idx, val, seg, x16,
                            tiles_per_chunk=tpc, **geo), 20),
            "plain_ms": time_ms(p(ks.spmm_plain, idx, val, seg, x16,
                                  **geo), 5),
            "library_ms": time_ms(p(torch.mm, csr,
                                    x16[:k].contiguous()), 20)},
    }
    bf_ms = time_ms(p(ks.spmv, bidx, bval, bseg, x1, tiles_per_chunk=tpc,
                      **bgeo), 50)
    bounds = {"spmv": bound_ms(plan, 1), "spmm": bound_ms(plan, 16)}
    bf_bound = bound_ms(bf_plan, 1)
    for name in ("spmv", "spmm"):
        b, by = bounds[name]
        tm = times[name]
        n = 1 if name == "spmv" else 16
        say(f"[phase3] {name} (N={n}, fp32, G7): kernel {tm['ms']:.4f} ms, "
            f"plain {tm['plain_ms']:.4f} ms, torch.sparse CSR "
            f"{tm['library_ms']:.4f} ms, bound {b:.4f} ms ({by}); "
            f"{b / tm['ms']:.3f} of the bound "
            f"({b / tm['ms'] * HBM_BYTES_PER_S / 1e9:.1f} GB/s)  [{card}]")
    say(f"[phase3] spmv (N=1, bf16, G7): kernel {bf_ms:.4f} ms, bound "
        f"{bf_bound[0]:.4f} ms; {bf_bound[0] / bf_ms:.3f} of the bound  "
        f"[{card}]")
    say(f"[phase3] requests/s: sync {rps['sync']:.1f}, pipelined "
        f"{rps['pipelined']:.1f}  [{card}]")
    say(f"[phase3] ok in {time.perf_counter() - t3:.1f} s")

    # -- phase 4: the solvers (the second slice's main path) --------------
    t4 = time.perf_counter()
    launches["solvers"], errs["spmv_fused"], ftimes, fbounds = \
        phase_solvers(reg, svc, rows, cols, vals, shape, dev, t_run, card)
    reg.close()
    # The fused kernel's record row is the G7 PageRank step, the slice's
    # served path at full size.
    times["spmv_fused"] = ftimes["pagerank"]
    bounds["spmv_fused"] = fbounds["pagerank"]
    say(f"[phase4] ok in {time.perf_counter() - t4:.1f} s; whole run "
        f"{time.perf_counter() - t_run:.1f} s")
    total = {name: sum(v[name] for v in launches.values())
             for name in KERNELS}
    for name, count in total.items():
        if count == 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"main paths")

    record = {"kernels": [
        dict(name=name, **KERNELS[name], launches=total[name],
             max_abs_err=errs[name], ms=times[name]["ms"],
             plain_ms=times[name]["plain_ms"], bound_ms=bounds[name][0],
             bound_by=bounds[name][1], library_ms=times[name]["library_ms"])
        for name in sorted(KERNELS)]}
    say(json.dumps(record))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
