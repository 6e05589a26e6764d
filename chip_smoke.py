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
from repro_torch.data.matrices import paper_matrix  # noqa: E402
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
}


def say(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def check_close(what: str, got, want, scale) -> float:
    """Elementwise ``|got - want| <= TOL_REL * scale + TOL_ABS``; returns
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
    bad = err > TOL_REL * scale + TOL_ABS
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
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
    for run, drive in (("sync", serve_sync), ("pipelined", serve_pipelined)):
        obs.clear()
        obs.enable()
        ks.spmv_launches = ks.spmm_launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = drive(svc, mid, reqs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        launches[run] = {"spmv": ks.spmv_launches, "spmm": ks.spmm_launches}
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
    total = {name: sum(v[name] for v in launches.values())
             for name in KERNELS}
    for name, count in total.items():
        if count == 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"serving path")
    stats = reg.stats_snapshot()
    if stats.evictions or stats.bindings_dropped:
        raise AssertionError(f"registry shed the G7 entry: {stats}")
    say(f"[phase2] ok: service stats {svc.stats}")

    # -- phase 3: timings at the G7 shapes --------------------------------
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
    for name in KERNELS:
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
    reg.close()

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
