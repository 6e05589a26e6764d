#!/usr/bin/env python3
"""The SpMM kernel's design steps and source variants, timed on one GPU at
the G7 stand-in.

Run from the repository root::

    python3 tools/spmm_variants.py

Each variant is the committed ``csrc/serpens_spmv.cu`` with the edits in
``VARIANTS``; all are built at once with the repository's nvcc flags into
``build/variants/`` and print their ptxas report.  The G7 ``soc_pokec``
stand-in is encoded at full size with the default ``SerpensConfig()``
(fp32 stream).  At N = 2, 4, 8 and 16 every entry below is timed with CUDA
events beside ``torch.mm`` on the same matrix in CSR (a yardstick the
port never calls), each twice in turns (one order, then the reverse; the
mean is printed).  Every entry that computes the product is first held
against ``spmm_plain`` within ``1e-5·(|A|·|X|) + 1e-6`` elementwise; the
diagnostic variants compute something else and are timed only.

Entries: ``planned`` (:func:`spmm` as the server calls it: ``spmm_plan``'s
row windows); each variant in one pass, and each variant that computes the
product also in the plan's windows; the committed source in
``ROW_PASSES`` row passes, each over the whole stream applying the slots
of one equal window of rows (the kernel's ``[row_lo, row_hi)``); and at
narrower vector widths.

It also counts, for the G7 stream and for an ``OPTIMIZED_CONFIG`` (raw
window 2) stream of the stand-in at scale 0.1, the live slots, the
distinct (tile, lane, row) triples among them (the reductions an in-tile
row merge could save) and the distinct (segment, row) pairs (what a merge
across the tiles of one segment could save at most).  The last line is
one JSON object of the mean times.  It needs a CUDA card and ``nvcc``,
and imports nothing of the JAX package.
"""
from __future__ import annotations

import functools
import json
import os
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
import variant_build as vb  # noqa: E402

ks = cs.ks
SOURCE = ks._build.CSRC / "serpens_spmv.cu"
NS = (2, 4, 8, 16)
ITERS = 20
ROW_PASSES = (1, 2, 3, 4, 6)    # row windows of the row-pass entries
FOLD_ROWS = 262144              # rows the folded-acc diagnostic keeps

RED = ("atomicAdd(reinterpret_cast<T*>(acc + dst[i] * n + j[i]),\n"
       "                    scaled(a[i], xv[i]));")
GATHER = "xv[i] = *reinterpret_cast<const T*>(x + col[i] * n + j[i]);"
DST = "s_dst[at] = static_cast<int32_t>(d);"
BATCH = "constexpr int kBatch = VEC == 4 ? 4 : 8;"
# name -> ([(text in the committed source, its replacement)], computes A·X)
VARIANTS = {
    "built": ([], True),
    "batch 8 at v4": ([(BATCH, "constexpr int kBatch = 8;")], True),
    "batch 4 at v1, v2": ([(BATCH, "constexpr int kBatch = 4;")], True),
    # Diagnostics: what the time is made of.
    "stores, not reductions": ([(RED, "*reinterpret_cast<T*>(acc + dst[i] "
                                "* n + j[i]) = scaled(a[i], xv[i]);")],
                               False),
    "no x gather": ([(GATHER, "xv[i] = *reinterpret_cast<const T*>(x + "
                      "j[i]);")], False),
    "acc folded into L2": ([(DST, "s_dst[at] = static_cast<int32_t>(d % "
                             f"{FOLD_ROWS});")], False),
}


variant_source = functools.partial(vb.variant_source, SOURCE)


def build_variant(name: str):
    """nvcc of one variant; returns (library, ptxas summary per
    instantiation)."""
    lib, report = vb.nvcc_build(
        "spmm_" + name, variant_source(VARIANTS[name][0]),
        r"spmm_kernelI(f|13__nv_bfloat16)Li(\d)E",
        lambda hit: f"{'fp32' if hit[1] == 'f' else 'bf16'} v{hit[2]}")
    ks._declare(lib)
    return lib, report


def duplicate_ratio(idx, seg) -> tuple[int, int, int]:
    """(live slots, distinct (tile, lane, row) triples among them,
    distinct (segment, row) pairs among them)."""
    live = idx != -1
    rows = torch.where(live, (idx.to(torch.int64) & 0xFFFFFFFF) >> 16, -1)
    lanes = idx.shape[2]
    glob = rows * lanes + torch.arange(lanes, device=idx.device)
    pairs = (seg.to(torch.int64)[:, None, None] << 32) + glob
    distinct_pairs = int(torch.unique(pairs[live]).numel())
    rows = rows.sort(dim=1).values                    # along the sublanes
    fresh = torch.ones_like(rows, dtype=torch.bool)
    fresh[:, 1:] = rows[:, 1:] != rows[:, :-1]
    return (int(live.sum()), int((fresh & (rows != -1)).sum()),
            distinct_pairs)


def run_passes(lib, idx, val, seg, x, geo, vec, *, row_passes=1):
    """A variant's kernel in ``row_passes`` equal windows of rows, all into
    the one output (no launch is counted)."""
    r, n = geo["num_rows_padded"], x.shape[1]
    num_tiles, sub, lanes = idx.shape
    stream = torch.cuda.current_stream().cuda_stream
    acc = torch.zeros((r, n), dtype=torch.float32, device=x.device)
    for i in range(row_passes):
        ks._raise_on(lib.serpens_spmm(
            idx.data_ptr(), val.data_ptr(), seg.data_ptr(), x.data_ptr(),
            acc.data_ptr(), num_tiles, sub, lanes, geo["segment_width"], n,
            vec, x.shape[0], r * i // row_passes, r * (i + 1) // row_passes,
            int(val.dtype == torch.bfloat16), stream), "serpens_spmm")
    return acc


def entries(vec, windows, libs):
    """name -> (lib, vec, run_passes options, passes, computes A·X)."""
    out = {f"{name}, one pass": (libs[name], vec, {}, 1, checked)
           for name, (_, checked) in VARIANTS.items()}
    if windows > 1:
        for name, (_, checked) in VARIANTS.items():
            if checked and name != "built":
                out[f"{name}, {windows} row passes"] = (
                    libs[name], vec, {"row_passes": windows}, windows, True)
    for rp in ROW_PASSES[1:]:
        out[f"built, {rp} row passes"] = (libs["built"], vec,
                                          {"row_passes": rp}, rp, True)
    for v in (2, 1):
        if v < vec:
            out[f"built, one pass, vec {v}"] = (libs["built"], v, {}, 1,
                                                True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("spmm_variants: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = cs.card_line()
    cs.say(card)
    built = vb.build_all({name: (build_variant, name) for name in VARIANTS})
    libs = {name: lib for name, (lib, _) in built.items()}
    for name, (_, report) in built.items():
        cs.say(f"[ptxas] {name}: " + "; ".join(report))
    t = time.perf_counter()
    rows, cols, vals, shape, _ = cs.paper_matrix("G7", scale=1.0,
                                                 seed=cs.SEED)
    plan = cs.cpart.make_plan(rows, cols, vals, shape,
                              cs.sformat.SerpensConfig(), cs.cpart.PlanSpec())
    idx, val, seg, geo = cs.stream_on_card(plan, dev)
    kp = plan.num_segments_local * plan.config.segment_width
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    cs.say(f"[setup] G7 {shape[0]} x {shape[1]}, R_pad "
           f"{geo['num_rows_padded']}, {plan.stream_bytes / 1e6:.1f} MB "
           f"stream, L2 {l2} B, in {time.perf_counter() - t:.1f} s")
    r2, c2, v2, shape2, _ = cs.paper_matrix("G7", scale=0.1, seed=cs.SEED)
    oplan = cs.cpart.make_plan(r2, c2, v2, shape2, cs.sformat.OPTIMIZED_CONFIG,
                               cs.cpart.PlanSpec())
    oidx, _, oseg, _ = cs.stream_on_card(oplan, dev)
    for label, (i_, s_) in (("G7 default config", (idx, seg)),
                            ("G7 x0.1 OPTIMIZED_CONFIG (raw window "
                             f"{oplan.config.raw_window})", (oidx, oseg))):
        live, triples, pairs = duplicate_ratio(i_, s_)
        cs.say(f"[dup] {label}: {live} live slots, {triples} distinct "
               f"(tile, lane, row), ratio {live / triples:.4f}; {pairs} "
               f"distinct (segment, row), ratio {live / pairs:.4f}")
    del oidx, oseg
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        csr = torch.sparse_coo_tensor(
            torch.from_numpy(np.stack([rows, cols])), torch.from_numpy(vals),
            shape).to(dev).coalesce().to_sparse_csr()
    rng = np.random.default_rng(cs.SEED)
    record = {"card": card}
    for n in NS:
        x = cs.ops.pad_rows(torch.from_numpy(rng.standard_normal(
            (shape[1], n)).astype(np.float32)).to(dev), kp)
        sp = ks.spmm_plan(x, geo["num_rows_padded"], l2)
        want = ks.spmm_plain(idx, val, seg, x, **geo)
        scale = ks.spmm_plain(idx, val.abs(), seg, x.abs(), **geo)
        fns = {"planned": lambda x=x: ks.spmm(idx, val, seg, x, **geo)}
        passes = {"planned": len(sp.windows)}
        checked = {"planned": True}
        for name, (lib, vec, kw, npass, ok) in entries(
                sp.vec, len(sp.windows), libs).items():
            fns[name] = (lambda x=x, lib=lib, vec=vec, kw=kw: run_passes(
                lib, idx, val, seg, x, geo, vec, **kw))
            passes[name], checked[name] = npass, ok
        for name, fn in fns.items():
            if checked[name]:
                cs.check_close(f"N={n} {name} vs plain", fn(), want, scale)
        del want, scale
        xk = x[:shape[1]].contiguous()
        fns["torch.mm CSR"] = lambda xk=xk: torch.mm(csr, xk)
        turns = cs.in_turns(fns, ITERS)
        ms = turns["reads"]
        lib_ms = turns["torch.mm CSR"]
        record[str(n)] = {}
        b = cs.bound_ms(plan, n)[0]
        for name in fns:
            mean = turns[name]
            npass = passes.get(name, 1)
            bp = cs.bound_ms(plan, n, npass)[0]
            record[str(n)][name] = {"ms": mean, "passes": npass}
            tag = "" if checked.get(name, True) else " [diagnostic]"
            cs.say(f"[N={n}] {name}{tag}: {mean:.4f} ms ({ms[name][0]:.4f} "
                   f"/ {ms[name][1]:.4f}), {npass} pass(es), bound {b:.4f} "
                   f"ms, with its passes {bp:.4f} ms; {lib_ms / mean:.2f}x "
                   f"the speed of CSR  [{card}]")
        cs.say(f"[N={n}] plan: vec {sp.vec}, row windows {sp.windows}")
    cs.say(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
