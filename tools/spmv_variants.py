#!/usr/bin/env python3
"""The SpMV stream pass's plans and source variants, timed on one GPU at
the G7 (default) or G5 stand-in.

Run from the repository root::

    python3 tools/spmv_variants.py [--matrix G7|G5] [--parent DIR]

Each variant is the committed ``csrc/serpens_spmv.cu`` with the edits in
``VARIANTS``; all are built at once with the repository's nvcc flags into
``build/variants/`` and print their ptxas report.  The stand-in (G7
``soc_pokec`` or G5 ``ML_Laplace``) is encoded at full size with the
default ``SerpensConfig()`` (fp32 stream, and a bf16 stream for the
``bf16`` entries).  Every entry is timed with CUDA events beside
``torch.mv`` on the same matrix in CSR (a yardstick the port never
calls), each twice in turns (one order, then the reverse; the mean is
printed).  Every entry that computes the product is first held against
``spmv_plain`` within ``1e-5·(|A|·|x|) + 1e-6`` elementwise; the
diagnostic variants compute something else and are timed only.

Entries: ``planned`` (:func:`spmv` as the server calls it, fp32 and
bf16 streams); each variant on the plan; the committed source on other
plans (``PLANS``: other lane groups, with the windows they need, and
other split counts), on both streams; and, with ``--parent DIR`` (an
unpacked tree of an earlier commit), that tree's own ``spmv`` wrapper on
its own source, built here.  Last, at G7, the pass as built and at each
carve-out, and CSR, on the stand-in at scale 0.1, whose stream stays in
L2 between calls.  The last line is one JSON object of
the mean times.  It needs a CUDA card and ``nvcc``, and imports nothing
of the JAX package.
"""
from __future__ import annotations

import argparse
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
ITERS = 50

UNROLL = "constexpr int kSpmvUnroll = 4;"
THREADS = "constexpr int kSpmvThreads = 1024;"
GATHER = "xv[u] = live ? __ldg(x + col) : 0.f;"
RED = "if (dst[u] >= 0) atomicAdd(s_acc + dst[u], v[u] * xv[u]);"
CONST_X = (GATHER, "xv[u] = live ? __ldg(x) : 0.f;")
STORES = (RED, "if (dst[u] >= 0) s_acc[dst[u]] = v[u] * xv[u];")
ALLOW = """  err = cudaFuncSetAttribute(spmv_kernel<V>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSpmvMaxSmem);
"""


def carveout(pct: int) -> tuple:
    """The edit that also asks for a ``pct`` % shared-memory carve-out (the
    committed source leaves it to the driver)."""
    return (ALLOW, ALLOW + "  if (err == cudaSuccess)\n    err = "
            "cudaFuncSetAttribute(spmv_kernel<V>, cudaFuncAttributePreferred"
            f"SharedMemoryCarveout, {pct});\n")


# name -> ([(text in the committed source, its replacement)], computes A·x)
VARIANTS = {
    "built": ([], True),
    "unroll 2": ([(UNROLL, "constexpr int kSpmvUnroll = 2;")], True),
    "unroll 8": ([(UNROLL, "constexpr int kSpmvUnroll = 8;")], True),
    "512 threads": ([(THREADS, "constexpr int kSpmvThreads = 512;")], True),
    # 100: all shared (228 KB, 28 KB of L1); 82: 196 KB, the least that
    # holds G5's 188,544 B block.
    "carve-out 100%": ([carveout(100)], True),
    "carve-out 82%": ([carveout(82)], True),
    # Diagnostics: what the time is made of.
    "constant x": ([CONST_X], False),
    "stores, not reductions": ([STORES], False),
    "constant x, stores": ([CONST_X, STORES], False),
}
# Plans of the committed source, (lane_group, windows, splits).
PLANS = {"G7": [(2, 1, 2), (2, 1, 4), (4, 1, 8), (8, 2, 4)],
         "G5": [(8, 1, 8), (8, 1, 16), (8, 1, 32), (4, 1, 16), (16, 1, 8),
                (16, 1, 32), (12, 1, 11), (14, 1, 13), (19, 1, 18),
                (19, 1, 36)]}
# The stand-in at this scale, whose stream (29 MB) stays in L2 between
# calls: the planned pass and CSR.
SMALL_SCALE = 0.1


variant_source = functools.partial(vb.variant_source, SOURCE)
PATTERN = r"spmv_kernelI(f|13__nv_bfloat16)E"


def build_variant(name: str):
    lib, report = vb.nvcc_build("spmv_" + name,
                                variant_source(VARIANTS[name][0]), PATTERN)
    ks._declare(lib)
    return lib, report


def run_plan(lib, idx, val, seg, x, geo, plan):
    """One stream pass of a variant's library on ``plan`` (no launch is
    counted)."""
    acc = (torch.zeros if plan.splits > 1 else torch.empty)(
        geo["num_rows_padded"], dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream().cuda_stream
    ks._raise_on(lib.serpens_spmv(
        *ks._spmv_args(idx, val, seg, x, plan, acc, geo["segment_width"]),
        stream), "serpens_spmv")
    return acc


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--matrix", choices=sorted(PLANS), default="G7",
                    help="the stand-in to time at full size (default G7)")
    ap.add_argument("--parent", help="an unpacked tree of an earlier commit "
                    "whose SpMV body to time beside this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("spmv_variants: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = cs.card_line()
    cs.say(card)
    jobs = {name: (build_variant, name) for name in VARIANTS}
    if args.parent:
        jobs["parent"] = (functools.partial(
            vb.tree_module, module="kernels.serpens_spmv",
            stem="serpens_spmv", pattern=PATTERN), args.parent)
    built = vb.build_all(jobs)
    for name, (_, report) in built.items():
        cs.say(f"[ptxas] {name}: " + "; ".join(report))
    libs = {name: lib for name, (lib, _) in built.items()}

    t = time.perf_counter()
    gid = args.matrix
    rows, cols, vals, shape, _ = cs.paper_matrix(gid, scale=1.0,
                                                 seed=cs.SEED)
    streams = {}
    for dtype in ("float32", "bfloat16"):
        plan = cs.cpart.make_plan(
            rows, cols, vals, shape,
            cs.sformat.SerpensConfig(value_dtype=dtype), cs.cpart.PlanSpec())
        streams[dtype] = cs.stream_on_card(plan, dev) + (plan,)
    idx, val, seg, geo, plan = streams["float32"]
    bidx, bval, bseg, bgeo, bplan = streams["bfloat16"]
    rp = geo["num_rows_padded"]
    sp = ks._card_spmv_plan(idx, rp)
    cs.say(f"[setup] {gid} {shape[0]} x {shape[1]}, R_pad {rp}, "
           f"{plan.stream_bytes / 1e6:.1f} MB stream, plan {sp}, in "
           f"{time.perf_counter() - t:.1f} s")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        csr = torch.sparse_coo_tensor(
            torch.from_numpy(np.stack([rows, cols])), torch.from_numpy(vals),
            shape).to(dev).coalesce().to_sparse_csr()
    x = cs.ops.pad_x(torch.from_numpy(np.random.default_rng(cs.SEED)
                                      .standard_normal(shape[1])
                                      .astype(np.float32)).to(dev),
                     plan.num_segments_local, plan.config.segment_width)
    lanes = idx.shape[2]
    on = {"": (idx, val, seg, geo), ", bf16 stream": (bidx, bval, bseg, bgeo)}
    fns = {f"planned{sfx}": functools.partial(ks.spmv, i_, v_, s_, x, **g_)
           for sfx, (i_, v_, s_, g_) in on.items()}
    checked = dict.fromkeys(fns, True)
    labels = dict.fromkeys(fns, str(sp))
    for name, (_, ok) in VARIANTS.items():
        fns[name] = functools.partial(run_plan, libs[name], idx, val, seg, x,
                                      geo, sp)
        checked[name], labels[name] = ok, "the plan"
    for lg, windows, splits in PLANS[gid]:
        p = ks.spmv_plan_of(lanes, rp, lg, windows, splits)
        for sfx, (i_, v_, s_, g_) in on.items():
            name = f"lg {lg}, {windows} window(s), {splits} split(s){sfx}"
            fns[name] = functools.partial(run_plan, libs["built"], i_, v_, s_,
                                          x, g_, p)
            checked[name], labels[name] = True, f"{p.blocks} blocks"
    if args.parent:
        for sfx, (i_, v_, s_, g_) in on.items():
            name = "parent" + sfx
            fns[name] = functools.partial(libs["parent"].spmv, i_, v_, s_, x,
                                          **g_)
            checked[name], labels[name] = True, "its own wrapper"
    for name, fn in fns.items():
        if not checked[name]:
            continue
        i_, v_, s_, g_ = on[", bf16 stream" if "bf16" in name else ""]
        want = ks.spmv_plain(i_, v_, s_, x, **g_)
        scale = ks.spmv_plain(i_, v_.abs(), s_, x.abs(), **g_)
        cs.check_close(f"{name} vs plain", fn(), want, scale)
        del want, scale
    xk = x[:shape[1]].contiguous()
    fns["torch.mv CSR"] = functools.partial(torch.mv, csr, xk)
    turns = cs.in_turns(fns, ITERS)
    lib_ms = turns["torch.mv CSR"]
    b = cs.bound_ms(plan, 1)[0]
    bb = cs.bound_ms(bplan, 1)[0]
    record = {"card": card}
    for name in fns:
        mean = record[name] = turns[name]
        reads = turns["reads"][name]
        tag = "" if checked.get(name, True) else " [diagnostic]"
        bd = bb if "bf16" in name else b
        cs.say(f"[spmv] {name}{tag} ({labels.get(name, 'library')}): "
               f"{mean:.4f} ms ({reads[0]:.4f} / {reads[1]:.4f}), "
               f"bound {bd:.4f} ms ({bd / mean:.3f}); {lib_ms / mean:.2f}x "
               f"the speed of CSR  [{card}]")
    if gid == "G7":
        record["G7 x0.1"] = small_scale(libs, card)
    cs.say(json.dumps(record))
    return 0


def small_scale(libs, card) -> dict:
    """The pass as built and with each carve-out, and CSR, on the stand-in
    at SMALL_SCALE, whose stream stays in L2 between calls: what the pass
    costs when DRAM sets nothing."""
    dev = torch.device("cuda")
    rows, cols, vals, shape, _ = cs.paper_matrix("G7", scale=SMALL_SCALE,
                                                 seed=cs.SEED)
    plan = cs.cpart.make_plan(rows, cols, vals, shape,
                              cs.sformat.SerpensConfig(), cs.cpart.PlanSpec())
    idx, val, seg, geo = cs.stream_on_card(plan, dev)
    sp = ks._card_spmv_plan(idx, geo["num_rows_padded"])
    x = cs.ops.pad_x(torch.from_numpy(np.random.default_rng(cs.SEED)
                                      .standard_normal(shape[1])
                                      .astype(np.float32)).to(dev),
                     plan.num_segments_local, plan.config.segment_width)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        csr = torch.sparse_coo_tensor(
            torch.from_numpy(np.stack([rows, cols])), torch.from_numpy(vals),
            shape).to(dev).coalesce().to_sparse_csr()
    fns = {name: functools.partial(run_plan, libs[name], idx, val, seg, x,
                                   geo, sp)
           for name in ("built", "carve-out 100%", "carve-out 82%")}
    fns["torch.mv CSR"] = functools.partial(torch.mv, csr,
                                            x[:shape[1]].contiguous())
    out = cs.in_turns(fns, ITERS)
    out.pop("reads")
    cs.say(f"[spmv] G7 x{SMALL_SCALE} ({plan.stream_bytes / 1e6:.1f} MB "
           f"stream, plan {sp}): " + ", ".join(
               f"{name} {t:.4f} ms" for name, t in out.items())
           + f"  [{card}]")
    return out


if __name__ == "__main__":
    sys.exit(main())
