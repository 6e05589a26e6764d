#!/usr/bin/env python3
"""Variants of the flash kernel's bf16 bodies, built and timed on one GPU.

Run from the repository root::

    python3 tools/flash_variants.py [--parent DIR] [--body mma]
                                    [--variants NAME ...]

Each variant is the committed ``csrc/flash_attention.cu`` with the edits
listed in ``VARIANTS``.  All are built at once, with the repository's nvcc
flags, into ``build/variants/``; each prints its ptxas report, is held
against the plain version at the bf16 shapes of ``chip_smoke.py`` phase 5
(``||Δ|| <= 5e-3·||plain||``), and is then timed with CUDA events beside
``scaled_dot_product_attention``, every entry twice in turns (one order,
then the reverse), at the served shape, at ``prefill_32k``, at two
dh = 128 shapes and at minicpm3's MLA heads (dh 96, dv 64).  With
``--parent DIR`` (an earlier commit unpacked by ``git archive``), that
tree's own wrapper, on its own source built here, is checked and timed
in the same turns (entry ``parent``).  With ``--body mma`` every bf16 call
goes to the mma body (the shape rule is replaced for the run, so aligned
tensors take its 16-byte loads, as a served call does), and the served
paligemma shape (heads of 256, where the body has one form) is timed
too.  ``--variants`` picks the entries to build.  The last line is one
JSON object of the mean times.  It needs a CUDA card and ``nvcc``, and imports
nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402
import variant_build as vb  # noqa: E402

fa = cs.fa
build = fa._build
SOURCE = build.CSRC / "flash_attention.cu"

STAGES = "  static constexpr int STAGES = 3;"
EX2 = 'asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));'
# Ping-pong: the two consumers take turns to issue each product (named
# barriers 3 and 4; consumer 0 first).
TURN = 'asm volatile("bar.sync %0, 256;\\n" ::"r"(3 + cw) : "memory");\n'
PASS = 'asm volatile("bar.arrive %0, 256;\\n" ::"r"(4 - cw) : "memory");\n'
QK = ("    wgmma_fence();\n    qk_issue<DH, C::BK>(sc, sQw, stage(t));\n"
      "    wgmma_commit();\n")
PV = ("    wgmma_fence();\n"
      "    pv_issue<DV, C::BK>(o, pa, stage(t) + C::K_BYTES);\n"
      "    wgmma_commit();\n")
FIRST = "  mbar_wait(q_bar, 0);\n  for (int t = 0; t < n_tiles; ++t) {\n"
# The mma body's Q fragments: read from shared memory each step (built),
# or held in registers across the key loop.
LAST_ROW = "  const int warp_last_row = q0 + warp * 16 + 15;\n"
QREAD = ("      const bf16* qp = Qs + (warp * 16 + gr) * QS + kk * 16 + 2 * tq;\n"
         "      const uint32_t a[4] = {ld32(qp), ld32(qp + 8 * QS), "
         "ld32(qp + 8),\n                             ld32(qp + 8 * QS + 8)};\n")
QHOLD = ("  uint32_t qf[KD][4];\n#pragma unroll\n"
         "  for (int kk = 0; kk < KD; ++kk) {\n"
         "    const bf16* qp = Qs + (warp * 16 + gr) * QS + kk * 16 + 2 * tq;\n"
         "    qf[kk][0] = ld32(qp);\n    qf[kk][1] = ld32(qp + 8 * QS);\n"
         "    qf[kk][2] = ld32(qp + 8);\n    qf[kk][3] = ld32(qp + 8 * QS + 8);\n"
         "  }\n")

# name -> [(text in the committed source, its replacement)]
VARIANTS = {
    "built": [],
    "exp2f": [(EX2, "y = exp2f(x);")],
    "2 stages": [(STAGES, "  static constexpr int STAGES = 2;")],
    "4 stages at dh 64": [(STAGES, "  static constexpr int STAGES = "
                                   "DH == 64 ? 4 : 3;")],
    "4 stages at (96, 64)": [(STAGES, "  static constexpr int STAGES = "
                                      "DH == 96 ? 4 : 3;")],
    "Q held": [(LAST_ROW, LAST_ROW + QHOLD),
               (QREAD, "      const uint32_t* a = qf[kk];\n")],
    "ping-pong": [(FIRST, '  if (cw == 1) asm volatile("bar.arrive 3, 256;'
                          '\\n" ::: "memory");\n' + FIRST),
                  (QK, "    " + TURN + QK + "    " + PASS),
                  (PV, "    " + TURN + PV + "    " + PASS)],
}
# (name, b, s, kv heads, g, dh, dv) of the timings; causal.
SHAPES = (("smoke", 4, 2000, 16, 1, 64, 64),
          ("prefill_32k", 1, 32768, 16, 1, 64, 64),
          ("chatglm3 S 4096", 1, 4096, 2, 16, 128, 128),
          ("dh 128 S 16384", 1, 16384, 8, 1, 128, 128),
          ("minicpm3 MLA", 4, 2000, 40, 1, 96, 64))
# Timed with --body mma only: paligemma's served prefill (heads of 256).
MMA_SHAPES = (("paligemma", 8, 320, 1, 8, 256, 256),)


variant_source = functools.partial(vb.variant_source, SOURCE)


def build_variant(name: str):
    """nvcc of one variant; returns (library, ptxas summary of each wgmma
    and mma build)."""
    lib, report = vb.nvcc_build(
        name, variant_source(VARIANTS[name]),
        r"flash_fwd_(wgmma|mma)_kernelILi(\d+)E(?:Li(\d+)E)?",
        lambda hit: f"{hit[1]} " + (f"(dh, dv) = ({hit[2]}, {hit[3]})"
                                    if hit[3] else f"at {hit[2]} columns"))
    fa._declare(lib)
    return lib, report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--parent", help="an unpacked tree of an earlier commit "
                    "whose own flash wrapper is timed beside the variants")
    ap.add_argument("--body", choices=("wgmma", "mma"), default="wgmma",
                    help="the body every bf16 call runs")
    ap.add_argument("--variants", nargs="+", choices=sorted(VARIANTS),
                    default=sorted(VARIANTS), help="the entries to build")
    args = ap.parse_args(argv)
    if args.parent and args.body != "wgmma":
        ap.error("--parent runs its own tree's shape rule: wgmma only")
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = cs.card_line()
    print(card, flush=True)
    names = [n for n in VARIANTS if n in args.variants]
    jobs = {name: (build_variant, name) for name in names}
    if args.parent:
        jobs["parent"] = (functools.partial(
            vb.tree_module, module="kernels.flash_attention",
            stem="flash_attention",
            pattern=r"flash_fwd_(?:wgmma|mma)_kernelI(?:Li\d+E)+"),
            args.parent)
    built = vb.build_all(jobs)
    # Each entry's wrapper module and library: the variants run this
    # tree's wrapper, the parent its own.
    wrappers = {name: fa for name in names}
    libs = {name: lib for name, (lib, _) in built.items()}
    if args.parent:
        wrappers["parent"] = built["parent"][0]
        libs["parent"] = wrappers["parent"]._library()
    for name, (_, report) in built.items():
        print(f"[variants] {name}: " + "; ".join(sorted(report)), flush=True)

    def use(name):
        build._libs["flash_attention"] = libs[name]

    shapes = SHAPES
    if args.body == "mma":
        fa.flash_body = lambda q, k, v: ("fma" if q.dtype == torch.float32
                                         else "mma")
        shapes += MMA_SHAPES

    for case in cs.FLASH_CASES:
        _, b, s, kvh, g, dh, dv, causal, dt = case
        if dt != torch.bfloat16:
            continue
        q, k, v = cs.attention_inputs(b, s, kvh, g, dh, dv, dt, dev, s)
        want = fa.flash_attention_plain(q, k, v, causal=causal)
        for name in libs:
            use(name)
            if name == "parent":        # the earlier tree's rule picks
                got = wrappers[name].flash_attention(q, k, v, causal=causal)
                torch.cuda.synchronize()
            else:
                got, body = cs.launch_body(q, k, v, causal)
                if body != args.body:
                    raise AssertionError(f"{name} at {case[0]}: {body}")
            r = cs.rel_err(got, want)
            if not r <= cs.FLASH_BF16_REL:
                raise AssertionError(f"{name} at {case[0]}: {r}")
        print(f"[variants] {case[0]}: every entry within "
              f"{cs.FLASH_BF16_REL} of plain in norm", flush=True)

    times = {}
    for key, b, s, kvh, g, dh, dv in shapes:
        q, k, v = cs.attention_inputs(b, s, kvh, g, dh, dv, torch.bfloat16,
                                      dev, 5)
        runs = {name: functools.partial(wrappers[name].flash_attention, q, k,
                                        v)
                for name in libs}
        runs["sdpa"] = functools.partial(
            torch.nn.functional.scaled_dot_product_attention,
            q.view(b, s, kvh * g, dh).transpose(1, 2), k.transpose(1, 2),
            v.transpose(1, 2), is_causal=True, enable_gqa=g > 1)
        for name in libs:
            runs[name] = functools.partial(
                lambda name, run: (use(name), run()), name, runs[name])
        parent = wrappers.get("parent")
        before = dict(parent.flash_launches_by_body) if parent else {}
        times[key] = cs.in_turns(runs, 10)
        times[key].pop("reads")
        # The body the parent ran, from its own wrapper's counters.
        ran = ""
        if parent:
            now = parent.flash_launches_by_body
            ran = f"; parent ran {[n for n in before if now[n] != before[n]]}"
        bound = cs.flash_bound(b, s, kvh, g, dh, dv, True)[0]
        print(f"[variants] {key} (B={b}, S={s}, KV={kvh}, G={g}, dh={dh}, "
              f"dv={dv}, causal; bound {bound:.4f} ms): " + ", ".join(
                  f"{n} {t:.4f} ms" for n, t in times[key].items())
              + ran + f"  [{card}]", flush=True)
        del q, k, v, runs
    build._libs.pop("flash_attention", None)
    print(json.dumps({"card": card, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
